"""The readings that the limits of `correct` are set from.

    python3 bench/readings.py --workload <cell> --seeds 12 --control 3 \
        [--exact-smax-off 3] [--first-seed N]

For each of ``--seeds`` seeds it sets the cell up, runs the timed loop
for the benchmark's ``run_seconds``, and prints one
JSON line of the comparison's numbers for the program. For the first
``--control`` seeds it also prints the control's numbers: the reference
computed in bfloat16, put in the program's place for the same streams,
ticks and final state. ``--exact-smax-off`` runs the program itself
with its s_max update of eq. (3) on the first seeds, against the exact
s_max the configuration states. All in one process, one seed after
another, each one's state freed before the next. Runs on the card only;
the benchmark's own runs do not run it.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import torch

    from bench import harness, spec

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--exact-smax-off", type=int, default=0)
    p.add_argument("--first-seed", type=int, default=(1 << 31) + 101)
    args = p.parse_args(argv)

    harness.environment()
    benchmark = spec.load_json(spec.ROOT / "BENCHMARK.json")
    cell = spec.load_cell(args.workload, benchmark)
    seconds = benchmark["run_seconds"]
    if not torch.cuda.is_available():
        print("no CUDA device: the readings run on the card",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)

    def emit(seed, kind, numbers, t):
        print(json.dumps({"seed": seed, "kind": kind, "seconds": t,
                          **numbers}), flush=True)

    def measure(seed, exact_smax=None):
        inputs, svc, loop = harness.serve(cell, seed, device, exact_smax)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            loop.step()
        loop.align(int(cell.mix["cycle_ticks"]))
        outputs = harness.Outputs.collect(svc, loop)
        svc.close()
        del svc, loop
        torch.cuda.empty_cache()
        return inputs, outputs

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        inputs, outputs = measure(seed)
        numbers, refs = harness.program_numbers(
            cell.config, seed, inputs.host, outputs, device)
        emit(seed, "program", numbers, time.perf_counter() - t)
        if i < args.control:
            t = time.perf_counter()
            ctrl = harness.control_numbers(cell.config, seed, inputs.host,
                                           outputs, refs, device)
            emit(seed, "control_bf16", ctrl, time.perf_counter() - t)
        del inputs, outputs, refs
        if i < args.exact_smax_off:
            t = time.perf_counter()
            inputs, outputs = measure(seed, exact_smax=False)
            numbers, _ = harness.program_numbers(
                cell.config, seed, inputs.host, outputs, device)
            emit(seed, "exact_smax_off", numbers, time.perf_counter() - t)
            del inputs, outputs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
