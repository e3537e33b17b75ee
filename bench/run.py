"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up makes the cell's graphs, state and deltas from the seed on the
card, warms the cell's shapes, measures for ``--seconds``, and then
compares what the timed path produced with the plain reference. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each compared number beside its
limit); the checks are also the last lines of standard error.

It exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), and when JAX, Flax, the JAX package
``repro`` or its ``benchmarks`` were loaded by the time the window
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the script's own folder would shadow top-level modules by its files'
# names: the repository root and its src/ take its place
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from bench import harness, spec

    harness.environment()
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} card(s), "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    foreign = harness.foreign_modules(list(sys.modules))
    if foreign:
        print("loaded in the benchmark's process: " + ", ".join(foreign),
              file=sys.stderr)
        return 3
    if "error" in out:
        print(f"the timed path raised: {out['error']}", file=sys.stderr)
    if "reference_s" in out:
        print(f"reference_s {out['reference_s']!r}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(harness.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
