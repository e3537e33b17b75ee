#!/usr/bin/env python3
"""Serving benchmarks of the PyTorch/CUDA port's FingerService.

    python3 tools/streams_bench_torch.py --json out.json [--quick]
        [--device cuda|cpu] [--seed S]

The port's twin of `benchmarks/streams_bench.py` (which it imports
nothing from). Three parts, written as one JSON object to ``--json``:

- **sweep**: ``method="fused_tick"`` ticks at B x n_pad points; each
  point's median poll latency (CUDA events around `poll`) and
  stream-ticks/s, ingesting pre-built host deltas double-buffered.
  Every loop here first runs ``max_queue + 1`` ticks untimed, which
  allocate the double-buffered ring's pinned slots.
- **ingest overlap**: the same pre-built host deltas through the same
  ingest → poll loop under ``ingestion="sync"`` and
  ``"double_buffered"``, no synchronisation inside the loop: the median
  host time of `ingest`, the median `poll` latency (CUDA events), the
  loop's wall time and stream-ticks/s, and ``overlap_fraction`` = 1 −
  loop(double_buffered) / loop(sync). Double buffering moves the copy
  out of `poll` into `ingest`, so the loop is the yardstick.
- **migration pause**: host-clock milliseconds, each ending in a
  synchronize, of the device `repad` growth (n_pad → 2 n_pad), of a
  `compact()` reclaiming the grown tail, and of the plan swap — the
  growth plus the first tick after it — cold and after
  `warm_next_layouts`; the best and the median of 3 fresh services
  each (2 with ``--quick``).

Default shapes are `chip_smoke.py` phase 3's (B = 32768, n_pad = 1024,
k_pad = 128, j_pad = 8, ``exact_smax=True``); ``--quick`` cuts them so
that the run fits on the CPU. The stacked state is built directly from
a synthetic circulant edge set a stream (each of the first 3/4·n_pad
nodes joined to 4 neighbours at fixed offsets) instead of through
`FingerService.open`, whose per-graph host loop would dominate the run;
the deltas add weight to random lanes. The run names its device; with
``--device cpu`` every time is a host-clock CPU time, not a device
metric, and the JSON says ``"platform": "cpu"``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FULL = dict(batch=32768, n_pad=1024, k_pad=128, j_pad=8, ticks=13,
            sweep=((4096, 256), (4096, 1024), (32768, 256), (32768, 1024)),
            repeats=3)
QUICK = dict(batch=64, n_pad=64, k_pad=16, j_pad=2, ticks=6,
             sweep=((16, 32), (64, 64)), repeats=2)
OFFSETS = (1, 2, 5, 11)


def synthetic_service(torch, b, n_pad, k_pad, j_pad, ingestion, dev, seed):
    """A fused_tick FingerService over B synthetic streams: stream s has
    its first 3/4·n_pad nodes live, each joined to its neighbours at
    OFFSETS (mod the live count) with weights in [0.5, 1.5)."""
    from repro_torch.core.state import FingerState
    from repro_torch.graphs.layout import NodeLayout
    from repro_torch.serving import (FingerService, ServiceConfig, TopKSpec,
                                     build_plan)

    n_live = max(8, 3 * n_pad // 4)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    i = torch.arange(n_live).repeat(len(OFFSETS))
    j = torch.cat([(torch.arange(n_live) + d) % n_live for d in OFFSETS])
    w = 0.5 + torch.rand((b, i.numel()), generator=gen)
    s = torch.zeros((b, n_pad))
    s.index_add_(1, i, w)
    s.index_add_(1, j, w)
    s_total = s.sum(-1)
    q = 1.0 - ((s * s).sum(-1) + 2.0 * (w * w).sum(-1)) / s_total ** 2
    mask = torch.zeros((b, n_pad))
    mask[:, :n_live] = 1.0
    layout = NodeLayout(n_pad)
    states = FingerState(q=q, s_total=s_total, s_max=s.amax(-1),
                         strengths=s, node_mask=mask, layout=layout)
    cfg = ServiceConfig(batch_size=b, n_pad=n_pad, k_pad=k_pad, j_pad=j_pad,
                        method="fused_tick", exact_smax=True,
                        ingestion=ingestion, topk=TopKSpec(k=4))
    return FingerService(cfg, build_plan(cfg, dev), states.to(dev))


def host_deltas(torch, b, n_pad, k_pad, j_pad, ticks, seed):
    """``ticks`` stacked host deltas adding weight to random lanes among
    the live nodes (no node slot set)."""
    from repro_torch.graphs.types import GraphDelta

    n_live = max(8, 3 * n_pad // 4)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(ticks):
        lo = rng.integers(0, n_live - 1, (b, k_pad)).astype(np.int32)
        hi = (lo + rng.integers(1, n_live - lo)).astype(np.int32)
        t = torch.from_numpy
        out.append(GraphDelta(
            senders=t(lo), receivers=t(hi),
            dw=t(rng.uniform(0.1, 0.5, (b, k_pad)).astype(np.float32)),
            w_old=torch.zeros((b, k_pad)),
            mask=t((rng.random((b, k_pad)) < 0.75).astype(np.float32)),
            n_nodes=n_pad, node_ids=torch.zeros((b, j_pad), dtype=torch.int32),
            node_flag=torch.zeros((b, j_pad))))
    return out


class Clock:
    """CUDA events on the card, the host clock on the CPU."""

    def __init__(self, torch, dev):
        self.torch, self.cuda = torch, dev.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()


def run_loop(torch, svc, deltas, clock):
    """Ingest → poll over ``deltas``, no sync inside the loop, after
    ``max_queue + 1`` warm-up ticks (which allocate the double-buffered
    ring's pinned slots). Returns host ingest ms, poll latency ms, loop
    s and the number of ticks timed."""
    warm = svc.config.max_queue + 1
    for d in deltas[:warm]:
        svc.ingest(d)
        svc.poll()
    clock.sync()
    ingest_ms, marks = [], []
    t0 = time.perf_counter()
    for d in deltas[warm:]:
        h = time.perf_counter()
        svc.ingest(d)
        ingest_ms.append((time.perf_counter() - h) * 1e3)
        a = clock.mark()
        svc.poll()
        marks.append((a, clock.mark()))
    clock.sync()
    loop_s = time.perf_counter() - t0
    poll_ms = [clock.ms(a, b) for a, b in marks]
    return ingest_ms, poll_ms, loop_s, len(marks)


def bench_sweep(torch, shapes, dev, clock, seed):
    rows = []
    for b, n_pad in shapes["sweep"]:
        svc = synthetic_service(torch, b, n_pad, shapes["k_pad"],
                                shapes["j_pad"], "double_buffered", dev,
                                seed)
        ds = host_deltas(torch, b, n_pad, shapes["k_pad"], shapes["j_pad"],
                         shapes["ticks"], seed + 1)
        _, poll_ms, loop_s, ticks = run_loop(torch, svc, ds, clock)
        svc.close()
        med = float(np.median(poll_ms))
        rows.append({"batch": b, "n_pad": n_pad, "k_pad": shapes["k_pad"],
                     "j_pad": shapes["j_pad"], "tick_ms": med,
                     "stream_ticks_per_s": b / med * 1e3,
                     "loop_stream_ticks_per_s": b * ticks / loop_s})
        print(f"sweep B={b} n_pad={n_pad}: median poll {med:.3f} ms, "
              f"{rows[-1]['stream_ticks_per_s']:.4g} stream-ticks/s "
              f"({rows[-1]['loop_stream_ticks_per_s']:.4g} over the loop)",
              flush=True)
        del svc, ds
    return rows


def bench_overlap(torch, shapes, dev, clock, seed):
    b, n_pad = shapes["batch"], shapes["n_pad"]
    ds = host_deltas(torch, b, n_pad, shapes["k_pad"], shapes["j_pad"],
                     shapes["ticks"], seed + 2)
    out = {"bytes_per_tick": int(sum(t.numel() * t.element_size()
                                     for t in ds[0].tensors().values()))}
    scores = {}
    for mode in ("sync", "double_buffered"):
        svc = synthetic_service(torch, b, n_pad, shapes["k_pad"],
                                shapes["j_pad"], mode, dev, seed)
        ingest_ms, poll_ms, loop_s, ticks = run_loop(torch, svc, ds, clock)
        scores[mode] = svc.scores()
        svc.close()
        out[mode] = {"ingest_ms": float(np.median(ingest_ms)),
                     "poll_ms": float(np.median(poll_ms)),
                     "loop_s": loop_s, "ticks": ticks,
                     "stream_ticks_per_s": b * ticks / loop_s}
        print(f"ingest overlap {mode}: median ingest "
              f"{out[mode]['ingest_ms']:.3f} ms (host), median poll "
              f"{out[mode]['poll_ms']:.3f} ms, loop {loop_s:.4f} s, "
              f"{out[mode]['stream_ticks_per_s']:.4g} stream-ticks/s",
              flush=True)
    if not np.array_equal(scores["sync"], scores["double_buffered"]):
        raise AssertionError("sync and double_buffered scores differ")
    out["overlap_fraction"] = max(
        0.0, 1.0 - out["double_buffered"]["loop_s"] / out["sync"]["loop_s"])
    print(f"overlap fraction {out['overlap_fraction']:.4f}; "
          f"{out['bytes_per_tick'] / 1e6:.1f} MB a tick; scores bit-equal",
          flush=True)
    return out


def bench_migration(torch, shapes, dev, clock, seed):
    """Host-clock pauses, each ending in a synchronize."""
    b, n_pad = shapes["batch"], shapes["n_pad"]
    k_pad, j_pad = shapes["k_pad"], shapes["j_pad"]
    grow_to = 2 * n_pad
    post = host_deltas(torch, b, grow_to, k_pad, j_pad, 1, seed + 3)[0]
    warm_d = host_deltas(torch, b, n_pad, k_pad, j_pad, 1, seed + 4)[0]
    times = {"grow_ms": [], "compact_ms": [], "swap_cold_ms": [],
             "swap_warm_ms": [], "warm_ms": []}

    def fresh():
        svc = synthetic_service(torch, b, n_pad, k_pad, j_pad,
                                "double_buffered", dev, seed)
        svc.ingest(warm_d)
        svc.poll()
        clock.sync()
        return svc

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        clock.sync()
        return (time.perf_counter() - t0) * 1e3

    reclaimed = 0
    for _ in range(shapes["repeats"]):
        svc = fresh()
        times["grow_ms"].append(timed(lambda: svc.repad(grow_to)))
        report = []
        times["compact_ms"].append(timed(
            lambda: report.append(svc.compact())))
        reclaimed = report[0].reclaimed
        svc.close()
        for warm in (False, True):
            svc = fresh()
            if warm:
                times["warm_ms"].append(timed(
                    lambda: svc.warm_next_layouts([grow_to])))

            def swap():
                svc.repad(grow_to)
                svc.ingest(post)
                svc.poll()

            times["swap_warm_ms" if warm else "swap_cold_ms"].append(
                timed(swap))
            svc.close()
    out = {"batch": b, "n_pad": n_pad, "grow_to": grow_to,
           "compact_reclaimed": int(reclaimed)}
    for key, vals in times.items():
        out[key] = float(min(vals))
        out[key.replace("_ms", "_median_ms")] = float(np.median(vals))
    print("migration pause (host clock, best of "
          f"{shapes['repeats']}): grow {out['grow_ms']:.3f} ms, compact "
          f"{out['compact_ms']:.3f} ms (reclaimed {reclaimed}), swap cold "
          f"{out['swap_cold_ms']:.3f} ms, warm {out['swap_warm_ms']:.3f} ms "
          f"(the warm itself {out['warm_ms']:.3f} ms)", flush=True)
    return out


def device_info(torch, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[0]
            if smi.stdout.strip() else smi.stderr.strip()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None, help="where to write the JSON")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes that run on the CPU")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(args.device)
    shapes = QUICK if args.quick else FULL
    info = device_info(torch, dev)
    print(f"device: {info}", flush=True)
    clock = Clock(torch, dev)
    report = {
        "device": info,
        "config": {k: v for k, v in shapes.items() if k != "sweep"}
        | {"method": "fused_tick", "exact_smax": True, "quick": args.quick,
           "seed": args.seed},
        "sweep": bench_sweep(torch, shapes, dev, clock, args.seed),
        "ingest_overlap": bench_overlap(torch, shapes, dev, clock,
                                        args.seed),
        "migration_pause": bench_migration(torch, shapes, dev, clock,
                                           args.seed),
    }
    text = json.dumps(report, indent=1)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(text)
    print(json.dumps({"overlap_fraction":
                      report["ingest_overlap"]["overlap_fraction"],
                      "device": info["kind"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
