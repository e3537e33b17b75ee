#!/usr/bin/env python3
"""Serving benchmarks of the PyTorch/CUDA port's FingerService.

    python3 tools/streams_bench_torch.py --json out.json [--quick]
        [--device cuda|cpu] [--seed S] [--fleet]

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

With ``--fleet`` it runs the fleet's benches instead, at `chip_smoke.py`
phase 8's pools (``--quick``: a few streams a shard), into the same
JSON: **fleet** (the port's twin of the reference bench's
``bench_fleet``: admission per pool, a promotion cold and after
`FingerFleet.warm`, a shard's recovery) and **fleet_hotpath** for
``fused_tick`` (the large pool) and ``sparse_tick`` (the virtual pool):
stacked against shard-by-shard ticks (host ingest, poll, scores,
stream-ticks/s, launches a tick) and the periodic save's pause.

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


# --fleet: the fleet at chip_smoke.py phase 8's pools (name, n_pad,
# shards, streams per shard, method); the sparse pool's slot capacities
FLEET_FULL = dict(
    pools=(("small", 256, 4, 2048, "fused_tick"),
           ("large", 1024, 2, 2048, "fused_tick"),
           ("virtual", 1 << 20, 2, 512, "sparse_tick")),
    n_slots=1024, m_pad=8192, k_pad=128, j_pad=8, fill=0.75, ticks=6)
FLEET_QUICK = dict(
    pools=(("small", 16, 2, 8, "fused_tick"),
           ("large", 64, 2, 8, "fused_tick"),
           ("virtual", 1 << 12, 2, 4, "sparse_tick")),
    n_slots=64, m_pad=256, k_pad=8, j_pad=2, fill=0.75, ticks=3)


class FleetLoad:
    """Synthetic tenants of one fleet config: a pool's tenants have
    between half its n_pad (the previous pool's, for a later pool) and
    its n_pad nodes, each joined to its neighbours at OFFSETS; sparse
    tenants the same graph with its ids spread over the virtual space
    (2048 active ids at most). Deltas add weight on k_pad random lanes
    among a tenant's nodes."""

    def __init__(self, shapes, seed):
        self.shapes = shapes
        self.rng = np.random.default_rng(seed)
        self.tenants = []  # (name, pool index, n, virtual ids or None)
        lo = 2
        for i, (_, n_pad, shards, b, method) in enumerate(shapes["pools"]):
            count = int(shards * b * shapes["fill"])
            hi = n_pad if method != "sparse_tick" else min(
                n_pad, 2 * shapes["n_slots"] // 3)
            lo_i = max(lo, hi // 2) if method != "sparse_tick" else hi // 2
            for t in range(count):
                n = int(self.rng.integers(lo_i, hi + 1))
                ids = None
                if method == "sparse_tick":
                    ids = np.sort(self.rng.choice(n_pad, n, replace=False))
                self.tenants.append((f"p{i}t{t}", i, n, ids))
            lo = n_pad + 1

    def graph(self, tenant):
        import torch

        from repro_torch.graphs.types import EdgeList

        name, pool, n, ids = tenant
        i = np.tile(np.arange(n), len(OFFSETS))
        j = np.concatenate([(np.arange(n) + d) % n for d in OFFSETS])
        w = self.rng.uniform(0.5, 1.5, i.size)
        if ids is None:
            return EdgeList.from_arrays(i, j, w, n_nodes=n)
        n_pad = self.shapes["pools"][pool][1]
        mask = np.zeros(n_pad, np.float32)
        mask[ids] = 1.0
        return EdgeList.from_arrays(ids[i], ids[j], w, n_nodes=n_pad,
                                    node_mask=torch.from_numpy(mask))

    def deltas(self, names=None):
        """One tick's tenant-space deltas for ``names`` (default all)."""
        import torch

        from repro_torch.graphs.types import GraphDelta

        k, out = self.shapes["k_pad"], {}
        for name, pool, n, ids in self.tenants:
            if names is not None and name not in names:
                continue
            lo = self.rng.integers(0, n - 1, k)
            hi = lo + self.rng.integers(1, n - lo)
            keys = np.unique(lo * n + hi)
            lo, hi = keys // n, keys % n
            n_nodes = n
            if ids is not None:
                lo, hi = ids[lo], ids[hi]
                n_nodes = self.shapes["pools"][pool][1]
            t = torch.from_numpy
            pad = k - lo.size
            out[name] = GraphDelta(
                senders=t(np.pad(lo, (0, pad)).astype(np.int32)),
                receivers=t(np.pad(hi, (0, pad)).astype(np.int32)),
                dw=t(np.pad(self.rng.uniform(0.1, 0.5, lo.size),
                            (0, pad)).astype(np.float32)),
                w_old=torch.zeros(k),
                mask=t((np.arange(k) < lo.size).astype(np.float32)),
                n_nodes=n_nodes,
                node_ids=torch.zeros(self.shapes["j_pad"],
                                     dtype=torch.int32),
                node_flag=torch.zeros(self.shapes["j_pad"]))
        return out


def fleet_config(shapes, pools=None, **kw):
    from repro_torch.fleet import FleetConfig, PoolSpec

    specs = []
    for name, n_pad, shards, b, method in shapes["pools"]:
        if pools is not None and name not in pools:
            continue
        extra = dict(n_slots=shapes["n_slots"], m_pad=shapes["m_pad"]) \
            if method == "sparse_tick" else {}
        specs.append(PoolSpec(name=name, n_pad=n_pad, shards=shards,
                              streams_per_shard=b, k_pad=shapes["k_pad"],
                              j_pad=shapes["j_pad"], method=method,
                              exact_smax=True, **extra))
    return FleetConfig(pools=tuple(specs), **kw)


def bench_fleet(torch, shapes, dev, clock, seed):
    """The fleet's event pauses (host clock, each ending in a
    synchronize): admission per pool, a cross-bucket promotion cold (the
    first in the process) and warm (after `FingerFleet.warm`), and a
    shard's recovery from its in-memory base and WAL; the port's twin
    of the reference bench's ``bench_fleet``."""
    from repro_torch.fleet import FingerFleet

    load = FleetLoad(shapes, seed)
    fleet = FingerFleet.open(fleet_config(shapes), device=dev)

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        clock.sync()
        return res, (time.perf_counter() - t0) * 1e3

    admission = {}
    for tenant in load.tenants:
        g = load.graph(tenant)
        entry, ms = timed(lambda: fleet.admit(tenant[0], g))
        admission.setdefault(fleet.config.pools[entry.pool].name,
                             []).append(ms)
    fleet.ingest(load.deltas())
    fleet.poll()
    small = [e.name for e in fleet.directory.tenants_on(0, 0)]
    _, cold = timed(lambda: fleet.promote(small[0]))
    fleet.ingest(load.deltas(set(fleet.directory.names())))
    fleet.poll()
    _, warm_ms = timed(fleet.warm)
    _, warm = timed(lambda: fleet.promote(small[1]))
    fleet.ingest(load.deltas(set(fleet.directory.names())))
    fleet.poll()
    victims = len(fleet.directory.tenants_on(0, 1))
    fleet.kill_shard(fleet.config.pools[0].name, 1)
    fleet.ingest(load.deltas(set(fleet.directory.names())))
    fleet.poll()
    reports, recovery = timed(fleet.recover)
    assert len(reports) == victims
    fleet.close()
    out = {"tenants": len(load.tenants),
           "admission_ms": {k: float(np.mean(v))
                            for k, v in admission.items()},
           "cold_promotion_ms": cold, "warm_ms": warm_ms,
           "warm_promotion_ms": warm, "recovery_ms": recovery,
           "recovered_tenants": len(reports)}
    print(f"fleet events: admission "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in
                      out["admission_ms"].items())
          + f" a tenant; promotion cold {cold:.2f} ms, warm {warm:.2f} ms "
          f"(the warm itself {warm_ms:.1f} ms); recovery of "
          f"{len(reports)} tenants {recovery:.1f} ms", flush=True)
    return out


def bench_fleet_hotpath(torch, shapes, dev, clock, seed, method):
    """One pool of ``method`` (phase 8's large or virtual pool) serving
    the same deltas stacked (one launch a tick) and shard by shard (one
    a shard): host ingest, poll (host, and CUDA events on the card),
    scores, the loop's stream-ticks/s, launches a tick; then the
    periodic save's pause (``save_every_ticks=2``). The port's twin of
    the reference bench's ``bench_fleet_hotpath``."""
    import shutil
    import tempfile

    from repro_torch.fleet import FingerFleet

    pool = next(p for p in shapes["pools"]
                if p[4] == method and p[1] == max(
                    q[1] for q in shapes["pools"] if q[4] == method))
    pool_i = shapes["pools"].index(pool)
    load = FleetLoad(shapes, seed)
    tenants = [t for t in load.tenants if t[1] == pool_i]
    load.tenants = [(n, 0, size, ids) for n, _, size, ids in tenants]
    one = dict(shapes, pools=(pool,))
    load.shapes = one
    graphs = {t[0]: load.graph(t) for t in load.tenants}
    ticks = [load.deltas() for _ in range(shapes["ticks"] + 1)]
    streams = pool[2] * pool[3]

    def drive(stacked: bool, **kw) -> dict:
        fleet = FingerFleet.open(fleet_config(one, stacked_ticks=stacked,
                                              **kw), device=dev)
        for name, g in graphs.items():
            fleet.admit(name, g)
        fleet.ingest(ticks[0])
        fleet.poll()
        fleet.scores()
        clock.sync()
        rows = []
        for d in ticks[1:]:
            t0 = time.perf_counter()
            fleet.ingest(d)
            t1 = time.perf_counter()
            a = clock.mark()
            fleet.poll()
            b = clock.mark()
            t2 = time.perf_counter()
            fleet.scores()
            t3 = time.perf_counter()
            clock.sync()
            rows.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, clock.ms(a, b),
                         (t3 - t2) * 1e3, fleet.last_poll_launches,
                         fleet.last_save_pause_s))
        fleet.close()
        med = np.median(np.array(rows), axis=0)
        wall = med[0] + med[1] + med[3]
        return {"ingest_ms": float(med[0]), "poll_host_ms": float(med[1]),
                "poll_ms": float(med[2]), "scores_ms": float(med[3]),
                "tick_ms": float(wall),
                "stream_ticks_per_s": streams / wall * 1e3,
                "launches_per_tick": int(rows[-1][4]),
                "save_pauses_s": [r[5] for r in rows if r[5] > 0]}

    seq, stk = drive(False), drive(True)
    tmp = tempfile.mkdtemp(prefix="fleet_bench_")
    try:
        saving = drive(True, directory=tmp, save_every_ticks=2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"method": method, "pool": pool[0], "shards": pool[2],
           "streams_per_shard": pool[3], "tenants": len(graphs),
           "sequential": seq, "stacked": stk,
           "stacked_tick_speedup": seq["tick_ms"] / stk["tick_ms"],
           "save_pause_ms": float(np.mean(saving["save_pauses_s"])) * 1e3}
    for key, r in (("shard by shard", seq), ("stacked", stk)):
        print(f"fleet hot path {method} ({pool[0]}: {pool[2]} × {pool[3]}, "
              f"{len(graphs)} tenants) {key}: ingest {r['ingest_ms']:.1f} "
              f"ms, poll {r['poll_host_ms']:.3f} ms host / {r['poll_ms']:.3f} "
              f"ms, scores {r['scores_ms']:.1f} ms, "
              f"{r['stream_ticks_per_s']:.4g} stream-ticks/s, "
              f"{r['launches_per_tick']} launches a tick", flush=True)
    print(f"fleet hot path {method}: stacked {out['stacked_tick_speedup']:.3f}"
          f"× shard by shard; periodic save pause {out['save_pause_ms']:.1f} "
          "ms", flush=True)
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
    ap.add_argument("--fleet", action="store_true",
                    help="the fleet benches (phase 8's pools) instead")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(args.device)
    shapes = QUICK if args.quick else FULL
    info = device_info(torch, dev)
    print(f"device: {info}", flush=True)
    clock = Clock(torch, dev)
    if args.fleet:
        fshapes = FLEET_QUICK if args.quick else FLEET_FULL
        report = {
            "device": info,
            "config": {k: v for k, v in fshapes.items()}
            | {"quick": args.quick, "seed": args.seed},
            "fleet": bench_fleet(torch, fshapes, dev, clock, args.seed),
            "fleet_hotpath": [
                bench_fleet_hotpath(torch, fshapes, dev, clock, args.seed,
                                    method)
                for method in ("fused_tick", "sparse_tick")]}
        text = json.dumps(report, indent=1)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(text)
        print(json.dumps({"stacked_tick_speedup": [
            r["stacked_tick_speedup"] for r in report["fleet_hotpath"]],
            "device": info["kind"]}))
        return 0
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
