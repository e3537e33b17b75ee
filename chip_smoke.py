#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FINGER on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--batch B]

Run from the root of a checkout; it imports `repro_torch` from
``src/`` and never JAX or the JAX package. Four phases, each printing a
line of its own; any failure exits non-zero:

1. build   — the hand-written kernels from ``src/repro_torch/csrc/``,
             one ``nvcc`` per source, started together.
2. kernels — each kernel against its plain PyTorch version on the card:
             ``stream_tick`` at the serving size and at a ragged size
             (n_pad not a multiple of 128, odd k, 3 join slots) over
             the edge-case batch of `kernels/stream_tick/parity.py`,
             both ``exact_smax`` values, out of place and in place;
             ``stream_tick_fused_stacked``
             at S = 3; ``delta_stats`` at several k and all-masked.
3. serve   — the main path: `FingerService.open(ServiceConfig(
             method="fused_tick", placement="local", ingestion="sync",
             exact_smax=True, batch_size=32768, n_pad=1024, k_pad=128,
             j_pad=8), graphs)` over `EdgeList` graphs from ``--seed``
             (per-stream n in 256–1024, about 4n edges), then 20
             ingest → poll ticks of stacked deltas mixing re-weights,
             deletions, additions, joins and leaves, with a (B, m) host
             mirror of edge weights that keeps every w_old exact and a
             burst planted in 4 streams on the last tick. Checks: the
             planted streams are the top 4; 64 sampled scores match the
             batch `jsdist_tilde` of the mirrored G and G' within 5e-3
             (the bound `tests/test_jsdist.py` holds Algorithm 2 to);
             ``stream_tick`` launched once per tick. One more tick,
             after the checks and outside the launch count, runs under
             ``torch.profiler`` for the device's busy and idle share.
4. single  — `jsdist_stream(method="fused_tick")` on one stream for 20
             deltas against the plain method; ``delta_stats`` launched.

Launch counts are set to 0 just before phase 3 and phase 4 and read just
after each. Kernel times are CUDA-event means of the launch the main
path makes (``stream_tick`` in place, on a copy of a main-path tick's
state restored before every call), at its shapes and inputs; bounds come
from the bytes that launch must move at the H100's 3.35 TB/s (the
arithmetic bound is far below), counting only the state elements this
run's delta changes as written. The ``stream_tick`` fixed cost is also
timed with every edge lane masked and with the first 32 lanes only. The
line before the last is the ``kernels`` JSON object; the last line is
the device JSON object. Scores and state are compared at the tolerances stated in
the parity modules (atol 1e-5, rtol 1e-5; the score as a divergence).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
N_PAD, K_PAD, J_PAD = 1024, 128, 8
TICKS = 20
PRIME_STRIDE = 8209  # a prime above every candidate count 8·n_e ≤ 8160


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls.

    With ``setup``, it runs untimed before every call, and each call is
    timed between its own pair of events.
    """
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if setup is None:
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    total = 0.0
    for rep in range(reps + 1):
        setup()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) if rep else 0.0  # first: warm-up
    return total / reps


class Fleet:
    """B host mirrors of edge-weight graphs and their tick deltas.

    Stream b has node ids [0, n_u): the first n_u − 8 start active, ids
    [n_u − 8, n_u − 4) join later (with edges), and ids [n_u − 4, n_u)
    join and leave isolated. Its candidate edges are the pairs
    (i, (i + d) mod n_e), i < n_e = n_u − 4, for 8 distinct offsets
    d < n_e/2 — all distinct, so slot c = d_index·n_e + i names one edge,
    and ``w[b, c]`` mirrors its weight exactly.
    """

    def __init__(self, b: int, seed: int, n_lo: int = 256,
                 n_hi: int = N_PAD):
        import numpy as np

        self.np = np
        self.rng = np.random.default_rng(seed)
        rng = self.rng
        self.b = b
        self.n_u = rng.integers(n_lo, n_hi + 1, b)
        self.n_e = self.n_u - 4
        half = self.n_e // 2 - 1
        bucket = half // 8
        self.offsets = (1 + np.arange(8)[None, :] * bucket[:, None]
                        + rng.integers(0, 1 << 30, (b, 8))
                        % bucket[:, None])
        self.c_count = 8 * self.n_e
        c_max = 8 * n_hi
        self.w = np.zeros((b, c_max), np.float32)
        for s in range(0, b, 4096):
            rows = slice(s, min(s + 4096, b))
            c = np.broadcast_to(np.arange(c_max), (rows.stop - s, c_max))
            lo, hi = self.endpoints(c % self.c_count[rows, None], rows)
            live = (c < self.c_count[rows, None]) \
                & (hi < (self.n_u[rows] - 8)[:, None]) \
                & (rng.random(c.shape) < 0.5)
            self.w[rows] = np.where(live, rng.uniform(0.5, 1.5, c.shape),
                                    0.0)
        self.active = np.arange(N_PAD)[None, :] < (self.n_u - 8)[:, None]
        self.a_joined = np.zeros(b, np.int64)

    def endpoints(self, c, rows=slice(None)):
        """Candidate slots (rows of streams) → (lo, hi) node ids."""
        np = self.np
        n_e = self.n_e[rows, None]
        i = c % n_e
        d = np.take_along_axis(self.offsets[rows], c // n_e, axis=1)
        j = (i + d) % n_e
        return np.minimum(i, j), np.maximum(i, j)

    def graphs(self):
        """The initial graphs as `EdgeList`s over each stream's n_u."""
        from repro_torch.graphs.types import EdgeList

        np = self.np
        out = []
        for b in range(self.b):
            nz = np.flatnonzero(self.w[b])
            lo, hi = self.endpoints(nz[None, :], slice(b, b + 1))
            n = int(self.n_u[b])
            out.append(EdgeList.from_arrays(
                lo[0], hi[0], self.w[b, nz], n_nodes=n,
                node_mask=self.active[b, :n].astype(np.float32)))
        return out

    def graph_at(self, b: int, w_row, active_row, device):
        """One stream's graph from a mirror row, in the n_pad layout."""
        from repro_torch.graphs.types import EdgeList

        np = self.np
        nz = np.flatnonzero(w_row)
        lo, hi = self.endpoints(nz[None, :], slice(b, b + 1))
        g = EdgeList.from_arrays(lo[0], hi[0], w_row[nz], n_nodes=N_PAD,
                                 node_mask=active_row.astype(np.float32))
        return g.to(device)

    def hub_shift(self, r: int):
        """The planted burst of stream r: the edges of its two strongest
        nodes are deleted and its weakest live node gets 1.5× the old
        maximum strength — the strongest node moves, which moves H̃'s
        s_max term the most. Returns (slots, dw, lane mask)."""
        np = self.np
        n_e = int(self.n_e[r])
        c_all = np.arange(8 * n_e)
        lo, hi = self.endpoints(c_all[None, :], slice(r, r + 1))
        lo, hi, w = lo[0], hi[0], self.w[r, :8 * n_e]
        s = np.zeros(N_PAD)
        np.add.at(s, lo, w)
        np.add.at(s, hi, w)
        act = self.active[r]
        tops = np.argsort(-s)[:2]
        live = np.flatnonzero(act[:n_e])
        weak = int(live[np.argmin(s[live])])
        hit = np.isin(lo, tops) | np.isin(hi, tops)
        gone = np.flatnonzero(hit & (w > 0))
        grow = np.flatnonzero(((lo == weak) | (hi == weak)) & ~hit
                              & act[lo] & act[hi])
        slots = np.zeros(K_PAD, np.int64)
        dw = np.zeros(K_PAD, np.float32)
        k = len(gone) + len(grow)
        slots[:k] = np.r_[gone, grow]
        dw[:k] = np.r_[-w[gone], 1.5 * s[tops[0]] / len(grow) - w[grow]]
        return slots, dw, np.arange(K_PAD) < k

    def tick(self, burst_rows=()):
        """One tick's stacked (B, K_PAD) delta; the mirror follows it."""
        import torch

        from repro_torch.graphs.types import GraphDelta

        np, rng, b = self.np, self.rng, self.b
        ar = np.arange(b)
        nid = np.zeros((b, J_PAD), np.int32)
        nflag = np.zeros((b, J_PAD), np.float32)
        join_a = (rng.random(b) < 0.1) & (self.a_joined < 4)
        va = self.n_u - 8 + self.a_joined
        nid[join_a, 0] = va[join_a]
        nflag[join_a, 0] = 1.0
        self.active[ar[join_a], va[join_a]] = True
        self.a_joined += join_a
        toggle = rng.random(b) < 0.2
        vb = self.n_u - 4 + rng.integers(0, 4, b)
        was = self.active[ar, vb]
        nid[toggle, 1] = vb[toggle]
        nflag[toggle, 1] = np.where(was[toggle], -1.0, 1.0)

        lane = np.arange(K_PAD)[None, :]
        c = (rng.integers(0, 1 << 30, b)[:, None] % self.c_count[:, None]
             + lane * PRIME_STRIDE) % self.c_count[:, None]
        lo, hi = self.endpoints(c)
        w_cur = np.take_along_axis(self.w, c, axis=1)
        u = rng.random((b, K_PAD))
        new = rng.uniform(0.5, 1.5, (b, K_PAD)).astype(np.float32)
        # present edges: 20% deleted, the rest re-weighted by ±20%;
        # absent ones: 20% added
        dw = np.where(w_cur > 0,
                      np.where(u < 0.2, -w_cur, w_cur * 0.4 * (new - 1.0)),
                      np.where(u < 0.2, new, 0.0)).astype(np.float32)
        emask = lane < rng.integers(K_PAD // 2, K_PAD + 1, b)[:, None]
        for r in burst_rows:
            c[r], dw[r], emask[r] = self.hub_shift(r)
            lo[r], hi[r] = self.endpoints(c[r:r + 1], slice(r, r + 1))
            w_cur[r] = self.w[r, c[r]]
        lo, hi = np.where(emask, lo, 0), np.where(emask, hi, 0)
        dw = np.where(emask, dw, 0.0).astype(np.float32)
        w_old = np.where(emask, w_cur, 0.0).astype(np.float32)
        gate = emask & self.active[ar[:, None], lo] \
            & self.active[ar[:, None], hi]
        rows, lanes = np.nonzero(gate)
        self.w[rows, c[rows, lanes]] = (w_cur + dw)[rows, lanes]
        self.active[ar[toggle], vb[toggle]] = ~was[toggle]

        def t(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x).astype(dtype))

        return GraphDelta(
            senders=t(lo, np.int32), receivers=t(hi, np.int32),
            dw=t(dw, np.float32), w_old=t(w_old, np.float32),
            mask=t(emask, np.float32), n_nodes=N_PAD,
            node_ids=t(nid, np.int32), node_flag=t(nflag, np.float32))


def phase_kernels(args, torch, out, dev):
    """Phase 2: each kernel against its plain version on the card."""
    from repro_torch.engine.stream import stack_deltas, stack_states
    from repro_torch.kernels.delta_stats import ops as ds_ops
    from repro_torch.kernels.delta_stats import parity as ds_parity
    from repro_torch.kernels.delta_stats.ref import delta_stats_sorted_ref
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.kernels.stream_tick import parity as st_parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    errs = {"stream_tick": 0.0, "delta_stats": 0.0}
    for shape in ((args.batch, N_PAD, K_PAD, J_PAD), (1000, 333, 37, 3)):
        states, deltas = st_parity.make_case(*shape, seed=args.seed,
                                             device=dev)
        for exact in (False, True):
            want = stream_tick_ref(states, deltas, exact_smax=exact)
            for inplace in (False, True):
                work = states.map_tensors(torch.clone) if inplace else states
                got = st_ops.stream_tick_fused(work, deltas, exact_smax=exact,
                                               inplace=inplace)
                err = st_parity.compare(got, want, f"stream_tick {shape}")
                errs["stream_tick"] = max(errs["stream_tick"], err)
                print(f"  stream_tick B,n,k,j={shape} exact_smax={exact} "
                      f"inplace={inplace}: max_abs_err={err:.3e}")
                del work, got
        del states, deltas, want
    cases = [st_parity.make_case(2048, N_PAD, K_PAD, J_PAD,
                                 seed=args.seed + s, device=dev)
             for s in range(3)]
    states = stack_states([c[0] for c in cases])
    deltas = stack_deltas([c[1] for c in cases])
    got = st_ops.stream_tick_fused_stacked(states, deltas, exact_smax=True)
    want = stream_tick_ref(states, deltas, exact_smax=True)
    err = st_parity.compare(got, want, "stream_tick_stacked")
    errs["stream_tick"] = max(errs["stream_tick"], err)
    print(f"  stream_tick_fused_stacked S=3 B=2048: max_abs_err={err:.3e}")
    del cases, states, deltas
    for k, masked in ((1, False), (7, False), (128, False), (1000, False),
                      (5000, False), (128, True)):
        state, delta = ds_parity.make_case(N_PAD * 4, k, seed=k, device=dev,
                                           all_masked=masked)
        prep = ds_ops.prepare_sorted_delta(state.strengths, delta)
        err = ds_parity.compare(ds_ops.delta_stats_sorted_cuda(*prep),
                                delta_stats_sorted_ref(*prep),
                                f"delta_stats k={k}")
        errs["delta_stats"] = max(errs["delta_stats"], err)
        print(f"  delta_stats k={k} all_masked={masked}: "
              f"max_abs_err={err:.3e}")
    out["errs"] = errs


def phase_serve(args, torch, out, dev):
    """Phase 3: the main path through FingerService."""
    import numpy as np

    from repro_torch.core.jsdist import jsdist_tilde
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

    if args.batch != 32768:
        print(f"  cut: batch_size {args.batch} instead of 32768")
    t0 = time.perf_counter()
    fleet = Fleet(args.batch, args.seed)
    graphs = fleet.graphs()
    t1 = time.perf_counter()
    cfg = ServiceConfig(batch_size=args.batch, n_pad=N_PAD, k_pad=K_PAD,
                        j_pad=J_PAD, method="fused_tick", exact_smax=True,
                        placement="local", ingestion="sync",
                        topk=TopKSpec(k=4))
    svc = FingerService.open(cfg, graphs, device=dev)
    torch.cuda.synchronize()
    sample = graphs[:256]
    edges = sum(int(g.mask.sum()) for g in sample) / len(sample)
    print(f"  opened B={args.batch} n_pad={N_PAD} k_pad={K_PAD} "
          f"j_pad={J_PAD}: graphs {t1 - t0:.1f} s, open "
          f"{time.perf_counter() - t1:.1f} s, mean edges/stream "
          f"{edges:.0f}, mean n {fleet.n_u.mean():.0f}")
    del graphs
    rng = np.random.default_rng(args.seed + 1)
    planted = sorted(rng.choice(args.batch, 4, replace=False).tolist())
    sampled = sorted(set(rng.choice(args.batch, 60, replace=False).tolist())
                     | set(planted))
    tick_ms, wall_ms = [], []
    snap = None
    st_ops.LAUNCHES = 0
    for t in range(TICKS):
        last = t == TICKS - 1
        if last:
            before_w = fleet.w[sampled].copy()
            before_a = fleet.active[sampled].copy()
        deltas = fleet.tick(burst_rows=planted if last else ())
        if t == TICKS // 2:
            snap = (svc.states().map_tensors(torch.clone),
                    deltas.to(dev))
        h0 = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        svc.ingest(deltas)
        ev0.record()
        svc.poll()
        ev1.record()
        ev1.synchronize()
        wall_ms.append((time.perf_counter() - h0) * 1e3)
        tick_ms.append(ev0.elapsed_time(ev1))
    launches = st_ops.LAUNCHES
    scores = svc.scores()
    if not np.isfinite(scores).all() or scores.shape != (args.batch,):
        raise AssertionError("main path: non-finite or misshapen scores")
    if launches != TICKS:
        raise AssertionError(f"stream_tick launched {launches} times in "
                             f"{TICKS} ticks")
    vals, ids = svc.top_anomalies(4)
    if sorted(ids.tolist()) != planted:
        raise AssertionError(f"top-4 {ids.tolist()} != planted {planted}")
    worst = 0.0
    for r, b in enumerate(sampled):
        g0 = fleet.graph_at(b, before_w[r], before_a[r], dev)
        g1 = fleet.graph_at(b, fleet.w[b], fleet.active[b], dev)
        ref = float(jsdist_tilde(g0, g1))
        worst = max(worst, abs(ref - float(scores[b])))
    if worst > 5e-3:
        raise AssertionError(f"incremental vs batch jsdist_tilde differs "
                             f"by {worst:.3e} > 5e-3")
    med = float(np.median(tick_ms))
    print(f"  {TICKS} ticks: median tick {med:.3f} ms (CUDA events "
          f"around poll, host-to-device copy included), median host "
          f"ingest+poll {np.median(wall_ms):.3f} ms, "
          f"{args.batch / med * 1e3:.4g} stream-ticks/s; stream_tick "
          f"launches {launches}")
    print(f"  top-4 {ids.tolist()} == planted {planted}, scores "
          f"{np.round(vals, 4).tolist()}; {len(sampled)} sampled scores "
          f"vs batch jsdist_tilde: max |diff| {worst:.3e} (bound 5e-3)")
    out["launches"] = {"stream_tick": launches}
    out["snap"] = snap
    traced_tick(torch, svc, fleet.tick())
    svc.close()


def traced_tick(torch, svc, deltas):
    """One more ingest → poll tick under `torch.profiler`: the device's
    busy time (kernels, copies, fills; overlaps counted once) against
    the tick's span on the host, from the exported trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("chip_smoke_tick"):
            svc.ingest(deltas)
            svc.poll()
            torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "build" / "tick_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "chip_smoke_tick"
            and e.get("ph") == "X"]
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["cat"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not span or not dev:
        print("  traced tick: the trace holds no device events; idle "
              "share not measured")
        return
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])

    def covered(intervals):
        """Microseconds of [t0, t1] covered by sorted intervals."""
        total, end = 0.0, t0
        for a, b in intervals:
            a, b = max(a, end), min(b, t1)
            if b > a:
                total += b - a
                end = b
        return total

    busy = covered([(a, b) for a, b, _, _ in dev])
    kern = covered([(a, b) for a, b, cat, _ in dev if cat == "kernel"])
    by_cat = {}
    for a, b, cat, name in dev:
        key = "stream_tick kernel" if "stream_tick" in name else cat
        by_cat[key] = by_cat.get(key, 0.0) + (b - a) / 1e3
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_cat.items()))
    print(f"  traced tick (profiler on): span {(t1 - t0) / 1e3:.3f} ms; "
          f"device busy {busy / 1e3:.3f} ms ({parts}); idle share "
          f"{1 - busy / (t1 - t0):.4f} with copies counted as busy, "
          f"{1 - kern / (t1 - t0):.4f} counting kernels only")


def phase_single(args, torch, out, dev):
    """Phase 4: the single-stream path through the delta_stats kernel."""
    import numpy as np

    from repro_torch.core.jsdist import jsdist_stream
    from repro_torch.core.state import finger_state
    from repro_torch.engine.stream import stack_deltas
    from repro_torch.kernels.delta_stats import ops as ds_ops

    fleet = Fleet(1, args.seed + 2, n_lo=N_PAD, n_hi=N_PAD)
    g = fleet.graph_at(0, fleet.w[0], fleet.active[0], dev)
    state = finger_state(g)
    deltas = stack_deltas([fleet.tick().map_tensors(lambda x: x[0])
                           for _ in range(20)]).to(dev)
    ds_ops.LAUNCHES = 0
    got, got_state = jsdist_stream(state, deltas, exact_smax=True,
                                   method="fused_tick")
    torch.cuda.synchronize()
    launches = ds_ops.LAUNCHES
    want, want_state = jsdist_stream(state, deltas, exact_smax=True,
                                     method="dense")
    div_err = float((got.double() ** 2 - want.double() ** 2).abs().max())
    np.testing.assert_allclose((got.double() ** 2).cpu().numpy(),
                               (want.double() ** 2).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    for f in ("q", "s_total", "s_max", "strengths"):
        np.testing.assert_allclose(getattr(got_state, f).cpu().numpy(),
                                   getattr(want_state, f).cpu().numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    if launches != 40:
        raise AssertionError(f"delta_stats launched {launches} times for "
                             "20 deltas (2 updates each)")
    print(f"  20 deltas, n_pad={N_PAD}, k_pad={K_PAD}: divergence max "
          f"|diff| vs dense {div_err:.3e}; delta_stats launches {launches}")
    out["launches"]["delta_stats"] = launches
    out["single"] = (state, deltas.map_tensors(lambda x: x[0]))


def kernel_rows(torch, out):
    """Times, bounds and errors of each kernel at the main path's
    shapes and inputs."""
    import dataclasses

    from repro_torch.core.incremental import gate_delta_for_update
    from repro_torch.kernels.delta_stats import ops as ds_ops
    from repro_torch.kernels.delta_stats import parity as ds_parity
    from repro_torch.kernels.delta_stats.ref import delta_stats_sorted_ref
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.kernels.stream_tick import parity as st_parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    # The main path's launch: in place (engine/stream.py), exact s_max,
    # on a copy of the state of tick TICKS // 2, restored before each call.
    snap, deltas = out["snap"]
    work = snap.map_tensors(torch.clone)

    def restore():
        for f in ("q", "s_total", "s_max", "strengths", "node_mask"):
            getattr(work, f).copy_(getattr(snap, f))

    def tick(d):
        return lambda: st_ops.stream_tick_fused(work, d, exact_smax=True,
                                                inplace=True)

    errs = out["errs"]
    want = stream_tick_ref(snap, deltas, exact_smax=True)
    got = tick(deltas)()
    err = st_parity.compare(got, want, "main-path tick")
    errs["stream_tick"] = max(errs["stream_tick"], err)
    changed = int((work.strengths != snap.strengths).sum()) \
        + int((work.node_mask != snap.node_mask).sum())
    del got, want
    ms = cuda_ms(tick(deltas), 20, setup=restore)
    plain = cuda_ms(lambda: stream_tick_ref(snap, deltas, exact_smax=True),
                    5)
    b, n = snap.strengths.shape
    k, j = deltas.dw.shape[-1], deltas.node_ids.shape[-1]
    # read: 3 scalars, the strength and mask rows, the delta; written:
    # dist, 3 scalars, and the state elements the delta changes
    bytes_tick = b * (4 * 3 + 8 * n + 20 * k + 8 * j) + b * 4 * 4 \
        + 4 * changed
    masked = dataclasses.replace(deltas, mask=torch.zeros_like(deltas.mask))
    first32 = dataclasses.replace(deltas, **{
        f: getattr(deltas, f)[:, :32].contiguous()
        for f in ("senders", "receivers", "dw", "w_old", "mask")})
    ms_masked = cuda_ms(tick(masked), 10, setup=restore)
    ms_k32 = cuda_ms(tick(first32), 10, setup=restore)
    print(f"  stream_tick in place, B={b} n_pad={n} k_pad={k} j_pad={j}: "
          f"{changed} state elements changed; every lane masked "
          f"{ms_masked:.4f} ms; first 32 lanes only {ms_k32:.4f} ms")
    del work, masked, first32
    rows = [{
        "name": "stream_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/stream_tick.cu",
        "replaces": "src/repro/kernels/stream_tick/kernel.py:193",
        "launches": out["launches"]["stream_tick"],
        "max_abs_err": errs["stream_tick"], "ms": ms, "plain_ms": plain,
        "bound_ms": bytes_tick / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None}]

    state, delta = out["single"]
    delta, _ = gate_delta_for_update(state.node_mask, delta)
    prep = ds_ops.prepare_sorted_delta(state.strengths, delta)
    err = ds_parity.compare(ds_ops.delta_stats_sorted_cuda(*prep),
                            delta_stats_sorted_ref(*prep), "main-path stats")
    errs["delta_stats"] = max(errs["delta_stats"], err)
    ms = cuda_ms(lambda: ds_ops.delta_stats_sorted_cuda(*prep), 200)
    plain = cuda_ms(lambda: delta_stats_sorted_ref(*prep), 50)
    bytes_stats = sum(t.numel() * t.element_size() for t in prep) + 16
    rows.append({
        "name": "delta_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_stats.cu",
        "replaces": "src/repro/kernels/delta_stats/kernel.py:77",
        "launches": out["launches"]["delta_stats"],
        "max_abs_err": errs["delta_stats"], "ms": ms, "plain_ms": plain,
        "bound_ms": bytes_stats / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None})
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']}), "
              f"launches {r['launches']}, max_abs_err "
              f"{r['max_abs_err']:.3e}")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32768)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {src}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import dispatch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda")
    out = {}
    phase = "build"
    try:
        dispatch.library()
        print(f"phase 1 build: {dispatch.build_seconds():.1f} s into "
              f"{dispatch.build_dir()}")
        phase = "kernels"
        print("phase 2 kernels vs plain versions:")
        phase_kernels(args, torch, out, dev)
        phase = "serve"
        print("phase 3 main path (FingerService, fused_tick):")
        phase_serve(args, torch, out, dev)
        phase = "single"
        print("phase 4 single-stream path (jsdist_stream, fused_tick):")
        phase_single(args, torch, out, dev)
        phase = "timing"
        print("kernel times at the main path's shapes and inputs:")
        rows = kernel_rows(torch, out)
    except Exception:  # report the phase, then fail the run
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED")
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
