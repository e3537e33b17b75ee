#!/usr/bin/env python3
"""Time the kernels of this checkout against those of another one, on
one NVIDIA GPU, on the same inputs.

    python3 tools/kernel_ab.py --baseline DIR [--change DIR] [--seed S]
                               [--only NAME ...]

Each ``DIR`` holds a checkout's ``src/repro_torch/csrc`` sources (for
example ``git archive <commit> src/repro_torch/csrc | tar -x -C DIR``);
the change defaults to this checkout. Both sets are built with the
port's ``nvcc`` flags plus ``-Xptxas -v`` (registers and spills are
printed) and loaded with ctypes, and each kernel runs in turns,
baseline, change, change, baseline, CUDA-event means of each turn
printed. The change must export the residency and the per-stripe BSR
interface of this checkout. Inputs, from ``--seed``:

- ``stream_tick`` in place on the serving-size stress batch of
  `kernels/stream_tick/parity.py` (32768 streams, n_pad 1024, k_pad 128,
  j_pad 8), the state restored before every call; also with every edge
  lane masked and with the first 32 lanes only, and out of place at
  B = 4096, 8192, 16384 and 32768 (the time a wave of resident streams
  takes); each launch's resident blocks and streams per SM (the
  baseline's from CUDA's occupancy calculator on its own kernel);
- ``sparse_tick`` in place on the sparse serving-size stress batch
  (4096 streams, n_slots 1024, m_pad 8192);
- ``bsr_matvec`` on the offline phase's three 2¹⁸-node graphs
  (`chip_smoke.offline_edges`), where the change's y must equal the
  baseline's bit for bit;
- ``delta_stats`` at phase 4's shapes (one stream, n_pad 1024, k_pad
  128): the whole call from the gated delta, the baseline's as its
  sorted-form wrapper made it (`prepare_sorted_delta`, then one launch
  of its ``delta_stats_sorted_launch``, signatures set per call) against
  this checkout's `delta_stats_fused`; each launch alone; and the median
  per-delta time of `jsdist_incremental(method="fused_tick")` over phase
  4's 20 deltas with either one in `update_state`;
- ``vnge_q`` at n = 40 (the training probe's routing graph), 1000 and
  8192: the whole call, the baseline's two-launch wrapper (partials and
  output allocated, signatures set, per call) against this checkout's
  `vnge_q_stats`, both against the plain version.

- ``entropy_probe`` at (BH, S) = (192, 128) (the training probe),
  (48, 1000) (ragged) and (192, 1024), causal: the whole
  `attention_graph_stats` call, the baseline's as its two-kernel
  wrapper made it (signatures set per call, the row stats' two outputs,
  the graph stats' five buffers, two launches, then the plain closing
  `stats_from_parts`) against this checkout's; each kernel's wrapper
  alone; and, as the row stats' yardstick, ``torch.logsumexp(x, -1)``
  (the same read and reduction, one output). At (192, 128) also the
  host time to enqueue each of this checkout's calls and, from one
  `torch.profiler` session, each kernel's device time in a whole call.

The change side of ``delta_stats``, ``vnge_q`` and ``entropy_probe`` is
this checkout's wrappers and library (``--change`` moves the other
kernels only); each also times one empty launch through this checkout's
ctypes path, the floor of a one-launch op. ``--only`` runs a subset of
the A/Bs (by the names above); the baseline must hold every source the
chosen ones build.

The change's outputs are held against the plain versions (the parity
modules' tolerances), and the two sets against each other. Prints the
card's name and power limit first and writes every number to
``build/kernel_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# the residency of a baseline tick kernel that does not export it (one
# block of kThreads a stream): CUDA's occupancy calculator on its own
# instantiation, at its own block size and shared memory
OCCUPANCY_SRC = r"""
#include "tick_kernel.cuh"
REPRO_EXPORT int baseline_tick_residency(int k, int j, int* out) {
  const long long smem = TickLayout(k, j).bytes();
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(tick_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, tick_kernel<false>);
  out[1] = 1;
  out[2] = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], tick_kernel<false>, kThreads, static_cast<size_t>(smem)));
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int
BATCH = 32768  # the serving size of chip_smoke.py phase 3


def build(csrc: Path, out: Path, stems, extra=None) -> dict:
    """nvcc each source (and ``extra`` {stem: text}) into ``out``, all
    started together; print ptxas' register lines; load with ctypes."""
    from repro_torch.kernels import dispatch

    out.mkdir(parents=True, exist_ok=True)
    srcs = {s: csrc / f"{s}.cu" for s in stems}
    for stem, text in (extra or {}).items():
        srcs[stem] = out / f"{stem}.cu"
        srcs[stem].write_text(text)
    procs = {}
    for stem, src in srcs.items():
        cmd = [dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(csrc), "-o", str(out / f"lib{stem}.so"), str(src)]
        procs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for stem, proc in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {stem} failed:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{csrc.parent.parent.parent.name}/{stem}] "
                      f"{line.strip()}")
        libs[stem] = ctypes.CDLL(str(out / f"lib{stem}.so"))
    return libs


def tick_launch(lib, name, states, deltas, exact, inplace, store=False,
                warps=None):
    """One launch of a tick library's ``<name>_launch`` on the given
    tensors; returns (dist, output tensors). ``warps`` (warps a stream)
    is passed to a dense tick whose launcher takes it."""
    import torch

    from repro_torch.kernels import dispatch

    fields = ["q", "s_total", "s_max", "strengths", "node_mask"]
    if store:
        fields.append("edge_weights")
    st = [getattr(states, f) for f in fields]
    dl = [deltas.senders, deltas.receivers, deltas.dw, deltas.w_old,
          deltas.mask] + ([deltas.edge_slots] if store else [])
    outs = st if inplace else [torch.empty_like(t) for t in st]
    dist = torch.empty_like(states.q)
    rows = states.q.numel()
    n, k = states.strengths.shape[-1], deltas.dw.shape[-1]
    j = deltas.node_ids.shape[-1]
    fn = getattr(lib, f"{name}_launch")
    dims = [rows, n] + ([states.edge_weights.shape[-1]] if store else []) \
        + [k, j, int(exact)] + ([] if warps is None else [warps])
    fn.argtypes = [_P] * (len(st) + len(dl) + 3 + len(outs)) \
        + [_I] * len(dims) + [_P]
    fn.restype = _I
    err = fn(*(t.data_ptr() for t in st + dl), deltas.node_ids.data_ptr(),
             deltas.node_flag.data_ptr(), dist.data_ptr(),
             *(t.data_ptr() for t in outs), *dims,
             dispatch.stream_handle(states.q.device))
    if err:
        raise RuntimeError(f"{name} launch error {err}")
    return dist, outs


def residency(lib, fn_name, k, j):
    out = (ctypes.c_int * 3)()
    fn = getattr(lib, fn_name)
    fn.argtypes, fn.restype = [_I, _I, _P], _I
    if fn(k, j, ctypes.cast(out, _P)):
        raise RuntimeError(f"{fn_name} failed")
    blocks, streams, regs = out
    return {"blocks_per_sm": blocks, "streams_per_block": streams,
            "streams_per_sm": blocks * streams, "registers": regs}


def turns(label, fns, reps, setup=None):
    """CUDA-event means of baseline, change, change, baseline."""
    from chip_smoke import cuda_ms

    got = {"baseline": [], "change": []}
    for who in ("baseline", "change", "change", "baseline"):
        got[who].append(cuda_ms(fns[who], reps, setup=setup))
    print(f"  {label}: baseline {got['baseline'][0]:.4f} / "
          f"{got['baseline'][1]:.4f} ms, change {got['change'][0]:.4f} / "
          f"{got['change'][1]:.4f} ms")
    return got


def takes_warps(lib) -> bool:
    """Whether a stream tick library's launcher takes warps a stream: its
    ``stream_tick_launch_attrs`` reports twice the grid for two warps a
    stream as for one. A library from before the split ignores
    ``which`` there, or lacks the export."""
    fn = getattr(lib, "stream_tick_launch_attrs", None)
    if fn is None:
        return False
    fn.argtypes = [_I, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, _P, ctypes.c_char_p, _I]
    fn.restype = _I
    grids = []
    for which in (1, 2):
        out = (ctypes.c_longlong * 16)()
        name = ctypes.create_string_buffer(64)
        if fn(which, 64, 8, 2, ctypes.cast(out, _P), name, len(name)):
            return False
        grids.append(out[0])
    return grids[1] == 2 * grids[0]


def ab_stream_tick(libs, base, args, res):
    import dataclasses

    import torch

    from repro_torch.kernels.stream_tick import parity as st_parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    dev = torch.device("cuda")
    k, j = 128, 8
    res["stream_tick_residency"] = {
        "baseline": residency(*base["residency"], k, j),
        "change": residency(libs["stream_tick"], "stream_tick_residency",
                            k, j)}
    print(f"  stream_tick residency at k={k}, j={j}: "
          f"{res['stream_tick_residency']}")
    states, deltas = st_parity.make_case(BATCH, 1024, k, j,
                                         seed=args.seed, device=dev,
                                         kind="stress")
    want = stream_tick_ref(states, deltas, exact_smax=True)
    # each library with its warps a stream: one, where the launcher takes it
    sides = {"baseline": (base["stream_tick"], base["tick_warps"]),
             "change": (libs["stream_tick"], 1)}
    got = {w: tick_launch(lib, "stream_tick", states, deltas, True, False,
                          warps=wps)
           for w, (lib, wps) in sides.items()}
    again = tick_launch(libs["stream_tick"], "stream_tick", states, deltas,
                        True, False, warps=1)
    from repro_torch.core.state import FingerState

    def as_state(r):
        return r[0], FingerState(*r[1], layout=states.layout)

    for w in got:
        st_parity.compare(as_state(got[w]), want, f"stream_tick {w}")
    same = all(torch.equal(a, b) for a, b in zip(
        [again[0], *again[1]], [got["change"][0], *got["change"][1]]))
    print(f"  stream_tick B={BATCH}: both sets match the plain "
          f"version; the change's two launches bit-equal: {same}")
    if not same:
        raise AssertionError("stream_tick: two launches differ")
    work = states.map_tensors(torch.clone)

    def restore():
        for f in ("q", "s_total", "s_max", "strengths", "node_mask"):
            getattr(work, f).copy_(getattr(states, f))

    def inplace(side, d):
        lib, wps = sides[side]
        return lambda: tick_launch(lib, "stream_tick", work, d, True, True,
                                   warps=wps)

    masked = dataclasses.replace(deltas, mask=torch.zeros_like(deltas.mask))
    first32 = dataclasses.replace(deltas, **{
        f: getattr(deltas, f)[:, :32].contiguous()
        for f in ("senders", "receivers", "dw", "w_old", "mask")})
    for label, d in (("in place", deltas), ("every lane masked", masked),
                     ("first 32 lanes", first32)):
        res[f"stream_tick {label}"] = turns(
            f"stream_tick {label} B={BATCH}",
            {w: inplace(w, d) for w in sides}, 10, setup=restore)
    for b in (4096, 8192, 16384, 32768):
        sub = states.map_tensors(lambda t: t[:b])
        dsub = deltas.map_tensors(lambda t: t[:b])
        res[f"stream_tick out of place B={b}"] = turns(
            f"stream_tick out of place B={b}",
            {w: (lambda lib=lib, wps=wps: tick_launch(
                lib, "stream_tick", sub, dsub, True, False, warps=wps))
             for w, (lib, wps) in sides.items()}, 10)


def ab_sparse_tick(libs, base, args, res):
    import torch

    from repro_torch.core.sparse import SparseStreamState
    from repro_torch.kernels.sparse_tick import parity as sp_parity
    from repro_torch.kernels.sparse_tick.ref import sparse_tick_ref

    dev = torch.device("cuda")
    states, d1, _ = sp_parity.make_case(4096, 1024, 8192, 128, 8,
                                        seed=args.seed, device=dev,
                                        kind="stress")
    want = sparse_tick_ref(states, d1, exact_smax=True)
    for w, lib in (("baseline", base["sparse_tick"]),
                   ("change", libs["sparse_tick"])):
        r = tick_launch(lib, "sparse_tick", states, d1, True, False, True)
        sp_parity.compare((r[0], SparseStreamState(*r[1],
                                                   layout=states.layout)),
                          want, f"sparse_tick {w}")
    work = states.map_tensors(torch.clone)

    def restore():
        for f in ("q", "s_total", "s_max", "strengths", "node_mask",
                  "edge_weights"):
            getattr(work, f).copy_(getattr(states, f))

    res["sparse_tick in place"] = turns(
        "sparse_tick in place B=4096",
        {w: (lambda lib=lib: tick_launch(lib, "sparse_tick", work, d1, True,
                                         True, True))
         for w, lib in (("baseline", base["sparse_tick"]),
                        ("change", libs["sparse_tick"]))}, 20,
        setup=restore)


def ab_bsr(libs, base, args, res):
    import torch

    from chip_smoke import OFF_B, OFF_N, offline_edges
    from repro_torch.kernels.bsr_spmv import ops as bs_ops
    from repro_torch.kernels.bsr_spmv import parity as bs_parity
    from repro_torch.kernels.bsr_spmv.ref import bsr_matvec_ref, edges_to_bsr

    dev = torch.device("cuda")

    def launcher(lib):
        """The library's bsr_matvec_launch: with the per-stripe counts
        and order if it takes them, else over every slot."""
        fn = lib.bsr_matvec_launch
        counted = (base_counted if lib is base["bsr_spmv"] else True)
        fn.argtypes = [_P] * (6 if counted else 4) + [_I] * 3 + [_P]
        fn.restype = _I

        def call(m, x, order):
            y = torch.empty_like(x)
            n_rb, max_bpr, b, _ = m.values.shape
            extra = [m.counts.data_ptr(), order.data_ptr()] if counted \
                else []
            if fn(m.values.data_ptr(), m.col_ids.data_ptr(), *extra,
                  x.data_ptr(), y.data_ptr(), n_rb, max_bpr, b,
                  torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("bsr_matvec launch failed")
            return y
        return call

    base_counted = "counts" in (args.baseline.resolve() / "src" /
                                "repro_torch" / "csrc" /
                                "bsr_spmv.cu").read_text()
    baseline, change = launcher(base["bsr_spmv"]), launcher(libs["bsr_spmv"])

    t0 = time.perf_counter()
    edges = offline_edges(args.seed)
    print(f"  offline graphs drawn in {time.perf_counter() - t0:.1f} s")
    for name, e in edges.items():
        m = edges_to_bsr(*e, OFF_N, b=OFF_B, device=dev)
        order = bs_ops.stripe_order(m.counts, m.col_ids.shape[1])
        x = torch.randn(m.n, generator=torch.Generator().manual_seed(2)) \
            .to(dev)
        a = baseline(m, x, order)
        c = change(m, x, order)
        bs_parity.compare(c, bsr_matvec_ref(m, x), f"bsr_matvec {name}")
        equal = bool(torch.equal(a, c))
        print(f"  bsr_matvec {name}: max_bpr {m.col_ids.shape[1]}, real "
              f"slots {int(m.counts.sum())} of {m.col_ids.numel()}; y "
              f"bit-equal to the baseline: {equal}")
        if not equal:
            raise AssertionError(f"bsr_matvec {name}: y differs from the "
                                 "baseline's")
        res[f"bsr_matvec {name}"] = turns(
            f"bsr_matvec {name}",
            {"baseline": lambda: baseline(m, x, order),
             "change": lambda: change(m, x, order)}, 20)
        del m, x, a, c


def parent_delta_stats_fused(lib):
    """`delta_stats_fused` as the sorted-form wrapper made it on a CUDA
    tensor: the sorted form in torch, then one launch of ``lib``'s
    ``delta_stats_sorted_launch``."""
    import math

    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.delta_stats import ops as ds_ops

    def fused(state, delta, pre_gated=False):
        assert pre_gated
        prep = ds_ops.prepare_sorted_delta(state.strengths, delta)
        lead = prep[0].shape[:-1]
        dev = prep[0].device
        for t in prep:
            if t.device != dev or t.shape[:-1] != lead:
                raise ValueError("delta_stats: inputs disagree")
        args = [t.contiguous() for t in prep]
        out = torch.empty((*lead, 4), dtype=torch.float32, device=dev)
        fn = lib.delta_stats_sorted_launch
        fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        fn.restype = _I
        if fn(*(t.data_ptr() for t in args), out.data_ptr(),
              math.prod(lead), prep[0].shape[-1], prep[4].shape[-1],
              dispatch.stream_handle(dev)):
            raise RuntimeError("baseline delta_stats launch failed")
        return out[..., 0], out[..., 1], out[..., 2]
    return fused


def parent_vnge_q_stats(lib):
    """`vnge_q_stats_cuda` as the two-launch wrapper made it: ``lib``'s
    partial count, partials and output allocated, both launches."""
    import torch

    from repro_torch.kernels import dispatch

    def stats(w):
        if w.dim() != 2 or w.shape[0] != w.shape[1]:
            raise ValueError("vnge_q: W must be square")
        n = w.shape[0]
        dispatch.check_operands("vnge_q", w.device,
                                [("W", w, (n, n), torch.float32)])
        lib.vnge_q_partial_blocks.argtypes = [_I]
        lib.vnge_q_partial_blocks.restype = _I
        blocks = lib.vnge_q_partial_blocks(n)
        partial = torch.empty((max(blocks, 1), 4), dtype=torch.float32,
                              device=w.device)
        out = torch.empty((4,), dtype=torch.float32, device=w.device)
        fn = lib.vnge_q_stats_launch
        fn.argtypes = [_P, _P, _P, _I, _P]
        fn.restype = _I
        if fn(w.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
              dispatch.stream_handle(w.device)):
            raise RuntimeError("baseline vnge_q launch failed")
        return out
    return stats


def parent_entropy_probe(lib):
    """(row stats, graph stats, whole call) as the two-kernel wrappers
    made them: signatures set per call, the row max and exp-sum as two
    outputs, then the tile pass and the per-head reduction into five
    buffers, closed by `stats_from_parts` in torch."""
    import torch

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.entropy_probe.ref import stats_from_parts

    def rows(x):
        bh, s, _ = x.shape
        rowmax = torch.empty((bh, s), dtype=torch.float32, device=x.device)
        denom = torch.empty_like(rowmax)
        fn = lib.row_stats_launch
        fn.argtypes = [_P, _P, _P, ctypes.c_longlong, _I, _P]
        fn.restype = _I
        if fn(x.data_ptr(), rowmax.data_ptr(), denom.data_ptr(), bh * s, s,
              dispatch.stream_handle(x.device)):
            raise RuntimeError("baseline row_stats launch failed")
        return rowmax, denom

    def graph(x, rowmax, denom):
        bh, s, _ = x.shape
        dev = x.device
        for f in (lib.entropy_probe_tiles, lib.entropy_probe_pairs):
            f.argtypes, f.restype = [_I], _I
        tiles, pairs = lib.entropy_probe_tiles(s), lib.entropy_probe_pairs(s)
        part_col = torch.empty((bh, tiles, s), dtype=torch.float32,
                               device=dev)
        part_scal = torch.empty((bh, pairs, 2), dtype=torch.float32,
                                device=dev)
        scal = torch.empty((bh, 3), dtype=torch.float32, device=dev)
        colsum = torch.empty((bh, s), dtype=torch.float32, device=dev)
        diag = torch.empty((bh, s), dtype=torch.float32, device=dev)
        fn = lib.graph_stats_launch
        fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P]
        fn.restype = _I
        if fn(x.data_ptr(), rowmax.data_ptr(), denom.data_ptr(), bh, s,
              part_col.data_ptr(), part_scal.data_ptr(), scal.data_ptr(),
              colsum.data_ptr(), diag.data_ptr(),
              dispatch.stream_handle(dev)):
            raise RuntimeError("baseline graph_stats launch failed")
        return scal, colsum, diag

    def whole(x):
        return stats_from_parts(*graph(x, *rows(x)))

    return rows, graph, whole


def host_ms(fn, reps: int = 300) -> float:
    """Mean host milliseconds to enqueue one call of ``fn`` (no sync in
    the timed loop): where it is above the device time, a back-to-back
    call is bound by the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def device_ms(fn, reps: int = 50) -> dict:
    """Mean device milliseconds a call of each kernel ``fn`` launches, by
    kernel name, from one `torch.profiler` session (the process's only
    one: a second records no device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def ab_entropy_probe(libs, base, args, res):
    import torch

    from chip_smoke import PROBE_SHAPES, cuda_ms
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.entropy_probe import ops as ep_ops
    from repro_torch.kernels.entropy_probe import parity as ep_parity
    from repro_torch.kernels.entropy_probe import ref as ep_ref

    dev = torch.device("cuda")
    b_rows, b_graph, b_whole = parent_entropy_probe(base["entropy_probe"])
    for bh, s in PROBE_SHAPES:
        x = ep_parity.make_case(bh, s, seed=args.seed + s, device=dev)
        rows = ep_ref.row_stats_ref(x)
        want = ep_ref.attention_graph_stats_ref(x)
        ep_parity.compare(b_rows(x), rows, f"baseline row_stats {s}")
        ep_parity.compare(ep_ops.row_stats_cuda(x), rows,
                          f"change row_stats {s}")
        ep_parity.compare([b_whole(x)], [want], f"baseline whole {s}")
        ep_parity.compare([ep_ops.attention_graph_stats(x)], [want],
                          f"change whole {s}")
        print(f"  entropy_probe (BH, S)={(bh, s)}: both match the plain "
              "versions")
        label = f"entropy_probe {(bh, s)}"
        res[f"{label} whole call"] = turns(
            f"attention_graph_stats {(bh, s)}, whole call",
            {"baseline": lambda: b_whole(x),
             "change": lambda: ep_ops.attention_graph_stats(x)}, 100)
        res[f"{label} row_stats"] = turns(
            f"row_stats {(bh, s)}, the wrapper alone",
            {"baseline": lambda: b_rows(x),
             "change": lambda: ep_ops.row_stats_cuda(x)}, 100)
        b_in, c_in = b_rows(x), ep_ops.row_stats_cuda(x)
        res[f"{label} graph_stats"] = turns(
            f"graph_stats {(bh, s)}, the wrapper alone (baseline: tile "
            "pass + reduction, unclosed)",
            {"baseline": lambda: b_graph(x, *b_in),
             "change": lambda: ep_ops.graph_stats_cuda(x, *c_in)}, 100)
        res[f"{label} logsumexp"] = cuda_ms(lambda: torch.logsumexp(x, -1),
                                            100)
        print(f"  torch.logsumexp(x, -1) {(bh, s)}: "
              f"{res[f'{label} logsumexp']:.4f} ms")
        if (bh, s) == PROBE_SHAPES[0]:  # the path's shape: host or device?
            host = res[f"{label} host enqueue"] = {
                "row_stats": host_ms(lambda: ep_ops.row_stats_cuda(x)),
                "graph_stats": host_ms(
                    lambda: ep_ops.graph_stats_cuda(x, *c_in)),
                "whole call": host_ms(
                    lambda: ep_ops.attention_graph_stats(x)),
                "empty launch": host_ms(lambda: dispatch.empty_launch(
                    "entropy_probe", dev))}
            print(f"  host time to enqueue a call {(bh, s)}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in host.items()))
            dev_t = res[f"{label} device"] = device_ms(
                lambda: ep_ops.attention_graph_stats(x))
            print(f"  device time a whole call {(bh, s)} (torch.profiler): "
                  + ", ".join(f"{k.split('::')[-1].split('(')[0]} "
                              f"{v:.4f} ms" for k, v in dev_t.items()))
        del x, rows, b_in, c_in
    res["entropy_probe empty launch"] = cuda_ms(
        lambda: dispatch.empty_launch("entropy_probe", dev), 200)
    print(f"  one empty launch through the change's ctypes path: "
          f"{res['entropy_probe empty launch']:.4f} ms")


def ab_delta_stats(libs, base, args, res):
    import numpy as np
    import torch

    from chip_smoke import N_PAD, Fleet, cuda_ms
    from repro_torch.core.incremental import gate_delta_for_update
    from repro_torch.core.jsdist import jsdist_incremental
    from repro_torch.core.state import finger_state
    from repro_torch.engine.stream import stack_deltas
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.delta_stats import ops as ds_ops
    from repro_torch.kernels.delta_stats import parity as ds_parity

    dev = torch.device("cuda")
    fleet = Fleet(1, args.seed + 2, n_lo=N_PAD, n_hi=N_PAD)
    g = fleet.graph_at(0, fleet.w[0], fleet.active[0], dev)
    state = finger_state(g)
    deltas = stack_deltas([fleet.tick().map_tensors(lambda x: x[0])
                           for _ in range(20)]).to(dev)
    delta, _ = gate_delta_for_update(state.node_mask,
                                     deltas.map_tensors(lambda x: x[0]))
    fused = {"baseline": parent_delta_stats_fused(base["delta_stats"]),
             "change": ds_ops.delta_stats_fused}
    want = ds_parity.plain(state.strengths, delta)
    for who, fn in fused.items():
        got = torch.stack(fn(state, delta, pre_gated=True))
        ds_parity.compare(got, want[:3], f"delta_stats {who}")
    print(f"  delta_stats n_pad={N_PAD} k_pad={delta.dw.shape[-1]} "
          f"|dV|={int(want[3])}: both match the plain version")
    res["delta_stats whole call"] = turns(
        "delta_stats_fused, whole call from the gated delta",
        {w: (lambda fn=fn: fn(state, delta, pre_gated=True))
         for w, fn in fused.items()}, 200)
    prep = ds_ops.prepare_sorted_delta(state.strengths, delta)
    sorted_fn = base["delta_stats"].delta_stats_sorted_launch
    sorted_fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    sorted_fn.restype = _I
    out = torch.empty(4, device=dev)

    def sorted_launch():
        if sorted_fn(*(t.data_ptr() for t in prep), out.data_ptr(), 1,
                     prep[0].shape[-1], prep[4].shape[-1],
                     dispatch.stream_handle(dev)):
            raise RuntimeError("baseline delta_stats launch failed")

    res["delta_stats launch alone"] = turns(
        "delta_stats launch alone (baseline: the sorted-form kernel on "
        "prepared inputs)",
        {"baseline": sorted_launch,
         "change": lambda: ds_ops.delta_stats_cuda(state.strengths, delta)},
        200)
    res["empty launch"] = cuda_ms(
        lambda: dispatch.empty_launch("delta_stats", dev), 200)
    print(f"  one empty launch through the change's ctypes path: "
          f"{res['empty launch']:.4f} ms")

    def path(who):
        """Median ms of jsdist_incremental a delta over the 20 deltas,
        with ``who``'s delta_stats_fused in update_state."""
        saved = ds_ops.delta_stats_fused
        ds_ops.delta_stats_fused = fused[who]
        try:
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(20)]
            st = state
            torch.cuda.synchronize()
            for t, (e0, e1) in enumerate(ev):
                e0.record()
                _, st = jsdist_incremental(
                    st, deltas.map_tensors(lambda x: x[t]), exact_smax=True,
                    method="fused_tick")
                e1.record()
            torch.cuda.synchronize()
            return float(np.median([a.elapsed_time(b) for a, b in ev]))
        finally:
            ds_ops.delta_stats_fused = saved

    got = {"baseline": [], "change": []}
    for who in ("baseline", "change", "change", "baseline"):
        got[who].append(path(who))
    print(f"  jsdist_incremental(fused_tick) median a delta: baseline "
          f"{got['baseline'][0]:.4f} / {got['baseline'][1]:.4f} ms, change "
          f"{got['change'][0]:.4f} / {got['change'][1]:.4f} ms")
    res["jsdist_incremental a delta"] = got


def ab_vnge_q(libs, base, args, res):
    import torch

    from chip_smoke import cuda_ms

    from repro_torch.kernels import dispatch
    from repro_torch.kernels.vnge_q import ops as vq_ops
    from repro_torch.kernels.vnge_q import parity as vq_parity
    from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

    dev = torch.device("cuda")
    fns = {"baseline": parent_vnge_q_stats(base["vnge_q"]),
           "change": vq_ops.vnge_q_stats}
    for n in (40, 1000, 8192):
        w, _ = vq_parity.make_case(n, seed=args.seed + n, device=dev)
        got = {who: fn(w) for who, fn in fns.items()}
        for who, g in got.items():
            vq_parity.compare(g, vnge_q_stats_ref(w), f"vnge_q {who} n={n}")
        print(f"  vnge_q n={n}: both match the plain version")
        res[f"vnge_q n={n}"] = turns(
            f"vnge_q_stats n={n}, whole call",
            {who: (lambda fn=fn: fn(w)) for who, fn in fns.items()}, 200)
    res["vnge_q empty launch"] = cuda_ms(
        lambda: dispatch.empty_launch("vnge_q", dev), 200)
    print(f"  one empty launch through the change's ctypes path: "
          f"{res['vnge_q empty launch']:.4f} ms")


# name → (the A/B, the library stems it builds on both sides)
AB = {
    "stream_tick": (ab_stream_tick, ("stream_tick",)),
    "sparse_tick": (ab_sparse_tick, ("sparse_tick",)),
    "bsr_spmv": (ab_bsr, ("bsr_spmv",)),
    "delta_stats": (ab_delta_stats, ("delta_stats",)),
    "vnge_q": (ab_vnge_q, ("vnge_q",)),
    "entropy_probe": (ab_entropy_probe, ("entropy_probe",)),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", required=True, type=Path)
    ap.add_argument("--change", type=Path, default=ROOT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="+", choices=sorted(AB),
                    default=sorted(AB), help="the A/Bs to run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"card: {card}")
    base_csrc = args.baseline.resolve() / "src" / "repro_torch" / "csrc"
    print("building the baseline and the change with -Xptxas -v:")
    stems = sorted({s for name in args.only for s in AB[name][1]})
    extra = None
    if "stream_tick" in args.only:
        # a baseline without its own residency export gets the helper
        own = "stream_tick_residency" in (base_csrc / "stream_tick.cu") \
            .read_text()
        extra = None if own else {"occupancy": OCCUPANCY_SRC}
    base = build(base_csrc, ROOT / "build" / "kernel_ab" / "baseline",
                 stems, extra)
    if "stream_tick" in args.only:
        base["residency"] = ((base["stream_tick"], "stream_tick_residency")
                             if own else
                             (base["occupancy"], "baseline_tick_residency"))
        base["tick_warps"] = 1 if takes_warps(base["stream_tick"]) else None
    libs = build(args.change.resolve() / "src" / "repro_torch" / "csrc",
                 ROOT / "build" / "kernel_ab" / "change", stems)
    res = {"card": card}
    for name in sorted(args.only, key=list(AB).index):
        AB[name][0](libs, base, args, res)
    out = ROOT / "build" / "kernel_ab.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
