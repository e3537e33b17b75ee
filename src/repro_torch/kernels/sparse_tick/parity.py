"""Kernel-vs-plain parity for the ``sparse_tick`` kernel on the card.

`make_case` builds a seeded synthetic sparse batch of two ticks. Its
node side is the edge-case batch of `stream_tick.parity.make_case` over
the slot axis (mixed masks, join and leave slots, padded lanes, ids
outside ``[0, n_slots)``, repeated ids, a join and a leave of one node
in one delta, all-masked deltas, an emptying delta and a revive from
empty), and it adds the edge store:

- a random ``(m_pad,)`` store per stream, about 60 % of it live;
- lanes that allocate a free slot (w_old = 0), lanes that free a live
  one (Δw = −w_old) and lanes that re-weight one, every slot unique
  within a stream and a tick, as the `SlotMap` contract requires;
- on row 5, live lanes at `EDGE_SLOT_SENTINEL`, at ``m_pad`` and (with
  ``out_of_range``) at −1, which write nothing; row 2's masked lanes
  keep real slots;
- row 0 empties its graph on the first tick (its store snaps to zero)
  and revives on the second with joins and first edges into free slots;
- with ``kind="stress"``, the stress rows of `stream_tick.parity` (a hub
  looped on every lane, a star, joins and leaves on touched nodes,
  all-masked rows without node slots beside live ones), each lane with
  its own slot; `STRESS` lists the shapes the card runs it at.

`check` ticks both deltas through the kernel and the plain version
(`ref.sparse_tick_ref`), and `compare` holds the kernel's outputs
against the plain version's after each tick. The CUDA tests and
``chip_smoke.py`` run both.

Tolerance, as in `stream_tick.parity`: carried state and the edge store
atol 1e-5 with rtol 1e-5; masks exact; the score as a divergence (score²)
at atol 1e-5, and itself at atol 1e-5 where the divergence exceeds 1e-3.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.core.sparse import (EDGE_SLOT_SENTINEL, SparseLayout,
                                     SparseStreamState)
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.stream_tick import parity as st_parity

ATOL, RTOL, DIV_FLOOR = st_parity.ATOL, st_parity.RTOL, st_parity.DIV_FLOOR

Case = Tuple[SparseStreamState, GraphDelta, GraphDelta]
# label: (B, n_slots, m_pad, k_pad, j_pad) of the stress case on the card
STRESS = {
    "k=37 ragged n, m": (64, 333, 777, 37, 3),
    "serving k=128": (256, 1024, 8192, 128, 8),
    "k=200 shared-memory sort": (64, 808, 1001, 200, 4),
    "k=1024 opt-in": (32, 4104, 2100, 1024, 8),
}


def _unique_slots(rng, b: int, k: int, m: int) -> np.ndarray:
    """(b, k) slots, distinct within each row: lane l of row r takes
    (start_r + l·stride_r) mod m with stride_r coprime to m."""
    stride = rng.integers(1, m, b)
    bad = np.gcd(stride, m) != 1
    while bad.any():
        stride[bad] = rng.integers(1, m, int(bad.sum()))
        bad = np.gcd(stride, m) != 1
    start = rng.integers(0, m, b)
    return (start[:, None] + np.arange(k)[None, :] * stride[:, None]) % m


def _with_slots(deltas: GraphDelta, store: np.ndarray, rng,
                out_of_range: bool) -> Tuple[GraphDelta, np.ndarray]:
    """Give every lane a slot (distinct within a stream) and make its
    w_old and Δw agree with the store: a lane on a free slot allocates,
    a lane on a live one frees or re-weights it. Masked lanes carry the
    sentinel. Returns the delta and the store after the tick, ungated."""
    b, k = deltas.dw.shape
    m = store.shape[1]
    slots = _unique_slots(rng, b, k, m)
    w_now = np.take_along_axis(store, slots, axis=1)
    emask = deltas.mask.cpu().numpy() > 0
    dw = deltas.dw.cpu().numpy()
    w_old = deltas.w_old.cpu().numpy()
    # rows 0 and 1 keep their named deltas (empty snap, revive); the
    # others follow the store
    rest = (np.arange(b) >= 2)[:, None]
    live = w_now > 0
    free_it = rng.random((b, k)) < 0.3
    w_old = np.where(rest, w_now, w_old).astype(np.float32)
    dw = np.where(rest & live & free_it, -w_now,
                  np.where(rest & ~live, np.abs(dw) + 0.1, dw))
    dw = dw.astype(np.float32)
    # row 2 is all masked and keeps its real slots
    slots[3:] = np.where(emask[3:], slots[3:], int(EDGE_SLOT_SENTINEL))
    slots[:2] = np.where(emask[:2], slots[:2], int(EDGE_SLOT_SENTINEL))
    # row 5's lanes are live and gated on: three write nothing
    slots[5, :3] = (int(EDGE_SLOT_SENTINEL), m,
                    -1 if out_of_range else m + 1)
    after = store.copy()
    rows, lanes = np.nonzero(emask & (slots >= 0) & (slots < m))
    after[rows, slots[rows, lanes]] = np.maximum(
        (w_old + dw)[rows, lanes], 0.0)
    dev = deltas.dw.device
    return dataclasses.replace(
        deltas, dw=torch.from_numpy(dw).to(dev),
        w_old=torch.from_numpy(w_old).to(dev),
        edge_slots=torch.from_numpy(slots.astype(np.int32)).to(dev)), after


def make_case(b: int, n_slots: int, m_pad: int, k_pad: int, j_pad: int,
              seed: int, device, out_of_range: bool = True,
              kind: str = "edge_cases") -> Case:
    """A seeded (states, first deltas, second deltas) sparse batch of
    ``b`` ≥ 8 streams; rows 0–7 hold the named edge cases, the rest are
    random. ``out_of_range=False`` keeps every node id inside the slot
    space and every slot non-negative (the JAX reference clamps
    out-of-range node ids and wraps negative slots where the port gates
    and drops them)."""
    if m_pad < 2 * k_pad + 4:
        raise ValueError("make_case needs m_pad >= 2*k_pad + 4")
    rng = np.random.default_rng(seed + 7919)
    fstate, d1 = st_parity.make_case(b, n_slots, k_pad, j_pad, seed,
                                     device, out_of_range=out_of_range,
                                     kind=kind)
    _, d2 = st_parity.make_case(b, n_slots, k_pad, j_pad, seed + 1,
                                device, out_of_range=out_of_range,
                                kind=kind)
    store = np.where(rng.random((b, m_pad)) < 0.6,
                     rng.uniform(0.5, 1.5, (b, m_pad)),
                     0.0).astype(np.float32)
    # row 0 deletes every edge of its graph on tick 1: its store holds
    # exactly those edges; row 1 starts empty and revives
    store[:2] = 0.0
    w0 = -d1.dw[0].cpu().numpy()
    d1, store = _with_slots(d1, store, rng, out_of_range)
    store_t0 = store.copy()
    slots0 = d1.edge_slots[0].cpu().numpy()
    store_t0[0] = 0.0
    store_t0[0, slots0] = w0
    # tick 2: row 0 revives with row 1's joins and first edges
    revive = {f: getattr(d2, f).clone() for f in d2.tensors()}
    for f in revive:
        revive[f][0] = revive[f][1]
    d2 = dataclasses.replace(d2, **revive)
    d2, _ = _with_slots(d2, store, rng, out_of_range)
    states = SparseStreamState(
        q=fstate.q, s_total=fstate.s_total, s_max=fstate.s_max,
        strengths=fstate.strengths, node_mask=fstate.node_mask,
        edge_weights=torch.from_numpy(store_t0).to(device),
        layout=SparseLayout(n_slots, m_pad))
    return states, d1, d2


def check(tick: Callable, case: Case, exact_smax: bool,
          label: str = "sparse_tick") -> float:
    """Both ticks of a case through ``tick(states, deltas, exact_smax)``
    and through the plain version, each second tick on its own first
    tick's output; raise if a tick disagrees, else return the largest
    absolute error. ``tick`` may update its state in place: each tick
    is compared before the next one runs."""
    from repro_torch.kernels.sparse_tick.ref import sparse_tick_ref

    states, d1, d2 = case
    got_state, want_state, errs = states, states, []
    for t, deltas in enumerate((d1, d2)):
        want = sparse_tick_ref(want_state, deltas, exact_smax=exact_smax)
        got = tick(got_state, deltas, exact_smax)
        errs.append(compare(got, want, f"{label} tick {t}"))
        got_state, want_state = got[1], want[1]
    return max(errs)


def compare(got: Tuple[torch.Tensor, SparseStreamState],
            want: Tuple[torch.Tensor, SparseStreamState],
            label: str = "sparse_tick") -> float:
    """Raise if the kernel's tick disagrees with the plain tick; return
    the largest absolute error over the compared outputs."""
    (d_got, s_got), (d_want, s_want) = got, want
    div_got = (d_got.double() ** 2).cpu().numpy()
    div_want = (d_want.double() ** 2).cpu().numpy()
    np.testing.assert_allclose(div_got, div_want, atol=ATOL, rtol=RTOL,
                               err_msg=f"{label}: divergence")
    errs = [np.abs(div_got - div_want).max(initial=0.0)]
    big = div_want > DIV_FLOOR
    dg, dw_ = d_got.cpu().numpy(), d_want.cpu().numpy()
    np.testing.assert_allclose(dg[big], dw_[big], atol=ATOL, rtol=0,
                               err_msg=f"{label}: dist")
    errs.append(np.abs(dg[big] - dw_[big]).max(initial=0.0))
    for field in ("q", "s_total", "s_max", "strengths", "edge_weights"):
        # one pull a state field: the fields are separate tensors
        a = getattr(s_got, field).cpu().numpy()  # lint: disable=per-item-host-sync
        w = getattr(s_want, field).cpu().numpy()  # lint: disable=per-item-host-sync
        np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label}: {field}")
        errs.append(np.abs(a - w).max(initial=0.0))
    np.testing.assert_array_equal(s_got.node_mask.cpu().numpy(),
                                  s_want.node_mask.cpu().numpy(),
                                  err_msg=f"{label}: node_mask")
    return float(max(errs))
