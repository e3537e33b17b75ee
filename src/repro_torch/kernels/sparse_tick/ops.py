"""Public op: the fused sparse serving tick (``method="sparse_tick"``).

`sparse_tick_fused` runs one whole Algorithm-2 tick of B stacked sparse
streams over their slot space — join/leave mask update, edge gating,
delta statistics of both updates, state update, H̃ and JSdist, and the
(m_pad,) edge-store scatter:

- tensors on a CUDA device go to one launch of the hand-written kernel
  (`csrc/sparse_tick.cu`, which replaces the TPU kernel
  `sparse_tick_pallas`); a launch CUDA refuses raises;
- tensors on the CPU go to the plain version (`ref.sparse_tick_ref`).

`sparse_tick_fused_stacked` is the (S, B) form: the same kernel over
S·B rows, a reshape and no second kernel.

The slot-space preconditions are checked by name first: a delta without
``edge_slots`` (not translated by a `SlotMap`) or addressed in another
``n_slots`` is refused, as is a (k_pad, j_pad) whose shared-memory
layout is above the card's per-block limit. The JAX wrapper routes such
tiles to its oracle; this one does not route on the card. The kernel
takes the state and delta tensors as they are: nothing is padded to
lane multiples and the per-edge payloads are not tiled onto endpoints
(TPU layout rules). ``inplace=True`` writes the new state into the given
state's tensors, as `stream_tick_fused` does, and returns a state over
the same tensors.

`fits_sparse_tick_stacked` is the fleet's admission check of one
stacked launch (shared memory and the residency budget).

``LAUNCHES`` counts kernel launches by entry point (never plain-version
calls): ``sparse_tick`` for `sparse_tick_fused`, ``sparse_tick_stacked``
for `sparse_tick_fused_stacked`. Each launch, the ctypes call and its
error check, is the span ``finger.tick.launch`` (`repro_torch.tracing`)
while a profiler records; the operand checks before it are not.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.sparse import SparseStreamState
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.kernels.sparse_tick.ref import sparse_tick_ref

LAUNCHES = {"sparse_tick": 0, "sparse_tick_stacked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SCALARS = ("q", "s_total", "s_max")
_ROWS = ("strengths", "node_mask")
_STATE_FIELDS = _SCALARS + _ROWS + ("edge_weights",)


def sparse_tick_stacked_bytes(s: int, b: int, n_slots: int, m_pad: int,
                              k_pad: int, j_pad: Optional[int]) -> int:
    """Device-resident operand bytes of one in-place shard-stacked
    launch over S shards of B streams: the state (3 scalars, the
    strength and mask rows and the (m_pad,) edge store, written in
    place), the delta's 5 lanes and its edge slots, the node slots and
    the (S, B) scores. Nothing is padded (the reference's count pads to
    TPU lanes)."""
    per_row = 4 * (4 + 2 * n_slots + m_pad + 6 * k_pad + 2 * (j_pad or 0))
    return s * b * per_row


def fits_sparse_tick_stacked(s: int, b: int, n_slots: int, m_pad: int,
                             k_pad: int, j_pad: Optional[int],
                             device: dispatch.Device = None) -> bool:
    """Stacked-launch admission on ``device``: a block's shared memory
    fits (stacking leaves it unchanged) and the S-stacked operands fit
    `dispatch.stacked_budget_bytes()`. A failing group ticks shard by
    shard."""
    return dispatch.smem_fits("sparse_tick", k_pad, j_pad or 0, device) \
        and dispatch.stacked_residency_bytes_ok(
            sparse_tick_stacked_bytes(s, b, n_slots, m_pad, k_pad, j_pad))


def _check_slot_space(states: SparseStreamState,
                      deltas: GraphDelta) -> None:
    if deltas.edge_slots is None:
        raise ValueError(
            "sparse_tick_fused: delta carries no edge_slots — sparse "
            "ticks need slot-space deltas; translate virtual deltas "
            "through each stream's SlotMap first (FingerService does "
            "this at ingest)")
    if deltas.n_nodes != states.layout.n_slots:
        raise ValueError(
            f"sparse_tick_fused: delta is addressed in an n_slots="
            f"{deltas.n_nodes} slot space but the state's layout has "
            f"n_slots={states.layout.n_slots} (generation "
            f"{states.layout.generation}); grow the capacity first "
            "(FingerService.grow_capacity)")


def _launch(name: str, states: SparseStreamState, deltas: GraphDelta,
            exact_smax: bool, inplace: bool
            ) -> Tuple[torch.Tensor, SparseStreamState]:
    lead = tuple(states.q.shape)
    n, m = states.n_slots, states.m_pad
    k = deltas.dw.shape[-1]
    j = 0 if deltas.node_ids is None else deltas.node_ids.shape[-1]
    dev = states.strengths.device
    if dev.type != "cuda":
        raise ValueError(f"sparse_tick kernel needs CUDA tensors, got {dev}")
    st = [getattr(states, f) for f in _STATE_FIELDS]
    dl = [deltas.senders, deltas.receivers, deltas.dw, deltas.w_old,
          deltas.mask, deltas.edge_slots]
    slots = [] if j == 0 else [deltas.node_ids, deltas.node_flag]
    f32, i32 = torch.float32, torch.int32
    dispatch.check_operands("sparse_tick", dev, [
        *((f, getattr(states, f), lead, f32) for f in _SCALARS),
        *((f, getattr(states, f), (*lead, n), f32) for f in _ROWS),
        ("edge_weights", states.edge_weights, (*lead, m), f32),
        *(("delta", t, (*lead, k), dtype)
          for t, dtype in zip(dl, (i32, i32, f32, f32, f32, i32))),
        *(("node slot", t, (*lead, j), dtype)
          for t, dtype in zip(slots, (i32, f32)))])
    dispatch.check_smem("sparse_tick", k, j, dev)
    outs = st if inplace else [torch.empty_like(t) for t in st]
    dist = torch.empty(lead, dtype=torch.float32, device=dev)
    fn = dispatch.library()["sparse_tick"].sparse_tick_launch
    fn.argtypes = [_P] * 21 + [_I] * 6 + [_P]
    fn.restype = _I
    nid, nflag = (None, None) if j == 0 else (slots[0].data_ptr(),
                                                slots[1].data_ptr())
    rows = int(torch.Size(lead).numel())
    with tracing.span("finger.tick.launch"):
        err = fn(*(t.data_ptr() for t in st + dl), nid, nflag,
                 dist.data_ptr(), *(t.data_ptr() for t in outs), rows, n,
                 m, k, j, int(bool(exact_smax)),
                 dispatch.stream_handle(dev))
        dispatch.check_launch("sparse_tick", err)
    LAUNCHES[name] += 1
    if inplace:
        return dist, states
    return dist, SparseStreamState(*outs, layout=states.layout)


def _tick(name: str, states: SparseStreamState, deltas: GraphDelta,
          exact_smax: bool, inplace: bool
          ) -> Tuple[torch.Tensor, SparseStreamState]:
    _check_slot_space(states, deltas)
    if states.strengths.device.type == "cpu":
        dist, new = sparse_tick_ref(states, deltas, exact_smax=exact_smax)
        if inplace:
            for f in _STATE_FIELDS:
                getattr(states, f).copy_(getattr(new, f))
            return dist, states
        return dist, new
    return _launch(name, states, deltas, exact_smax, inplace)


def sparse_tick_fused(states: SparseStreamState, deltas: GraphDelta,
                      exact_smax: bool = False, inplace: bool = False
                      ) -> Tuple[torch.Tensor, SparseStreamState]:
    """One batched sparse serving tick: (B,) JSdist scores + updated
    states."""
    return _tick("sparse_tick", states, deltas, exact_smax, inplace)


def sparse_tick_fused_stacked(states: SparseStreamState,
                              deltas: GraphDelta, exact_smax: bool = False,
                              inplace: bool = False
                              ) -> Tuple[torch.Tensor, SparseStreamState]:
    """Shard-stacked sparse tick over (S, B, ·) tensors: (S, B) scores
    and the updated stacked state, from one launch over S·B rows."""
    if states.q.dim() != 2:
        raise ValueError(
            f"sparse_tick_fused_stacked expects (S, B) stacked states, "
            f"got q of shape {tuple(states.q.shape)}")
    return _tick("sparse_tick_stacked", states, deltas, exact_smax, inplace)
