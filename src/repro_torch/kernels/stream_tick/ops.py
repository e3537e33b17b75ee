"""Public op: the single-pass batched serving tick (``method="fused_tick"``).

`stream_tick_fused` runs one whole Algorithm-2 tick — join/leave mask
update, edge gating, delta statistics of both updates, state update,
H̃ and JSdist — for B stacked streams:

- tensors on a CUDA device go to one launch of the hand-written kernel
  (`csrc/stream_tick.cu`, which replaces the TPU kernel
  `stream_tick_pallas`); a launch CUDA refuses raises;
- tensors on the CPU go to the plain version (`ref.stream_tick_ref`).

`stream_tick_fused_stacked` is the (S, B) form: the same kernel over
S·B rows, a reshape and no second kernel.

The kernel takes the state and delta tensors as they are. Nothing is
padded to 128 lanes or 256 endpoints, and the per-edge payloads are not
tiled onto endpoints: those were TPU layout rules. ``inplace=True``
writes the new state into the given state's tensors (the PyTorch
counterpart of JAX's donation; the kernel completes every gather from
a row before its first write to it, and writes only the elements whose
value changes) and returns a state over the same tensors.

`fits_fused_tick_stacked` is the fleet's admission check of one
stacked launch (shared memory and the residency budget).

How many warps a stream takes, W, comes from the launch's shape alone
(`warps_per_stream`): one warp a stream where the rows fill the card's
resident warps, else up to 8 warps splitting each row, so that few long
rows still keep the card's loads in flight. Every W gives the same bits.

``LAUNCHES`` counts kernel launches by entry point (never plain-version
calls): ``stream_tick`` for `stream_tick_fused`, ``stream_tick_stacked``
for `stream_tick_fused_stacked`; ``SPLIT_LAUNCHES`` counts those of them
that took more than one warp a stream. Each launch, the ctypes call and its
error check, is the span ``finger.tick.launch`` (`repro_torch.tracing`)
while a profiler records; the operand checks before it are not.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.state import FingerState
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.kernels.stream_tick.ref import stream_tick_ref

LAUNCHES = {"stream_tick": 0, "stream_tick_stacked": 0}
SPLIT_LAUNCHES = {"stream_tick": 0, "stream_tick_stacked": 0}

# the elements one warp's row step covers: 32 lanes × kRowSteps
# (csrc/tick_kernel.cuh)
ROW_STEP = 32 * 4

_P, _I = ctypes.c_void_p, ctypes.c_int
_STATE_FIELDS = ("q", "s_total", "s_max", "strengths", "node_mask")


def stream_tick_smem_bytes(k: int, j: int) -> int:
    """Dynamic shared memory one block needs for k edge lanes and j node
    slots, as the kernel's own layout (`TickLayout`) computes it."""
    return dispatch.smem_bytes("stream_tick", k, j)


def stream_tick_smem_limit(device: torch.device) -> int:
    """The card's shared memory per block, with the opt-in above 48 KB."""
    return dispatch.smem_limit("stream_tick", device)


def fused_tick_stacked_bytes(s: int, b: int, n_pad: int, k_pad: int,
                             j_pad: Optional[int]) -> int:
    """Device-resident operand bytes of one in-place shard-stacked
    launch over S shards of B streams: the state (3 scalars, the
    strength and mask rows, written in place), the delta's 5 lanes, the
    node slots and the (S, B) scores. Nothing is padded (the
    reference's count pads to TPU lanes)."""
    per_row = 4 * (4 + 2 * n_pad + 5 * k_pad + 2 * (j_pad or 0))
    return s * b * per_row


def fits_fused_tick_stacked(s: int, b: int, n_pad: int, k_pad: int,
                            j_pad: Optional[int],
                            device: dispatch.Device = None) -> bool:
    """Stacked-launch admission on ``device``: a block's shared memory
    fits (stacking leaves it unchanged) and the S-stacked operands fit
    `dispatch.stacked_budget_bytes()`. A failing group ticks shard by
    shard."""
    return dispatch.smem_fits("stream_tick", k_pad, j_pad or 0, device) \
        and dispatch.stacked_residency_bytes_ok(
            fused_tick_stacked_bytes(s, b, n_pad, k_pad, j_pad))


def warps_per_stream(rows: int, n: int, capacity: int,
                     warps_per_block: int = 8) -> int:
    """Warps the stream tick kernel gives each of ``rows`` streams of
    ``n`` nodes on a card that keeps ``capacity`` warps resident (blocks
    an SM × SMs × warps a block, `dispatch.residency`).

    1 where the rows fill the card (rows ≥ capacity); otherwise the
    largest W of 2, 4 and 8 that divides ``warps_per_block``, keeps
    rows · W ≤ capacity and leaves each warp at least one whole row step
    (n ≥ W · ROW_STEP), or 1 where none does. The sparse tick always
    takes one warp a stream (its launcher refuses more)."""
    return max((w for w in (2, 4, 8) if warps_per_block % w == 0
                and rows * w <= capacity and n >= w * ROW_STEP), default=1)


@functools.lru_cache(maxsize=None)
def _capacity(index: int, k: int, j: int) -> Tuple[int, int]:
    """(resident warps on card ``index``, warps a block) of the tick
    kernel's launch for k edge lanes and j node slots; the same at every
    W, read once per shape."""
    res = dispatch.residency("stream_tick", k, j)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return res["streams_per_sm"] * sms, res["streams_per_block"]


def _check_layout(name: str, states: FingerState, deltas: GraphDelta):
    if states.layout is not None and deltas.n_nodes > states.layout.n_pad:
        raise ValueError(
            f"{name}: delta is addressed in an n_pad={deltas.n_nodes} "
            f"layout but the state's layout is n_pad="
            f"{states.layout.n_pad} (generation "
            f"{states.layout.generation}); migrate the state first")
    if states.node_mask is None:
        raise ValueError(
            f"{name} needs a mask-aware stacked state (node_mask is "
            "None); build it with StreamEngine.init_states")


def _copy_into(states: FingerState, dist: torch.Tensor,
               new: FingerState) -> Tuple[torch.Tensor, FingerState]:
    for f in _STATE_FIELDS:
        getattr(states, f).copy_(getattr(new, f))
    return dist, states


def _launch(name: str, states: FingerState, deltas: GraphDelta,
            exact_smax: bool, inplace: bool
            ) -> Tuple[torch.Tensor, FingerState]:
    lead = tuple(states.q.shape)
    n = states.strengths.shape[-1]
    k = deltas.dw.shape[-1]
    j = 0 if deltas.node_ids is None else deltas.node_ids.shape[-1]
    dev = states.strengths.device
    if dev.type != "cuda":
        raise ValueError(f"stream_tick kernel needs CUDA tensors, got {dev}")
    rows = int(torch.Size(lead).numel())
    st = [getattr(states, f) for f in _STATE_FIELDS]
    dl = [deltas.senders, deltas.receivers, deltas.dw, deltas.w_old,
          deltas.mask]
    slots = [] if j == 0 else [deltas.node_ids, deltas.node_flag]
    f32, i32 = torch.float32, torch.int32
    dispatch.check_operands("stream_tick", dev, [
        *((f, t, lead, f32) for f, t in zip(_STATE_FIELDS[:3], st[:3])),
        *((f, t, (*lead, n), f32)
          for f, t in zip(_STATE_FIELDS[3:], st[3:])),
        *(("delta", t, (*lead, k), dtype)
          for t, dtype in zip(dl, (i32, i32, f32, f32, f32))),
        *(("node slot", t, (*lead, j), dtype)
          for t, dtype in zip(slots, (i32, f32)))])
    dispatch.check_smem("stream_tick", k, j, dev)
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    warps = warps_per_stream(rows, n, *_capacity(index, k, j))
    outs = st if inplace else [torch.empty_like(t) for t in st]
    dist = torch.empty(lead, dtype=torch.float32, device=dev)
    fn = dispatch.library()["stream_tick"].stream_tick_launch
    fn.argtypes = [_P] * 18 + [_I] * 6 + [_P]
    fn.restype = _I
    nid, nflag = (None, None) if j == 0 else (slots[0].data_ptr(),
                                                slots[1].data_ptr())
    with tracing.span("finger.tick.launch"):
        err = fn(*(t.data_ptr() for t in st + dl), nid, nflag,
                 dist.data_ptr(), *(t.data_ptr() for t in outs), rows, n,
                 k, j, int(bool(exact_smax)), warps,
                 dispatch.stream_handle(dev))
        dispatch.check_launch("stream_tick", err)
    LAUNCHES[name] += 1
    if warps > 1:
        SPLIT_LAUNCHES[name] += 1
    if inplace:
        return dist, states
    return dist, FingerState(*outs, layout=states.layout)


def _tick(name: str, states: FingerState, deltas: GraphDelta,
          exact_smax: bool, inplace: bool
          ) -> Tuple[torch.Tensor, FingerState]:
    if states.strengths.device.type == "cpu":
        dist, new = stream_tick_ref(states, deltas, exact_smax=exact_smax)
        return _copy_into(states, dist, new) if inplace else (dist, new)
    return _launch(name, states, deltas, exact_smax, inplace)


def stream_tick_fused(states: FingerState, deltas: GraphDelta,
                      exact_smax: bool = False, inplace: bool = False
                      ) -> Tuple[torch.Tensor, FingerState]:
    """One batched serving tick: (B,) JSdist scores + updated states."""
    _check_layout("stream_tick_fused", states, deltas)
    return _tick("stream_tick", states, deltas, exact_smax, inplace)


def stream_tick_fused_stacked(states: FingerState, deltas: GraphDelta,
                              exact_smax: bool = False,
                              inplace: bool = False
                              ) -> Tuple[torch.Tensor, FingerState]:
    """Shard-stacked tick over (S, B, ·) tensors: (S, B) scores and the
    updated stacked state, from one launch over S·B rows."""
    _check_layout("stream_tick_fused_stacked", states, deltas)
    if states.q.dim() != 2:
        raise ValueError(
            f"stream_tick_fused_stacked expects (S, B) stacked states, "
            f"got q of shape {tuple(states.q.shape)}")
    return _tick("stream_tick_stacked", states, deltas, exact_smax, inplace)
