"""Public op: fused compact Theorem-2 delta statistics.

`delta_stats_fused` reduces a gated GraphDelta plus the carried
strengths to ``(ΔS, ΔQ, max_{ΔV}(s_i + Δs_i))``:

- tensors on a CUDA device go to one launch of the hand-written kernel
  (`csrc/delta_stats.cu`, which replaces the TPU kernel
  `delta_stats_sorted_pallas` and the preparation before it): it builds
  the endpoint keys, sorts them and reduces the segments itself, one
  warp a stream, so no torch op runs around it but the output's
  allocation; a launch CUDA refuses raises;
- tensors on the CPU go to the plain version
  (`ref.delta_stats_gated_ref`).

The route on the card is chosen by k (the delta's edge lanes) alone:
k ≤ 8192 (`max_fused_k`, the library's ``delta_stats_max_k``: 2k sort
keys fit one block's shared memory) is the one launch; above it the
sorted-endpoint route, `prepare_sorted_delta` (torch's stable argsort
and gathers, as the JAX package argsorts in XLA before its kernel) and
the sorted-form kernel `delta_stats_sorted_cuda`, which has no size
ceiling. Rows with leading batch axes are reduced one a stream on both
routes.

``LAUNCHES`` counts kernel launches, one a call on either route (never
plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.core.incremental import (gate_delta_for_update,
                                          sorted_delta_endpoints)
from repro_torch.core.state import FingerState
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.kernels.delta_stats.ref import delta_stats_gated_ref

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCH_ARGS = (_P,) * 7 + (_I,) * 3 + (_P,)


@functools.lru_cache(maxsize=None)
def max_fused_k() -> int:
    """The largest k the one-launch kernel takes (8192)."""
    return int(dispatch.bind("delta_stats", "delta_stats_max_k", ())())


def prepare_sorted_delta(strengths: torch.Tensor, delta: GraphDelta):
    """GraphDelta → the sorted-form kernel's six inputs: sorted ids,
    sorted Δw, sorted strengths, endpoint validity, masked Δw, w_old."""
    prep = sorted_delta_endpoints(strengths, delta)
    return (*prep, delta.dw * delta.mask, delta.w_old)


def delta_stats_sorted_cuda(sorted_nodes, sorted_vals, sorted_strengths,
                            endpoint_valid, dw, w_old) -> torch.Tensor:
    """Launch the sorted-form kernel (the route above `max_fused_k`)
    → (..., 4)."""
    global LAUNCHES
    two_k = sorted_nodes.shape[-1]
    k = dw.shape[-1]
    lead = tuple(sorted_nodes.shape[:-1])
    dev = sorted_nodes.device
    if dev.type != "cuda":
        raise ValueError(f"delta_stats kernel needs CUDA tensors, got {dev}")
    if two_k != 2 * k:
        raise ValueError(f"delta_stats: {two_k} endpoints for {k} edges")
    f32 = torch.float32
    dispatch.check_operands("delta_stats", dev, [
        ("sorted ids", sorted_nodes, (*lead, two_k), torch.int32),
        *((label, t, (*lead, two_k), f32) for label, t in (
            ("sorted dw", sorted_vals), ("sorted strengths",
                                         sorted_strengths),
            ("endpoint validity", endpoint_valid))),
        ("dw", dw, (*lead, k), f32), ("w_old", w_old, (*lead, k), f32)])
    out = torch.empty((*lead, 4), dtype=f32, device=dev)
    fn = dispatch.bind("delta_stats", "delta_stats_sorted_launch",
                       _LAUNCH_ARGS)
    err = fn(sorted_nodes.data_ptr(), sorted_vals.data_ptr(),
             sorted_strengths.data_ptr(), endpoint_valid.data_ptr(),
             dw.data_ptr(), w_old.data_ptr(), out.data_ptr(),
             math.prod(lead), two_k, k, dispatch.stream_handle(dev))
    dispatch.check_launch("delta_stats", err)
    LAUNCHES += 1
    return out


def delta_stats_cuda(strengths: torch.Tensor,
                     delta: GraphDelta) -> torch.Tensor:
    """(..., n) strengths and a gated delta on the card → (..., 4)
    ``[ΔS, ΔQ, max, |ΔV|]``: one launch for k ≤ `max_fused_k`, the
    sorted-form route above."""
    global LAUNCHES
    dev = strengths.device
    if dev.type != "cuda":
        raise ValueError(f"delta_stats kernel needs CUDA tensors, got {dev}")
    *lead, n = strengths.shape
    k = delta.dw.shape[-1]
    if k > max_fused_k():
        return delta_stats_sorted_cuda(*prepare_sorted_delta(strengths,
                                                             delta))
    edges = (*lead, k)
    f32, i32 = torch.float32, torch.int32
    dispatch.check_operands("delta_stats", dev, [
        ("senders", delta.senders, edges, i32),
        ("receivers", delta.receivers, edges, i32),
        ("dw", delta.dw, edges, f32), ("w_old", delta.w_old, edges, f32),
        ("mask", delta.mask, edges, f32),
        ("strengths", strengths, (*lead, n), f32)])
    out = torch.empty((*lead, 4), dtype=f32, device=dev)
    fn = dispatch.bind("delta_stats", "delta_stats_launch", _LAUNCH_ARGS)
    err = fn(delta.senders.data_ptr(), delta.receivers.data_ptr(),
             delta.dw.data_ptr(), delta.w_old.data_ptr(),
             delta.mask.data_ptr(), strengths.data_ptr(), out.data_ptr(),
             math.prod(lead), n, k, dispatch.stream_handle(dev))
    dispatch.check_launch("delta_stats", err)
    LAUNCHES += 1
    return out


def delta_stats_fused(state: FingerState, delta: GraphDelta,
                      pre_gated: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ΔS, ΔQ, max_{ΔV}(s_i + Δs_i)) through the fused reduction.

    Delta edges touching nodes inactive under the state's post-join
    mask are gated to zero first; ``pre_gated=True`` skips that for
    callers that already hold the gated delta (`update_state`).
    """
    if not pre_gated:
        delta, _ = gate_delta_for_update(state.node_mask, delta)
    if state.strengths.device.type == "cpu":
        stats = delta_stats_gated_ref(state.strengths, delta)
    else:
        stats = delta_stats_cuda(state.strengths, delta)
    d_s, d_q, max_new, _ = stats.unbind(-1)
    return d_s, d_q, max_new
