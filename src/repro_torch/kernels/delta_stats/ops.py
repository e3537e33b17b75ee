"""Public op: fused compact Theorem-2 delta statistics.

`prepare_sorted_delta` lowers a GraphDelta plus the carried strengths to
the sorted-endpoint form (torch.sort and an O(Δn) gather, as the JAX
package argsorts in XLA before its kernel). `delta_stats_fused` then
reduces it:

- tensors on a CUDA device go to the hand-written kernel
  (`csrc/delta_stats.cu`, which replaces the TPU kernel
  `delta_stats_sorted_pallas`); a launch CUDA refuses raises;
- tensors on the CPU go to the plain version (`ref.py`).

The kernel takes every delta size: it reads each endpoint from device
memory once and keeps no (2k, 2k) temporary, so the JAX package's
routing of large deltas to its reference path has no counterpart here.
Rows with leading batch axes are reduced one block per row.

``LAUNCHES`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.core.incremental import (gate_delta_for_update,
                                          sorted_delta_endpoints)
from repro_torch.core.state import FingerState
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.kernels.delta_stats.ref import delta_stats_sorted_ref

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def prepare_sorted_delta(strengths: torch.Tensor, delta: GraphDelta):
    """GraphDelta → the kernel's six inputs: sorted ids, sorted Δw,
    sorted strengths, endpoint validity, masked Δw, w_old."""
    prep = sorted_delta_endpoints(strengths, delta)
    return (*prep, delta.dw * delta.mask, delta.w_old)


def delta_stats_sorted_cuda(sorted_nodes, sorted_vals, sorted_strengths,
                            endpoint_valid, dw, w_old) -> torch.Tensor:
    """Launch the CUDA kernel on the sorted-endpoint form → (..., 4)."""
    global LAUNCHES
    two_k = sorted_nodes.shape[-1]
    k = dw.shape[-1]
    lead = sorted_nodes.shape[:-1]
    if two_k != 2 * k:
        raise ValueError(f"delta_stats: {two_k} endpoints for {k} edges")
    ints = [sorted_nodes]
    floats = [sorted_vals, sorted_strengths, endpoint_valid, dw, w_old]
    dev = sorted_nodes.device
    if dev.type != "cuda":
        raise ValueError(f"delta_stats kernel needs CUDA tensors, got {dev}")
    for t in ints + floats:
        if t.device != dev or t.shape[:-1] != lead:
            raise ValueError("delta_stats: inputs disagree on device or "
                             "leading shape")
    if sorted_nodes.dtype != torch.int32 \
            or any(t.dtype != torch.float32 for t in floats):
        raise TypeError("delta_stats: ids must be int32 and values float32")
    args = [t.contiguous() for t in ints + floats]
    rows = int(torch.Size(lead).numel())
    out = torch.empty((*lead, 4), dtype=torch.float32, device=dev)
    fn = dispatch.library()["delta_stats"].delta_stats_sorted_launch
    fn.argtypes = [_P] * 7 + [_I] * 3 + [_P]
    fn.restype = _I
    err = fn(*(t.data_ptr() for t in args), out.data_ptr(), rows, two_k,
             k, dispatch.stream_handle(dev))
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
    prep = prepare_sorted_delta(state.strengths, delta)
    if state.strengths.device.type == "cpu":
        stats = delta_stats_sorted_ref(*prep)
    else:
        stats = delta_stats_sorted_cuda(*prep)
    return stats[..., 0], stats[..., 1], stats[..., 2]
