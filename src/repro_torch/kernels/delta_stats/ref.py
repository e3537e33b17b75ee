"""Plain PyTorch versions of the fused Theorem-2 delta statistics.

The reduction has one home — `repro_torch.core.incremental
.delta_stats_from_sorted` — re-exported here under the kernel suite's
ref naming as `delta_stats_sorted_ref`. It takes the sorted-endpoint
form of a GraphDelta (the JAX kernel's contract, see ops.py) and
returns the (..., 4) stats

    [ΔS, ΔQ, max_{ΔV}(s_i + Δs_i), |ΔV|]

with the max -inf for an all-masked delta. `delta_stats_gated_ref`
builds that form from the gated delta and reduces it: the plain version
of the CUDA kernel, which takes the gated delta itself. The CPU tests
run both, and the card compares the kernel with the second.
"""
from __future__ import annotations

import torch

from repro_torch.core.incremental import (delta_stats_from_sorted,
                                          sorted_delta_endpoints)
from repro_torch.graphs.types import GraphDelta

delta_stats_sorted_ref = delta_stats_from_sorted


def delta_stats_gated_ref(strengths: torch.Tensor,
                          delta: GraphDelta) -> torch.Tensor:
    """(..., n) strengths and a gated delta → (..., 4) stats."""
    return delta_stats_from_sorted(
        *sorted_delta_endpoints(strengths, delta), delta.dw * delta.mask,
        delta.w_old)


__all__ = ["delta_stats_gated_ref", "delta_stats_sorted_ref"]
