"""Plain PyTorch version of the fused Theorem-2 delta statistics.

The reduction has one home — `repro_torch.core.incremental
.delta_stats_from_sorted` — re-exported here under the kernel suite's
ref naming. It takes the sorted-endpoint form of a GraphDelta (see
ops.py) and returns the (..., 4) stats

    [ΔS, ΔQ, max_{ΔV}(s_i + Δs_i), |ΔV|]

with the max -inf for an all-masked delta. The CPU tests run it, and
the card compares the CUDA kernel with it.
"""
from __future__ import annotations

from repro_torch.core.incremental import delta_stats_from_sorted

delta_stats_sorted_ref = delta_stats_from_sorted

__all__ = ["delta_stats_sorted_ref"]
