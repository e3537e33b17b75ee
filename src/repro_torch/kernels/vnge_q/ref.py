"""Plain PyTorch version of the fused Lemma-1 reduction over a dense W.

The port's copy of `repro.kernels.vnge_q.ref`. It returns the four
sufficient statistics

    [S, Σ s_i², Σ_E w_ij² (= ½ Σ_ij W_ij²), s_max]

of a symmetric (n, n) W with row sums s. The CPU tests run it, and the
card compares the CUDA kernel with it.
"""
from __future__ import annotations

import torch


def vnge_q_stats_ref(w: torch.Tensor) -> torch.Tensor:
    """w: (n, n) → (4,) f32 [S, Σs², Σ_E w², s_max]."""
    w = w.float()
    s = w.sum(1)
    return torch.stack([s.sum(), (s * s).sum(), 0.5 * (w * w).sum(),
                        s.max()])


def q_from_stats(stats: torch.Tensor) -> torch.Tensor:
    """Lemma 1's Q from the (…, 4) statistics ``[S, Σs², Σ_E w², s_max]``."""
    from repro_torch.core.vnge import _lemma1_cq  # deferred: kernels ← core

    return _lemma1_cq(stats[..., 0], stats[..., 1], stats[..., 2])[1]
