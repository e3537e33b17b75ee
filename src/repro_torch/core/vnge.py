"""Von Neumann graph entropy proxies: Lemma-1 Q and FINGER-H̃.

The port's copy of the eigen-free part of `repro.core.vnge`:

  Q     = 1 - c² (Σ_i s_i² + 2 Σ_E w_ij²),  c = 1/trace(L)   [Lemma 1]
  H̃(G)  = -Q ln(2 c s_max)                                    [eq. (2)]

Every function accepts graphs with leading batch axes.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.graphs.types import DenseGraph, EdgeList

Graph = Union[DenseGraph, EdgeList]

__all__ = ["c_from_s_total", "h_tilde_from_stat_vector", "quadratic_q",
           "strength_stats", "vnge_tilde"]


def c_from_s_total(s_total: torch.Tensor) -> torch.Tensor:
    """c = 1/trace(L) with the empty-graph convention c(0) = 0."""
    safe = torch.where(s_total > 0, s_total, torch.ones_like(s_total))
    return torch.where(s_total > 0, 1.0 / safe, torch.zeros_like(s_total))


def strength_stats(g: Graph):
    """(S = trace L, Σ s_i², Σ_E w_ij², s_max) over active nodes."""
    if isinstance(g, DenseGraph):
        w = g.masked_weights()
        s = w.sum(-1)
        # each undirected edge appears twice in W: Σ_E w² = ½ Σ_ij W_ij².
        return (s.sum(-1), (s * s).sum(-1),
                0.5 * (w * w).sum((-2, -1)), s.amax(-1))
    s = g.strengths()
    w = g.masked_weights()
    return s.sum(-1), (s * s).sum(-1), (w * w).sum(-1), s.amax(-1)


def _lemma1_cq(s_total, sum_s2, sum_w2):
    """(c, Q) from the strength statistics — the one home of Lemma 1."""
    c = c_from_s_total(s_total)
    return c, 1.0 - c * c * (sum_s2 + 2.0 * sum_w2)


def quadratic_q(g: Graph) -> torch.Tensor:
    """Lemma 1: Q = 1 - c² (Σ s_i² + 2 Σ_E w_ij²)."""
    s_total, sum_s2, sum_w2, _ = strength_stats(g)
    return _lemma1_cq(s_total, sum_s2, sum_w2)[1]


def h_tilde_from_stats(q, s_total, s_max,
                       empty_is_zero: bool = True) -> torch.Tensor:
    """eq. (2) from (Q, S, s_max). H̃ = 0 on an empty graph (S = 0);
    ``empty_is_zero=False`` keeps the unguarded -Q ln(1e-30) ≈ 69.08
    there, as the reference's telemetry closings do
    (`kernels/entropy_probe/ref.py::entropy_from_stats`,
    `train/telemetry.py::_h_tilde_dense`)."""
    c = c_from_s_total(s_total)
    h = -q * torch.log(torch.clamp(2.0 * c * s_max, min=1e-30))
    if not empty_is_zero:
        return h
    return torch.where(s_total > 0, h, torch.zeros_like(q))


def h_tilde_from_stat_vector(stats: torch.Tensor,
                             empty_is_zero: bool = True) -> torch.Tensor:
    """H̃ from the (…, 4) ``[S, Σs², Σ_E w², s_max]`` vectors that the
    ``vnge_q`` and ``entropy_probe`` kernels reduce to."""
    s_total, sum_s2, sum_w2, s_max = stats.unbind(-1)
    _, q = _lemma1_cq(s_total, sum_s2, sum_w2)
    return h_tilde_from_stats(q, s_total, s_max, empty_is_zero)


def vnge_tilde(g: Graph) -> torch.Tensor:
    """FINGER-H̃ (eq. 2): H̃ = -Q ln(2 c s_max). Eigen-free, O(n + m)."""
    s_total, sum_s2, sum_w2, s_max = strength_stats(g)
    _, q = _lemma1_cq(s_total, sum_s2, sum_w2)
    return h_tilde_from_stats(q, s_total, s_max)
