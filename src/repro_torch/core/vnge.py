"""Von Neumann graph entropy: exact H, Lemma-1 Q, FINGER-Ĥ, FINGER-H̃.

The port's copy of `repro.core.vnge`:

  H(G)  = -Σ_i λ_i ln λ_i,   λ_i eigenvalues of L_N = L / trace(L)
  Q     = 1 - c² (Σ_i s_i² + 2 Σ_E w_ij²),  c = 1/trace(L)   [Lemma 1]
  Ĥ(G)  = -Q ln λ_max                                         [eq. (1)]
  H̃(G)  = -Q ln(2 c s_max)                                    [eq. (2)]

The eigen-free functions accept graphs with leading batch axes;
`exact_vnge` and `vnge_hat` take one graph and a ``device=`` (``None``:
where the graph lies; ``cuda`` without a card raises).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.graphs.spectral import exact_eigvals_ln, \
    power_iteration_lmax
from repro_torch.graphs.types import DenseGraph, EdgeList, on_device
from repro_torch.kernels.dispatch import Device

Graph = Union[DenseGraph, EdgeList]

__all__ = ["c_from_s_total", "exact_vnge", "h_tilde_from_stat_vector",
           "quadratic_q", "strength_stats", "vnge_hat", "vnge_tilde"]


def c_from_s_total(s_total: torch.Tensor) -> torch.Tensor:
    """c = 1/trace(L) with the empty-graph convention c(0) = 0."""
    safe = torch.where(s_total > 0, s_total, torch.ones_like(s_total))
    return torch.where(s_total > 0, 1.0 / safe, torch.zeros_like(s_total))


def _xlogx(x: torch.Tensor) -> torch.Tensor:
    """x ln x with the 0 ln 0 = 0 convention."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, x * torch.log(safe), 0.0)


def exact_vnge(g: Graph, device: Device = None) -> torch.Tensor:
    """Exact H(G) = -Σ λ_i ln λ_i via full eigendecomposition (O(n³))."""
    # clamp: eigvalsh leaves noise below zero
    ev = torch.clamp(exact_eigvals_ln(on_device(g, device)), min=0.0)
    return -_xlogx(ev).sum()


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


def vnge_hat(g: Graph, lambda_max: Optional[torch.Tensor] = None,
             power_iters: int = 100, tol: float = 1e-7, x0=None,
             device: Device = None) -> torch.Tensor:
    """FINGER-Ĥ (eq. 1): Ĥ = -Q ln λ_max, λ_max via power iteration
    (`power_iteration_lmax`, seed 0, or from ``x0``) unless given.

    O(n + m): Q is a single pass, λ_max costs ``power_iters`` matvecs.
    """
    g = on_device(g, device)
    s_total, sum_s2, sum_w2, _ = strength_stats(g)
    _, q = _lemma1_cq(s_total, sum_s2, sum_w2)
    if lambda_max is None:
        lambda_max = power_iteration_lmax(g, num_iters=power_iters, tol=tol,
                                          x0=x0)
    lam = torch.clamp(torch.as_tensor(lambda_max, device=q.device),
                      1e-30, 1.0)
    # Empty graph (trace L = 0): L_N is undefined and H = 0 by convention;
    # without the guard the clipped log yields ≈69 nats.
    return torch.where(s_total > 0, -q * torch.log(lam), 0.0)


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
