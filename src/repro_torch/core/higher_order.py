"""Beyond-quadratic approximation of VNGE (the paper's §2.2 remark).

The port's copy of `repro.core.higher_order`, an implemented negative
result: truncating −x ln x = Σ_z (−1)^z/z · x(x−1)^z at z = 2 and
summing over the spectrum of L_N (Σλ = 1) gives

  Q₃ = Σ λ(1−λ) + ½ Σ λ(λ−1)²  =  3/2 − 2 Σλ² + ½ Σλ³

with Σλ² and Σλ³ from trace identities (one dense matmul). For the
balanced spectra where FINGER's guarantees hold (λ ~ 1/n) the cubic
term adds about +½, so Q₃ is a worse proxy than Q — which is why the
paper stops at the quadratic.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.core.vnge import strength_stats
from repro_torch.graphs.spectral import power_iteration_lmax
from repro_torch.graphs.types import DenseGraph, EdgeList

Graph = Union[DenseGraph, EdgeList]

# `strength_stats` is importable from here, as from the reference's
# module.
__all__ = ["cubic_q", "spectral_moments_3", "strength_stats", "vnge_hat3"]


def spectral_moments_3(g: DenseGraph):
    """(Σλ, Σλ², Σλ³) of L_N via trace identities (no eigendecomposition):
    trace(L²) = Σ_ij L_ij² and trace(L³) = Σ_ij (L²)_ij L_ij for the
    symmetric L, from one matmul."""
    w = g.weights
    s = w.sum(1)
    lap = torch.diag(s) - w
    tr = s.sum()
    c = torch.where(tr > 0, 1.0 / tr, 0.0)
    m2 = (lap * lap).sum()
    m3 = ((lap @ lap) * lap).sum()
    return 1.0, c * c * m2, c ** 3 * m3


def cubic_q(g: Graph) -> torch.Tensor:
    """Q₃: the third-order Taylor approximation of H."""
    if isinstance(g, EdgeList):
        g = g.to_dense()
    _, m2, m3 = spectral_moments_3(g)
    return 1.5 - 2.0 * m2 + 0.5 * m3


def vnge_hat3(g: Graph, lambda_max=None, power_iters: int = 100,
              x0=None) -> torch.Tensor:
    """Ĥ₃ = −Q₃ ln λ_max — eq. (1) with the cubic proxy; λ_max by power
    iteration (seed 0, or from ``x0``) unless given."""
    if isinstance(g, EdgeList):
        g = g.to_dense()
    q3 = cubic_q(g)
    if lambda_max is None:
        lambda_max = power_iteration_lmax(g, num_iters=power_iters, x0=x0)
    lam = torch.clamp(torch.as_tensor(lambda_max, device=q3.device),
                      1e-30, 1.0)
    return -q3 * torch.log(lam)
