"""Theorem 1 sandwich bounds and the scaled approximation error (SAE).

The port's copy of `repro.core.bounds`. Theorem 1: if λ_max < 1 (any
graph with a connected ≥3-node subgraph),

    -Q ln(λ_max)/(1 - λ_min)  ≤  H  ≤  -Q ln(λ_min)/(1 - λ_max)

with equality (and H = ln(n-1)) for complete graphs with equal weights.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from repro_torch.core.vnge import quadratic_q
from repro_torch.graphs.spectral import lmax_lmin_positive
from repro_torch.graphs.types import DenseGraph, EdgeList

Graph = Union[DenseGraph, EdgeList]


def theorem1_bounds(g: Graph) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lower, upper) bounds on H from Theorem 1 (exact λ_max, λ_min⁺)."""
    q = quadratic_q(g)
    lam_max, lam_min = lmax_lmin_positive(g)
    lam_max = torch.clamp(lam_max, 1e-30, 1.0 - 1e-12)
    lam_min = torch.clamp(lam_min, 1e-30, 1.0 - 1e-12)
    lower = -q * torch.log(lam_max) / (1.0 - lam_min)
    upper = -q * torch.log(lam_min) / (1.0 - lam_max)
    return lower, upper


def scaled_approximation_error(h_exact, h_approx, n: int):
    """SAE = (H - X)/ln n for X ∈ {Ĥ, H̃} — the paper's Fig. 2 metric."""
    return (h_exact - h_approx) / math.log(float(n))
