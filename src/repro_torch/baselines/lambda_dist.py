"""λ-distance (Bunke et al. 2007; Wilson & Zhu 2008): the Euclidean
distance between the top-k eigenvalues of W ("adj") or of the
combinatorial Laplacian L ("lap"). The paper uses k = 6."""
from __future__ import annotations

import torch

from repro_torch.graphs.laplacian import laplacian_dense
from repro_torch.graphs.types import DenseGraph


def _topk_eigs(mat: torch.Tensor, k: int) -> torch.Tensor:
    return torch.linalg.eigvalsh(mat)[-k:].flip(0)  # eigvalsh: ascending


def lambda_distance(g1: DenseGraph, g2: DenseGraph, k: int = 6,
                    matrix: str = "adj") -> torch.Tensor:
    if matrix == "adj":
        m1, m2 = g1.weights, g2.weights
    elif matrix == "lap":
        m1, m2 = laplacian_dense(g1), laplacian_dense(g2)
    else:
        raise ValueError(f"unknown matrix {matrix!r}")
    return torch.sqrt(((_topk_eigs(m1, k) - _topk_eigs(m2, k)) ** 2).sum())
