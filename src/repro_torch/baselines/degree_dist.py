"""Distances between degree distributions (paper supplement N):
cosine, Bhattacharyya, Hellinger. KL is excluded (support mismatch), as
in the paper."""
from __future__ import annotations

import torch

from repro_torch.graphs.types import DenseGraph


def _degree_hist(g: DenseGraph, n_bins: int) -> torch.Tensor:
    deg = (g.weights > 0).to(torch.float32).sum(1)
    idx = torch.clamp(deg.long(), 0, n_bins - 1)
    hist = torch.zeros((n_bins,), dtype=torch.float32,
                       device=g.weights.device)
    hist.index_add_(0, idx, torch.ones_like(deg))
    return hist / torch.clamp(hist.sum(), min=1.0)


def cosine_distance(g1: DenseGraph, g2: DenseGraph, n_bins: int = 256):
    p, q = _degree_hist(g1, n_bins), _degree_hist(g2, n_bins)
    denom = torch.clamp(torch.linalg.norm(p) * torch.linalg.norm(q),
                        min=1e-30)
    return 1.0 - torch.dot(p, q) / denom


def bhattacharyya_distance(g1: DenseGraph, g2: DenseGraph, n_bins: int = 256):
    p, q = _degree_hist(g1, n_bins), _degree_hist(g2, n_bins)
    bc = torch.sqrt(p * q).sum()
    return -torch.log(torch.clamp(bc, 1e-30, 1.0))


def hellinger_distance(g1: DenseGraph, g2: DenseGraph, n_bins: int = 256):
    p, q = _degree_hist(g1, n_bins), _degree_hist(g2, n_bins)
    return torch.sqrt(torch.clamp(
        0.5 * ((torch.sqrt(p) - torch.sqrt(q)) ** 2).sum(), min=0.0))
