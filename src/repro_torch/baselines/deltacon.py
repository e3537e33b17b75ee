"""DeltaCon (Koutra et al., 2016) and its Matusita-distance variant RMD.

Node affinities by fast belief propagation, S = [I + ε² D − ε A]⁻¹,
then the root Euclidean (Matusita) distance
d(G1, G2) = sqrt(Σ_ij (sqrt(S1_ij) − sqrt(S2_ij))²) and the similarity
Sim_DC = 1 / (1 + d). Anomaly scores: DeltaCon = 1 − Sim_DC,
RMD = 1/Sim_DC − 1 = d.
"""
from __future__ import annotations

import torch

from repro_torch.graphs.types import DenseGraph


def _affinity(g: DenseGraph) -> torch.Tensor:
    a = g.weights
    d = a.sum(1)
    eye = torch.eye(g.n_nodes, dtype=a.dtype, device=a.device)
    # FaBP epsilon: small enough for convergence (the paper's heuristic)
    eps = 1.0 / (1.0 + d.max())
    m = eye + (eps * eps) * torch.diag(d) - eps * a
    return torch.linalg.solve(m, eye)


def _matusita(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    r1 = torch.sqrt(torch.clamp(s1, min=0.0))
    r2 = torch.sqrt(torch.clamp(s2, min=0.0))
    return torch.sqrt(((r1 - r2) ** 2).sum())


def deltacon_similarity(g1: DenseGraph, g2: DenseGraph) -> torch.Tensor:
    return 1.0 / (1.0 + _matusita(_affinity(g1), _affinity(g2)))


def deltacon_distance(g1: DenseGraph, g2: DenseGraph) -> torch.Tensor:
    """1 − Sim_DC, the anomaly score of the paper's Tables 2 and 3."""
    return 1.0 - deltacon_similarity(g1, g2)


def rmd_distance(g1: DenseGraph, g2: DenseGraph) -> torch.Tensor:
    """Matusita distance deduced from DeltaCon: 1/Sim_DC − 1."""
    return 1.0 / deltacon_similarity(g1, g2) - 1.0
