"""Vertex/edge overlap (VEO) score (Papadimitriou et al., 2010):
VEO = 1 − 2(|V∩V'| + |E∩E'|) / (|V| + |V'| + |E| + |E'|) ∈ [0, 1].
Blind to edge-weight changes (the paper's argument on the Hi-C task)."""
from __future__ import annotations

import torch

from repro_torch.graphs.types import DenseGraph


def veo_score(g1: DenseGraph, g2: DenseGraph) -> torch.Tensor:
    a1 = (g1.weights > 0).to(torch.float32)
    a2 = (g2.weights > 0).to(torch.float32)
    e1, e2 = 0.5 * a1.sum(), 0.5 * a2.sum()
    e_common = 0.5 * (a1 * a2).sum()
    n = float(g1.n_nodes)  # a common fixed node set in the sequences
    return 1.0 - 2.0 * (n + e_common) / (n + n + e1 + e2)
