"""Graph edit distance for undirected unweighted graphs on a common node
set (Bunke et al. 2007): the edge additions plus removals that turn G1
into G2."""
from __future__ import annotations

import torch

from repro_torch.graphs.types import DenseGraph


def graph_edit_distance(g1: DenseGraph, g2: DenseGraph) -> torch.Tensor:
    a1 = (g1.weights > 0).to(torch.float32)
    a2 = (g2.weights > 0).to(torch.float32)
    return 0.5 * (a1 - a2).abs().sum()  # each undirected edge once
