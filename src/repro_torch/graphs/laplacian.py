"""Combinatorial graph Laplacian operators (dense and matrix-free).

The port's copy of `repro.graphs.laplacian`. The edge-list matvec is two
``index_add_`` calls over the edges, the counterpart of the reference's
XLA scatters; no kernel is involved, as none is in the reference.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from repro_torch.graphs.types import DenseGraph, EdgeList, in_range

Graph = Union[DenseGraph, EdgeList]


def laplacian_dense(g: DenseGraph) -> torch.Tensor:
    """L = S - W (inactive node slots contribute zero rows/columns)."""
    return torch.diag(g.strengths()) - g.masked_weights()


def trace_l(g: Graph) -> torch.Tensor:
    """trace(L) = Σ_i s_i = 2 Σ_E w_ij."""
    if isinstance(g, DenseGraph):
        return g.masked_weights().sum()
    return 2.0 * g.masked_weights().sum()


def normalized_laplacian_dense(g: DenseGraph) -> torch.Tensor:
    """L_N = L / trace(L) — the density matrix of the paper."""
    lap = laplacian_dense(g)
    return lap / torch.trace(lap)


def laplacian_matvec(g: Graph) -> Callable[[torch.Tensor], torch.Tensor]:
    """Matrix-free x ↦ L x, O(n + m) for edge lists, O(n²) dense."""
    s = g.strengths()
    if isinstance(g, DenseGraph):
        w_dense = g.masked_weights()
        return lambda x: s * x - w_dense @ x

    # (W x)_i = Σ_j w_ij x_j; undirected edges stored once. Lanes with an
    # out-of-range endpoint carry weight 0 (`masked_weights`) and index
    # node 0, so they add nothing.
    n = g.n_nodes
    w = g.masked_weights()
    ok = in_range(g.senders, n) & in_range(g.receivers, n)
    snd = torch.where(ok, g.senders, 0).long()
    rcv = torch.where(ok, g.receivers, 0).long()

    def mv_sparse(x):
        wx = torch.zeros_like(x)
        wx.index_add_(0, snd, w * x[rcv])
        wx.index_add_(0, rcv, w * x[snd])
        return s * x - wx

    return mv_sparse
