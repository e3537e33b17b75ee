"""VNGE heuristics on other Laplacians (the paper's last two baselines),
both without approximation guarantees.

- VNGE-NL (Han et al., 2012): the normalized Laplacian's quadratic
  approximation H_NL ≈ 1 − 1/n − (1/n²) Σ_{(u,v)∈E} w_uv²/(s_u s_v).
- VNGE-GL (Ye et al., 2014): the generalized Laplacian's, which for
  undirected inputs reduces to
  H_GL ≈ 1 − 1/n − (1/(2n²)) Σ_{(u,v)∈E} [1/(s_u s_v) + w_uv²/s_u²].
"""
from __future__ import annotations

import torch

from repro_torch.graphs.types import DenseGraph


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, 1.0 / torch.clamp(x, min=1e-30), 0.0)


def vnge_nl(g: DenseGraph) -> torch.Tensor:
    w, n = g.weights, g.n_nodes
    inv_s = _safe_inv(w.sum(1))
    # Σ over ordered pairs counts each undirected edge twice → ½
    pair_term = 0.5 * ((w * w) * inv_s[:, None] * inv_s[None, :]).sum()
    return 1.0 - 1.0 / n - (1.0 / (n * n)) * pair_term


def vnge_gl(g: DenseGraph) -> torch.Tensor:
    w, n = g.weights, g.n_nodes
    inv_s = _safe_inv(w.sum(1))
    adj = (w > 0).to(w.dtype)
    cross = 0.5 * (adj * inv_s[:, None] * inv_s[None, :]).sum()
    self_term = 0.5 * ((w * w) * (inv_s ** 2)[:, None]).sum()
    return 1.0 - 1.0 / n - (1.0 / (2.0 * n * n)) * (cross + self_term)


def vnge_variant_score(g1: DenseGraph, g2: DenseGraph, kind: str = "nl"):
    """Anomaly score per paper supplement J: |H(G2) − H(G1)|."""
    fn = vnge_nl if kind == "nl" else vnge_gl
    return (fn(g2) - fn(g1)).abs()
