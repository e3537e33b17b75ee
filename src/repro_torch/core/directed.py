"""Directed-graph VNGE — the paper's declared future work.

The port's copy of `repro.core.directed`. After Chung (2005) / Ye et
al. (2014), the generalized Laplacian of a strongly connected directed
graph uses the stationary distribution φ of the random walk P
(P_ij = w_ij / s_i^out):

  L̃ = I − (Φ^{1/2} P Φ^{-1/2} + Φ^{-1/2} Pᵀ Φ^{1/2}) / 2,  Φ = diag(φ)

The density matrix is L̃ / trace(L̃), H_dir = −Σ λ ln λ, and the
quadratic proxy Q_dir = 1 − trace(L̃_N²). The reference's ``fori_loop``s
are fixed-count loops here, with no host sync.
"""
from __future__ import annotations

import torch


def _stationary(p: torch.Tensor, iters: int = 200) -> torch.Tensor:
    """Power iteration for the stationary distribution of row-stochastic P."""
    n = p.shape[0]
    phi = torch.full((n,), 1.0 / n, dtype=p.dtype, device=p.device)
    for _ in range(iters):
        phi = phi @ p
        phi = phi / torch.clamp(phi.sum(), min=1e-30)
    return phi


def generalized_laplacian(w: torch.Tensor,
                          teleport: float = 1e-3) -> torch.Tensor:
    """Chung's directed Laplacian with light teleportation for
    irreducibility (keeps L̃ well defined on graphs that are not strongly
    connected)."""
    n = w.shape[0]
    s_out = w.sum(1)[:, None]
    p = torch.where(s_out > 0, w / torch.clamp(s_out, min=1e-30), 1.0 / n)
    p = (1.0 - teleport) * p + teleport / n
    sq = torch.sqrt(torch.clamp(_stationary(p), min=1e-30))
    m = sq[:, None] * p / sq[None, :]
    return torch.eye(n, dtype=w.dtype, device=w.device) - 0.5 * (m + m.T)


def _density(w: torch.Tensor) -> torch.Tensor:
    lap = generalized_laplacian(w)
    return lap / torch.clamp(torch.trace(lap), min=1e-30)


def directed_vnge(w: torch.Tensor) -> torch.Tensor:
    """Exact directed VNGE via eigendecomposition of L̃_N."""
    ev = torch.clamp(torch.linalg.eigvalsh(_density(w)), min=0.0)
    safe = torch.where(ev > 0, ev, 1.0)
    return -torch.where(ev > 0, ev * torch.log(safe), 0.0).sum()


def directed_quadratic_q(w: torch.Tensor) -> torch.Tensor:
    """Q = 1 − trace(L̃_N²) — one matmul-free pass (L̃ is symmetric)."""
    ln = _density(w)
    return 1.0 - (ln * ln).sum()


def directed_vnge_hat(w: torch.Tensor, power_iters: int = 200
                      ) -> torch.Tensor:
    """Ĥ for directed graphs: −Q ln λ_max, λ_max by a fixed count of
    power iterations on L̃_N from the uniform unit vector."""
    ln = _density(w)
    n = w.shape[0]
    x = torch.ones((n,), dtype=w.dtype, device=w.device) / n ** 0.5
    for _ in range(power_iters):
        y = ln @ x
        x = y / torch.clamp(torch.linalg.norm(y), min=1e-30)
    lam = torch.clamp(torch.dot(x, ln @ x), 1e-30, 1.0)
    return -directed_quadratic_q(w) * torch.log(lam)
