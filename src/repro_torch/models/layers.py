"""Shared neural layers: norms, RoPE, gated MLPs, embeddings, softcaps.

The port's copy of `repro.models.layers`, op for op in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             upcast: bool = True) -> torch.Tensor:
    dt = x.dtype
    if upcast:
        x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(y.dtype))).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32, cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style soft capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, D/2) over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: down( act(x·gate) ∘ (x·up) ). GeGLU when act='gelu'."""
    g = x @ w_gate
    u = x @ w_up
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return (a * u) @ w_down


def embed(tokens: torch.Tensor, table: torch.Tensor,
          scale_by_dim: bool = False) -> torch.Tensor:
    x = table[tokens.long()]
    if scale_by_dim:
        x = x * torch.sqrt(torch.tensor(float(table.shape[-1]),
                                        dtype=x.dtype, device=x.device))
    return x


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table (V, D)."""
    return x @ table.T


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Token-level CE with an f32 log-sum-exp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - picked
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
