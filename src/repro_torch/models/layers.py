"""Shared neural layers: norms, RoPE, gated MLPs, embeddings, softcaps.

The port's copy of `repro.models.layers`, op for op in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map


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


def promoted(*xs):
    """The tensors cast to their common dtype where they differ (JAX
    promotes a bf16 × f32 product to f32; torch's matmul refuses)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x if x.dtype == dt else x.to(dt) for x in xs)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w (K, N)``; on DTensors a Megatron layout, mesh
    axis by mesh axis, under `local_map`:

    - x split by batch: x keeps it and w is gathered (FSDP at rest);
    - else w split along N (column parallel): the output splits its last
      axis;
    - else w split along K (row parallel): x splits its last axis to
      match and the output is a partial sum;
    - else replicated.

    DTensor's own choice op by op may gather w whole instead, and then
    every rank computes the full product.
    """
    x, w = promoted(x, w)
    if not isinstance(x, DTensor):
        return x @ w

    last = x.ndim - 1
    x_in, w_in, out, x_grad, w_grad = [], [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Shard) and xp.dim == 0:
            lay = (Shard(0), Replicate(), Shard(0), Shard(0), Partial())
        elif isinstance(wp, Shard) and wp.dim == 1:
            lay = (Replicate(), Shard(1), Shard(last), Partial(), Shard(1))
        elif isinstance(wp, Shard) and wp.dim == 0:
            lay = (Shard(last), Shard(0), Partial(), Shard(last), Shard(0))
        else:
            lay = (Replicate(),) * 5
        for acc, pl in zip((x_in, w_in, out, x_grad, w_grad), lay):
            acc.append(pl)
    fn = local_map(lambda a, b: a @ b, out_placements=out,
                   in_placements=(x_in, w_in),
                   in_grad_placements=(x_grad, w_grad),
                   device_mesh=x.device_mesh, redistribute_inputs=True)
    return fn(x, w)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: down( act(x·gate) ∘ (x·up) ). GeGLU when act='gelu'."""
    g = matmul(x, w_gate)
    u = matmul(x, w_up)
    a = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return matmul(a * u, w_down)


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on DTensors a vocabulary-parallel lookup under
    `local_map`: the tokens keep their batch split, the table is
    gathered over its FSDP split, and where a mesh axis splits the
    vocabulary each rank looks up the tokens in its own rows (zeros
    elsewhere) and the output is their partial sum."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]

    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = distribute_tensor(tokens, mesh,
                                   [Replicate()] * mesh.ndim,
                                   src_data_rank=None)
    t_in, w_in, out, w_grad, vocab = [], [], [], [], []
    for i, (tp, wp) in enumerate(zip(tokens.placements, table.placements)):
        if isinstance(tp, Shard) and tp.dim == 0:
            lay = (Shard(0), Replicate(), Shard(0), Partial())
        elif isinstance(wp, Shard) and wp.dim == 0:
            lay = (Replicate(), Shard(0), Partial(), Shard(0))
            vocab.append(i)
        else:
            lay = (Replicate(),) * 4
        for acc, pl in zip((t_in, w_in, out, w_grad), lay):
            acc.append(pl)
    coord, lo, n = mesh.get_coordinate(), 0, table.shape[0]
    for i in vocab:  # this rank's rows, torch.chunk's split
        block = -(-n // mesh.size(i))
        lo += coord[i] * block
        n = max(0, min(block, n - coord[i] * block))
    split = any(mesh.size(i) > 1 for i in vocab)

    def local(tok, w):
        if not split:
            return w[tok.long()]
        idx = tok.long() - lo
        ok = (idx >= 0) & (idx < w.shape[0])
        return w[torch.where(ok, idx, 0)] * ok[..., None].to(w.dtype)

    fn = local_map(local, out_placements=out, in_placements=(t_in, w_in),
                   in_grad_placements=(t_in, w_grad), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(tokens, table)


def embed(tokens: torch.Tensor, table: torch.Tensor,
          scale_by_dim: bool = False) -> torch.Tensor:
    x = lookup(table, tokens)
    if scale_by_dim:
        x = x * torch.sqrt(torch.tensor(float(table.shape[-1]),
                                        dtype=x.dtype, device=x.device))
    return x


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table (V, D)."""
    return matmul(x, table.T)


def _vocab_sharded(logits) -> bool:
    """A DTensor whose last (vocabulary) dimension is split over a mesh
    axis of more than one rank."""
    if not isinstance(logits, DTensor):
        return False
    mesh = logits.device_mesh
    return any(isinstance(p, Shard) and p.dim == logits.ndim - 1
               and mesh.size(i) > 1 for i, p in enumerate(logits.placements))


def _vocab_parallel_nll(logits, labels):
    """Per-token CE of vocabulary-sharded DTensor logits without
    gathering them: the max and the exp-sum reduce over the shards, and
    the label's logit is picked by comparing labels with a vocabulary
    index laid out as the logits' last dimension."""
    mesh = logits.device_mesh
    d = logits.ndim - 1
    m = logits.detach().amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    ids = distribute_tensor(
        torch.arange(logits.shape[-1], device=logits.to_local().device),
        mesh, [Shard(0) if isinstance(p, Shard) and p.dim == d
               else Replicate() for p in logits.placements],
        src_data_rank=None)  # every rank cuts its own slice
    hit = ids == labels.long()[..., None]
    picked = torch.where(hit, logits, 0.0).sum(-1)
    return lse - picked


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Token-level CE with an f32 log-sum-exp (on vocabulary-sharded
    DTensor logits, `_vocab_parallel_nll`)."""
    logits = logits.float()
    if _vocab_sharded(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - picked
    if mask is not None:
        nll = nll * mask
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
