"""Attention: GQA projections, chunked attention (train/prefill) and
cached decode attention.

The port's copy of `repro.models.attention` for one device: no head
padding (the reference pads query heads only to a tensor-parallel
degree above 1) and no sharding constraints. `flash_attention` repeats
the reference's chunked online softmax (q chunks of 2048, kv chunks of
1024, every chunk pair computed and masked with -1e30, the GQA
expansion by the q-head → kv-head map) and `decode_attention` its
one-token attention against a `KVCache`, both in plain torch ops, as
the reference computes them in jnp outside any Pallas kernel.
`KVCache.logical_axes` (the TPU mesh's cache sharding) waits for the
model-sharding rules (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, softcap
from repro_torch.models.params import PDef, TensorSpec


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int  # query heads (the reference pads them only for TP > 1)
    n_kv: int
    head_dim: int


def attn_dims(cfg: ModelConfig) -> AttnDims:
    return AttnDims(n_q=cfg.n_heads, n_kv=cfg.n_kv_heads,
                    head_dim=cfg.head_dim)


def attn_param_defs(cfg: ModelConfig, n_layers: int):
    """Stacked (layer-axis-leading) attention params for `n_layers`."""
    d = cfg.d_model
    dims = attn_dims(cfg)
    L = n_layers
    defs = {
        "wq": PDef((L, d, dims.n_q, dims.head_dim),
                   ("layers", "embed", "heads", None)),
        "wk": PDef((L, d, dims.n_kv, dims.head_dim),
                   ("layers", "embed", None, None)),
        "wv": PDef((L, d, dims.n_kv, dims.head_dim),
                   ("layers", "embed", None, None)),
        "wo": PDef((L, dims.n_q, dims.head_dim, d),
                   ("layers", "heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = PDef((L, dims.n_q, dims.head_dim),
                          ("layers", "heads", None), init="zeros")
        defs["bk"] = PDef((L, dims.n_kv, dims.head_dim),
                          ("layers", None, None), init="zeros")
        defs["bv"] = PDef((L, dims.n_kv, dims.head_dim),
                          ("layers", None, None), init="zeros")
    return defs


def kv_expand_map(dims: AttnDims) -> list:
    """q-head → kv-head index."""
    return [i * dims.n_kv // dims.n_q for i in range(dims.n_q)]


def expand_kv(x: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """(B, S, Hkv, D) → (B, S, Hq, D) by `kv_expand_map`. Where Hq is a
    multiple of Hkv (every ported config) the map is i // (Hq/Hkv) and
    the expansion a broadcast, whose gradient is a sum in a fixed order;
    an index gather's gradient would scatter with atomics."""
    b, s, h, d = x.shape
    if dims.n_q % h == 0:
        rep = dims.n_q // h
        return x[:, :, :, None].expand(b, s, h, rep, d).reshape(
            b, s, dims.n_q, d)
    kmap = torch.tensor(kv_expand_map(dims), device=x.device)
    return x.index_select(2, kmap)


def qkv_project(p, x, positions, cfg: ModelConfig):
    """x (B, S, D) → q (B, S, Hq, hd), k/v (B, S, Hkv, hd), RoPE'd."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dims: AttnDims, *, causal: bool = True,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None,
                    q_chunk: int = 2048, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Chunked online-softmax attention: q (B, S, Hq, D), k/v (B, S_kv,
    Hkv, D) → (B, S, Hq, D). Never holds more than one (q_chunk,
    kv_chunk) score block per head."""
    b, s, hq, d = q.shape
    s_kv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s_kv)
    if s % q_chunk or s_kv % kv_chunk:
        raise ValueError(f"flash_attention: S={s}, S_kv={s_kv} must be "
                         f"multiples of the chunks ({q_chunk}, {kv_chunk})")
    k, v = expand_kv(k, dims), expand_kv(v, dims)
    outs = []
    for qi in range(s // q_chunk):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        gq = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, hq, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, hq, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, hq, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for ki in range(s_kv // kv_chunk):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            s_blk = torch.einsum("bqhd,bkhd->bhqk", q_blk, k[:, sl]) * scale
            if attn_softcap is not None:
                s_blk = softcap(s_blk, attn_softcap)
            gk = ki * kv_chunk + torch.arange(kv_chunk, device=q.device)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = mask & (gq[:, None] >= gk[None, :])
            if window is not None:
                mask = mask & (gq[:, None] - gk[None, :] < window)
            s_blk = torch.where(mask, s_blk, -1e30)
            m_new = torch.maximum(m, s_blk.amax(-1))
            p = torch.exp(s_blk - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype), v[:, sl])
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    return torch.cat(outs, dim=2).transpose(1, 2)  # (b, s, hq, d)


def attention_block(p, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Full train attention sublayer (projection → attention → W_o)."""
    q, k, v = qkv_project(p, x, positions, cfg)
    o = flash_attention(q, k, v, attn_dims(cfg), causal=causal,
                        window=window, attn_softcap=cfg.attn_softcap)
    return torch.einsum("bshd,hdm->bsm", o, p["wo"])


class KVCache(NamedTuple):
    """Decode-time KV cache for one layer group. k/v: (B, Hkv, S, D)."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def shape(cfg: ModelConfig, batch: int, length: int,
              dtype: torch.dtype = torch.bfloat16) -> TensorSpec:
        dims = attn_dims(cfg)
        return TensorSpec((batch, dims.n_kv, length, dims.head_dim), dtype)


def decode_attention(p, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg: ModelConfig, *, window: Optional[int] = None,
                     attn_softcap_val: Optional[float] = None):
    """One-token attention against the cache: x (B, 1, D) at position
    ``pos`` (a host int) → (out (B, 1, D), cache).

    The new key and value are cast to the cache's dtype and written into
    ``cache`` in place at ``pos`` (a window cache is a ring buffer: at
    ``pos % S``, every slot valid once ``pos >= S``), and the same
    `KVCache` is returned. As in the reference, f32 queries meet the
    cache promoted to f32 (JAX's type promotion; `torch.einsum` does not
    promote), and the softmax is cast to the cache's dtype before the
    value product, so a bf16 cache gives a bf16-rounded attention
    output. A full (not windowed) cache refuses ``pos >= S``, where the
    reference's ``dynamic_update_slice`` clamps the write to slot S-1.
    """
    dims = attn_dims(cfg)
    b = x.shape[0]
    s_len = cache.k.shape[2]
    if window is None and not 0 <= pos < s_len:
        raise ValueError(f"decode_attention: pos {pos} outside the "
                         f"cache's {s_len} slots")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = qkv_project(p, x, positions, cfg)
    write_at = pos % s_len if window is not None else pos
    cache.k[:, :, write_at] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, :, write_at] = v_new[:, 0].to(cache.v.dtype)

    scale = 1.0 / math.sqrt(dims.head_dim)
    idx = torch.arange(s_len, device=x.device)
    if window is not None and pos >= s_len:  # ring buffer: all valid
        valid = torch.ones_like(idx, dtype=torch.bool)
    else:
        valid = idx <= write_at
    k_c = cache.k.float()  # where JAX promotes the cache operand
    if dims.n_q % dims.n_kv == 0:
        # grouped GQA decode: q-head groups against their kv head
        g, r = dims.n_kv, dims.n_q // dims.n_kv
        qg = q[:, 0].reshape(b, g, r, dims.head_dim)
        scores = torch.einsum("bgrd,bgkd->bgrk", qg, k_c) * scale
        scores = softcap(scores, attn_softcap_val)
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out_h = torch.einsum("bgrk,bgkd->bgrd", probs.to(cache.v.dtype),
                             cache.v).reshape(b, dims.n_q, dims.head_dim)
    else:
        kmap = torch.tensor(kv_expand_map(dims), device=x.device)
        k_full = k_c.index_select(1, kmap)  # (B, Hq, S, D)
        v_full = cache.v.index_select(1, kmap)
        scores = torch.einsum("bqhd,bhkd->bhk", q, k_full) * scale
        scores = softcap(scores, attn_softcap_val)
        scores = torch.where(valid, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        out_h = torch.einsum("bhk,bhkd->bhd", probs.to(v_full.dtype),
                             v_full)
    out = torch.einsum("bhd,hdm->bm", out_h.to(p["wo"].dtype), p["wo"])
    return out[:, None, :], cache
