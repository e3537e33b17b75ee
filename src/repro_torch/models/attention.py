"""Attention: GQA projections, chunked attention (train/prefill) and
cached decode attention.

The port's copy of `repro.models.attention`. Under a `ShardingRules`
with a tensor-parallel degree above 1, query heads are padded to a
multiple of it (`effective_heads`); a padded model's ``wo`` is
zero-initialized whole, so padded heads are exact no-ops. KV heads shard
over "model" only where their count divides the degree; otherwise the
decode cache shards its sequence axis (``KVCache.logical_axes``). The
reference's sharding constraints are `constrain` calls, no-ops on plain
tensors. `flash_attention` repeats the reference's chunked online
softmax (q chunks of 2048, kv chunks of 1024, every chunk pair computed
and masked with -1e30, the GQA expansion by the reference's q-head →
kv-head map, padded heads on kv head 0) and `decode_attention` its
one-token attention against a `KVCache`, both in plain torch ops, as
the reference computes them in jnp outside any Pallas kernel.

One deliberate difference (ROADMAP Queue 3): under head padding the
reference's decode groups q heads by ``n_q / n_kv``, where its prefill
maps real head i to kv head ``i·n_kv / n_q_real``, so its padded decode
disagrees with its prefill once ``wo`` is trained. The port's decode
uses the prefill's map whenever heads are padded.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (NO_SHARDING, ShardingRules,
                                              constrain, effective_heads,
                                              kv_heads_shardable)
from repro_torch.models.layers import apply_rope, matmul, promoted, softcap
from repro_torch.models.params import PDef, TensorSpec


@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int  # effective (padded) query heads
    n_kv: int
    head_dim: int
    n_q_real: int = 0  # the config's query heads (0: n_q)
    kv_sharded: bool = False  # the KV-head axis shards over "model"

    def __post_init__(self):
        if not self.n_q_real:
            object.__setattr__(self, "n_q_real", self.n_q)

    @property
    def padded(self) -> bool:
        return self.n_q != self.n_q_real


def attn_dims(cfg: ModelConfig,
              rules: ShardingRules = NO_SHARDING) -> AttnDims:
    return AttnDims(n_q=effective_heads(cfg.n_heads, rules),
                    n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                    n_q_real=cfg.n_heads,
                    kv_sharded=kv_heads_shardable(cfg.n_kv_heads, rules))


def attn_param_defs(cfg: ModelConfig, n_layers: int,
                    rules: ShardingRules = NO_SHARDING):
    """Stacked (layer-axis-leading) attention params for `n_layers`."""
    d = cfg.d_model
    dims = attn_dims(cfg, rules)
    kv_ax = "kv_heads" if dims.kv_sharded else None
    L = n_layers
    defs = {
        "wq": PDef((L, d, dims.n_q, dims.head_dim),
                   ("layers", "embed", "heads", None)),
        "wk": PDef((L, d, dims.n_kv, dims.head_dim),
                   ("layers", "embed", kv_ax, None)),
        "wv": PDef((L, d, dims.n_kv, dims.head_dim),
                   ("layers", "embed", kv_ax, None)),
        "wo": PDef((L, dims.n_q, dims.head_dim, d),
                   ("layers", "heads", None, "embed"),
                   init="zeros" if dims.padded else "normal"),
    }
    if cfg.qkv_bias:
        defs["bq"] = PDef((L, dims.n_q, dims.head_dim),
                          ("layers", "heads", None), init="zeros")
        defs["bk"] = PDef((L, dims.n_kv, dims.head_dim),
                          ("layers", kv_ax, None), init="zeros")
        defs["bv"] = PDef((L, dims.n_kv, dims.head_dim),
                          ("layers", kv_ax, None), init="zeros")
    return defs


def kv_expand_map(dims: AttnDims) -> list:
    """q-head → kv-head index (padded q heads map to kv head 0)."""
    return [i * dims.n_kv // dims.n_q_real if i < dims.n_q_real else 0
            for i in range(dims.n_q)]


def expand_kv(x: torch.Tensor, dims: AttnDims) -> torch.Tensor:
    """(B, S, Hkv, D) → (B, S, Hq, D) by `kv_expand_map`. Where the real
    q heads are a multiple of Hkv (every ported config) the map is
    i // (Hq_real/Hkv) and the expansion a broadcast (padded heads a
    broadcast of kv head 0), whose gradient is a sum in a fixed order;
    an index gather's gradient would scatter with atomics."""
    b, s, h, d = x.shape
    if dims.n_q_real % h == 0:
        rep = dims.n_q_real // h
        out = x[:, :, :, None].expand(b, s, h, rep, d).reshape(
            b, s, dims.n_q_real, d)
        if dims.padded:
            out = torch.cat([out, x[:, :, :1].expand(
                b, s, dims.n_q - dims.n_q_real, d)], dim=2)
        return out
    kmap = torch.tensor(kv_expand_map(dims), device=x.device)
    return x.index_select(2, kmap)


def head_projection(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) · w (D, H, K) → (B, S, H, K).

    On DTensors the product runs under `local_map` with the layout
    spelled out: x's batch split kept, w gathered over its FSDP split,
    the head axis split where w's is. Left to itself DTensor may split
    the flattened (H·K) axis of the product over a mesh axis that H does
    not divide (8 unsharded KV heads over 16 ranks), which the view
    back to (H, K) cannot carry.
    """
    x, w = promoted(x, w)
    if not isinstance(x, DTensor):
        return torch.einsum("bsd,dhk->bshk", x, w)

    mesh = x.device_mesh
    xb = [isinstance(pl, Shard) and pl.dim == 0 for pl in x.placements]
    wh = [isinstance(pl, Shard) and pl.dim == 1 for pl in w.placements]
    x_in = [Shard(0) if b else Replicate() for b in xb]
    w_in = [Shard(1) if h else Replicate() for h in wh]
    out = [Shard(0) if b else Shard(2) if h else Replicate()
           for b, h in zip(xb, wh)]
    x_grad = [Shard(0) if b else Partial() if h else Replicate()
              for b, h in zip(xb, wh)]
    w_grad = [Shard(1) if h else Partial() if b else Replicate()
              for b, h in zip(xb, wh)]
    fn = local_map(lambda a, b: torch.einsum("bsd,dhk->bshk", a, b),
                   out_placements=out, in_placements=(x_in, w_in),
                   in_grad_placements=(x_grad, w_grad), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(x, w)


def whole_heads(x: torch.Tensor) -> torch.Tensor:
    """A DTensor (B, S, H, D) with its head axis gathered whole on each
    rank (its batch split kept); anything else as it is. A decode
    step's query is small, and DTensor refuses to merge a split head
    axis into the batch of an einsum."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [
        p if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in x.placements])


def out_projection(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, K) · wo (H, K, D) → (B, S, D). On DTensors under
    `local_map`: o's batch split kept and wo gathered over its FSDP
    split, or the heads split on both (row parallel: a partial sum)."""
    o, wo = promoted(o, wo)
    if not isinstance(o, DTensor):
        return torch.einsum("bshd,hdm->bsm", o, wo)

    lays = []
    for op, wp in zip(o.placements, wo.placements):
        if isinstance(op, Shard) and op.dim == 0:
            lays.append((Shard(0), Replicate(), Shard(0), Shard(0),
                         Partial()))
        elif isinstance(wp, Shard) and wp.dim == 0:
            lays.append((Shard(2), Shard(0), Partial(), Shard(2), Shard(0)))
        else:
            lays.append((Replicate(),) * 5)
    o_in, w_in, out, o_grad, w_grad = (list(x) for x in zip(*lays))
    fn = local_map(lambda a, b: torch.einsum("bshd,hdm->bsm", a, b),
                   out_placements=out, in_placements=(o_in, w_in),
                   in_grad_placements=(o_grad, w_grad),
                   device_mesh=o.device_mesh, redistribute_inputs=True)
    return fn(o, wo)


def qkv_project(p, x, positions, cfg: ModelConfig,
                rules: ShardingRules = NO_SHARDING):
    """x (B, S, D) → q (B, S, Hq, hd), k/v (B, S, Hkv, hd), RoPE'd."""
    dims = attn_dims(cfg, rules)
    q = head_projection(x, p["wq"])
    k = head_projection(x, p["wk"])
    v = head_projection(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = constrain(q, rules, ("batch", None, "heads", None))
    kv_ax = "kv_heads" if dims.kv_sharded else None
    k = constrain(k, rules, ("batch", None, kv_ax, None))
    v = constrain(v, rules, ("batch", None, kv_ax, None))
    return q, k, v


def _project(p, x, positions, cfg: ModelConfig, rules: ShardingRules):
    """`qkv_project` looked up at call time, given ``rules`` only where
    they shard: a stand-in with the one-device signature ``(p, x,
    positions, cfg)`` (a test's recorder) serves the default rules."""
    if rules == NO_SHARDING:
        return qkv_project(p, x, positions, cfg)
    return qkv_project(p, x, positions, cfg, rules)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    dims: AttnDims, *, causal: bool = True,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None,
                    q_chunk: int = 2048, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """Chunked online-softmax attention: q (B, S, Hq, D), k/v (B, S_kv,
    Hkv, D) → (B, S, Hq, D). Never holds more than one (q_chunk,
    kv_chunk) score block per head."""
    q, k, v = promoted(q, k, v)  # JAX promotes mixed dtypes
    b, s, hq, d = q.shape
    s_kv = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, s)
    kv_chunk = min(kv_chunk, s_kv)
    if s % q_chunk or s_kv % kv_chunk:
        raise ValueError(f"flash_attention: S={s}, S_kv={s_kv} must be "
                         f"multiples of the chunks ({q_chunk}, {kv_chunk})")
    k, v = expand_kv(k, dims), expand_kv(v, dims)

    if isinstance(q, DTensor):
        return _local_heads(q, k, v, lambda a, b, c: flash_attention(
            a, b, c, AttnDims(a.shape[2], a.shape[2], d), causal=causal,
            window=window, attn_softcap=attn_softcap, q_chunk=q_chunk,
            kv_chunk=kv_chunk))
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


def _local_heads(q, k, v, fn):
    """``fn(q, k, v)`` on each rank's batch rows and heads (attention is
    independent across both) under `local_map`: q's batch and head
    splits, k and v laid out alike. DTensor left to itself gathers the
    heads where the score einsum merges the batch and head axes."""
    lay = [Shard(p.dim) if isinstance(p, Shard) and p.dim in (0, 2)
           else Replicate() for p in q.placements]
    mapped = local_map(fn, out_placements=lay, in_placements=(lay,) * 3,
                       in_grad_placements=(lay,) * 3,
                       device_mesh=q.device_mesh, redistribute_inputs=True)
    return mapped(q, k, v)


def attention_block(p, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ModelConfig, rules: ShardingRules = NO_SHARDING,
                    *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Full train attention sublayer (projection → attention → W_o)."""
    q, k, v = _project(p, x, positions, cfg, rules)
    o = flash_attention(q, k, v, attn_dims(cfg, rules), causal=causal,
                        window=window, attn_softcap=cfg.attn_softcap)
    o = constrain(o, rules, ("batch", None, "heads", None))
    return out_projection(o, p["wo"])


class KVCache(NamedTuple):
    """Decode-time KV cache for one layer group. k/v: (B, Hkv, S, D)."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def shape(cfg: ModelConfig, batch: int, length: int,
              dtype: torch.dtype = torch.bfloat16,
              rules: ShardingRules = NO_SHARDING) -> TensorSpec:
        dims = attn_dims(cfg, rules)
        return TensorSpec((batch, dims.n_kv, length, dims.head_dim), dtype)

    @staticmethod
    def logical_axes(cfg: ModelConfig, rules: ShardingRules = NO_SHARDING):
        if attn_dims(cfg, rules).kv_sharded:
            return ("batch", "kv_heads", None, None)
        return ("batch", None, "seq_kv", None)


def write_slot(cache: torch.Tensor, update: torch.Tensor, dim: int,
               index: int) -> None:
    """``cache.select(dim, index).copy_(update)`` in place. On a DTensor
    cache the write goes into the local shard of the rank that holds
    slot ``index`` (the update laid out as the cache's other
    dimensions), so no rank copies the cache; the reference's in-place
    ``dynamic_update_slice``."""
    if not isinstance(cache, DTensor):
        cache.select(dim, index).copy_(update)
        return
    mesh = cache.device_mesh
    placements, owners = [], []
    for i, pl in enumerate(cache.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            owners.append(i)
            placements.append(Replicate())
        elif isinstance(pl, Shard) and pl.dim > dim:
            placements.append(Shard(pl.dim - 1))
        else:
            placements.append(pl)
    if not isinstance(update, DTensor):
        update = distribute_tensor(update, mesh, [Replicate()] * mesh.ndim,
                                   src_data_rank=None)
    upd = update.redistribute(mesh, placements).to_local()
    lo, size, coord = 0, cache.shape[dim], mesh.get_coordinate()
    for i in owners:  # the rank's block of `dim`, torch.chunk's split
        block = -(-size // mesh.size(i))
        lo += coord[i] * block
        size = max(0, min(block, size - coord[i] * block))
    if lo <= index < lo + size:
        cache.to_local().select(dim, index - lo).copy_(upd)


def _valid(lo: int, n: int, write_at: int, ring: bool, device):
    """Which of the cache slots ``[lo, lo + n)`` hold a key."""
    idx = lo + torch.arange(n, device=device)
    if ring:
        return torch.ones_like(idx, dtype=torch.bool)
    return idx <= write_at


def _groups(q, k_c, v_c, dims: AttnDims):
    """The decode's (query groups (B, G, R, D), keys (B, G, S, D),
    values) parts: q-head groups against their kv head and the padded
    heads, one group, against kv head 0; or every q head against its
    expanded kv head where the real heads do not group."""
    b = q.shape[0]
    if dims.n_q_real % dims.n_kv == 0:
        g, r = dims.n_kv, dims.n_q_real // dims.n_kv
        parts = [(q[:, 0, :dims.n_q_real].reshape(b, g, r, dims.head_dim),
                  k_c, v_c)]
        if dims.padded:
            parts.append((q[:, 0, dims.n_q_real:][:, None], k_c[:, :1],
                          v_c[:, :1]))
        return parts
    kmap = torch.tensor(kv_expand_map(dims), device=q.device)
    return [(q[:, 0][:, :, None], k_c.index_select(1, kmap),
             v_c.index_select(1, kmap))]


def _scores(qg, k, scale: float, cap, valid):
    scores = torch.einsum("bgrd,bgkd->bgrk", qg, k) * scale
    return torch.where(valid, softcap(scores, cap), -1e30)


def _attend(q, k_c, v_c, dims: AttnDims, valid, scale: float, cap):
    """One-token attention of q (B, 1, Hq, D) against the cache → the
    heads' outputs (B, Hq, D)."""
    b = q.shape[0]
    outs = []
    for qg, k, v in _groups(q, k_c, v_c, dims):
        probs = torch.softmax(_scores(qg, k, scale, cap, valid), dim=-1)
        o = torch.einsum("bgrk,bgkd->bgrd", probs.to(v.dtype), v)
        outs.append(o.reshape(b, -1, dims.head_dim))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _sharded_decode(q, k_c, v_c, dims: AttnDims, scale: float, cap,
                    write_at: int, ring: bool):
    """`_attend` on DTensors under `local_map`, rank by rank: the cache
    keeps its batch, kv-head or sequence split and q follows it (whole
    over a sequence split). Where a mesh axis of more than one rank
    splits the sequence, the softmax is the flash-decode combine: each
    rank's max over its slots reduces to the global max, then each
    rank's exp-sums and weighted values reduce as partial sums, and the
    output is their quotient."""
    mesh = k_c.device_mesh
    roles = [p.dim if isinstance(p, Shard) else None for p in k_c.placements]
    q_lay = [Shard(0) if r == 0 else Shard(2) if r == 1 else Replicate()
             for r in roles]
    kv_lay = [Shard(r) if r is not None else Replicate() for r in roles]
    out_lay = [Shard(0) if r == 0 else Shard(1) if r == 1 else Replicate()
               for r in roles]
    seq = [i for i, r in enumerate(roles) if r == 2]
    if any(r == 1 for r in roles) and dims.padded:
        raise ValueError("decode over a kv-head-sharded cache with padded "
                         "q heads")
    n_split = 1  # the ranks a kv-head split spreads the heads over
    for i, r in enumerate(roles):
        if r == 1:
            n_split *= mesh.size(i)
    coord = mesh.get_coordinate()
    lo, size = 0, k_c.shape[2]
    for i in seq:  # this rank's slots, torch.chunk's split
        block = -(-size // mesh.size(i))
        lo += coord[i] * block
        size = max(0, min(block, size - coord[i] * block))

    def local_dims(q_l, k_l):
        return AttnDims(q_l.shape[2], k_l.shape[1], dims.head_dim,
                        n_q_real=dims.n_q_real // n_split)

    def valid(k_l):
        return _valid(lo, k_l.shape[2], write_at, ring, k_l.device)

    if all(mesh.size(i) == 1 for i in seq):
        def attend(q_l, k_l, v_l):
            return _attend(q_l, k_l, v_l, local_dims(q_l, k_l), valid(k_l),
                           scale, cap)

        return local_map(attend, out_placements=out_lay,
                         in_placements=(q_lay, kv_lay, kv_lay),
                         device_mesh=mesh, redistribute_inputs=True)(
                             q, k_c, v_c)

    def part_max(q_l, k_l, v_l):
        return tuple(_scores(qg, k, scale, cap, valid(k_l)).amax(
            -1, keepdim=True) for qg, k, _ in _groups(
                q_l, k_l, v_l, local_dims(q_l, k_l)))

    def part_sums(q_l, k_l, v_l, *maxes):
        out = []
        for (qg, k, v), m in zip(_groups(q_l, k_l, v_l,
                                         local_dims(q_l, k_l)), maxes):
            p = torch.exp(_scores(qg, k, scale, cap, valid(k_l)) - m)
            out += [p.sum(-1, keepdim=True),
                    torch.einsum("bgrk,bgkd->bgrd", p.to(v.dtype), v)]
        return tuple(out)

    n_parts = 2 if dims.n_q_real % dims.n_kv == 0 and dims.padded else 1
    grp = [Shard(0) if r == 0 else Shard(1) if r == 1 else Replicate()
           for r in roles]
    as_max = [Partial("max") if r == 2 else p for r, p in zip(roles, grp)]
    as_sum = [Partial("sum") if r == 2 else p for r, p in zip(roles, grp)]
    maxes = local_map(part_max, out_placements=(as_max,) * n_parts,
                      in_placements=(q_lay, kv_lay, kv_lay),
                      device_mesh=mesh, redistribute_inputs=True)(
                          q, k_c, v_c)
    maxes = [m.redistribute(mesh, grp) for m in maxes]
    sums = local_map(part_sums, out_placements=(as_sum,) * (2 * n_parts),
                     in_placements=(q_lay, kv_lay, kv_lay)
                     + (grp,) * n_parts,
                     device_mesh=mesh, redistribute_inputs=True)(
                         q, k_c, v_c, *maxes)
    b = q.shape[0]
    outs = [(sums[2 * i + 1].redistribute(mesh, grp)
             / sums[2 * i].redistribute(mesh, grp)).reshape(
                 b, -1, dims.head_dim) for i in range(n_parts)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention(p, x: torch.Tensor, cache: KVCache, pos: int,
                     cfg: ModelConfig, rules: ShardingRules = NO_SHARDING,
                     *, window: Optional[int] = None,
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
    dims = attn_dims(cfg, rules)
    b = x.shape[0]
    s_len = cache.k.shape[2]
    if window is None and not 0 <= pos < s_len:
        raise ValueError(f"decode_attention: pos {pos} outside the "
                         f"cache's {s_len} slots")
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project(p, x, positions, cfg, rules)
    write_at = pos % s_len if window is not None else pos
    write_slot(cache.k, k_new[:, 0].to(cache.k.dtype), 2, write_at)
    write_slot(cache.v, v_new[:, 0].to(cache.v.dtype), 2, write_at)

    scale = 1.0 / math.sqrt(dims.head_dim)
    ring = window is not None and pos >= s_len  # every slot valid
    cache_axes = KVCache.logical_axes(cfg, rules)
    # the float32 read is where JAX promotes the cache operand
    k_c = constrain(cache.k, rules, cache_axes).float()
    v_c = constrain(cache.v, rules, cache_axes)
    if q.dtype != k_c.dtype:  # bf16 queries promote, as in JAX
        q = q.to(torch.promote_types(q.dtype, k_c.dtype))

    if isinstance(q, DTensor):
        out_h = _sharded_decode(q, k_c, v_c, dims, scale, attn_softcap_val,
                                write_at, ring)
    else:
        out_h = _attend(q, k_c, v_c, dims, _valid(0, s_len, write_at, ring,
                                                  x.device),
                        scale, attn_softcap_val)
    if isinstance(out_h, DTensor):
        return out_projection(out_h[:, None].to(p["wo"].dtype),
                              p["wo"]), cache
    out = torch.einsum("bhd,hdm->bm", out_h.to(p["wo"].dtype), p["wo"])
    return out[:, None, :], cache
