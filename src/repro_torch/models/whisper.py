"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed).

The port's copy of `repro.models.whisper`. The modality frontend is a
stub: the caller provides precomputed frame embeddings (B, T_enc, D).
The transformer backbone is Whisper's: a bidirectional encoder with
learned positions, a causal decoder with cross-attention, LayerNorm
(not RMSNorm), no RoPE. The reference's layer scans are Python loops,
each layer under `torch.utils.checkpoint` while gradients are on.

Two decode quirks of the reference are kept (ROADMAP Queue 3):
`decode_step` clamps ``pos`` into the 448 learned decoder slots, while
`decode_train` switches to sinusoids above 448 positions; and nothing
fills the cross-attention KV from the encoder, so a cache from
`cache_spec` serves with zero cross-KV (`launch.serve.serve_batch`
does so, as the reference's does).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (KVCache, attn_dims,
                                          attn_param_defs, decode_attention,
                                          expand_kv, flash_attention,
                                          qkv_project)
from repro_torch.models.layers import cross_entropy_loss, layer_norm, unembed
from repro_torch.models.params import PDef, TensorSpec, map_tree
from repro_torch.models.transformer import padded_vocab

N_POS_DEC = 448  # Whisper's learned decoder positions


def _ln_defs(n: int, d: int):
    return {
        "scale": PDef((n, d), ("layers", "embed"), init="ones"),
        "bias": PDef((n, d), ("layers", "embed"), init="zeros"),
    }


def _mlp_defs(n: int, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w1": PDef((n, d, f), ("layers", "embed", "ff")),
        "b1": PDef((n, f), ("layers", "ff"), init="zeros"),
        "w2": PDef((n, f, d), ("layers", "ff", "embed")),
        "b2": PDef((n, d), ("layers", "embed"), init="zeros"),
    }


def param_defs(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    ne, nd = cfg.n_encoder_layers, cfg.n_layers
    return {
        "embed": PDef((padded_vocab(cfg.vocab_size), d),
                      ("vocab", "embed"), scale=0.02),
        "pos_dec": PDef((N_POS_DEC, d), (None, "embed"), scale=0.02),
        "pos_enc": PDef((cfg.encoder_seq, d), (None, "embed"), scale=0.02),
        "enc": {
            "ln1": _ln_defs(ne, d),
            "attn": attn_param_defs(cfg, ne),
            "ln2": _ln_defs(ne, d),
            "mlp": _mlp_defs(ne, cfg),
        },
        "enc_final_ln": {"scale": PDef((d,), ("embed",), init="ones"),
                         "bias": PDef((d,), ("embed",), init="zeros")},
        "dec": {
            "ln1": _ln_defs(nd, d),
            "self_attn": attn_param_defs(cfg, nd),
            "ln_x": _ln_defs(nd, d),
            "cross_attn": attn_param_defs(cfg, nd),
            "ln2": _ln_defs(nd, d),
            "mlp": _mlp_defs(nd, cfg),
        },
        "dec_final_ln": {"scale": PDef((d,), ("embed",), init="ones"),
                         "bias": PDef((d,), ("embed",), init="zeros")},
    }


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """Sinusoidal positions: the fallback beyond Whisper's 448 learned
    slots."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _dec_positions(params, s: int, d: int) -> torch.Tensor:
    if s <= params["pos_dec"].shape[0]:
        return params["pos_dec"][:s]
    return _sinusoid(s, d, params["pos_dec"].device)


def _mlp(p, x):
    h = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
    return h @ p["w2"] + p["b2"]


def _chunk_of(s: int, target: int = 1024) -> int:
    """Largest divisor of s not exceeding target (encoder seq 1500
    isn't a power of two)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def _attn_full(p, x_q, x_kv, cfg: ModelConfig, causal: bool):
    """(Cross-)attention sublayer on full sequences."""
    pos_q = torch.arange(x_q.shape[1], device=x_q.device)[None].expand(
        x_q.shape[:2])
    q, _, _ = qkv_project(p, x_q, pos_q, cfg)
    pos_kv = torch.arange(x_kv.shape[1], device=x_kv.device)[None].expand(
        x_kv.shape[:2])
    _, k, v = qkv_project(p, x_kv, pos_kv, cfg)
    o = flash_attention(q, k, v, attn_dims(cfg), causal=causal,
                        q_chunk=_chunk_of(x_q.shape[1]),
                        kv_chunk=_chunk_of(x_kv.shape[1]))
    return torch.einsum("bshd,hdm->bsm", o, p["wo"])


def _layers(body, x, stacked):
    """Run ``body(x, layer_params)`` over the stacked layers, each under
    `checkpoint` while gradients are on (the reference's
    ``jax.checkpoint`` inside its scan)."""
    for i in range(stacked["ln1"]["scale"].shape[0]):
        lp = map_tree(lambda a: a[i], stacked)
        if torch.is_grad_enabled():
            x = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x = body(x, lp)
    return x


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed embeddings (stub frontend)."""
    x = frames + params["pos_enc"][None, : frames.shape[1]]

    def body(x_, lp):
        h = layer_norm(x_, lp["ln1"]["scale"], lp["ln1"]["bias"])
        x_ = x_ + _attn_full(lp["attn"], h, h, cfg, causal=False)
        h = layer_norm(x_, lp["ln2"]["scale"], lp["ln2"]["bias"])
        return x_ + _mlp(lp["mlp"], h)

    x = _layers(body, x, params["enc"])
    return layer_norm(x, params["enc_final_ln"]["scale"],
                      params["enc_final_ln"]["bias"])


def decode_train(params, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder; returns logits (B, S, V_pad). Positions
    above 448 are sinusoids (`decode_step` clamps instead)."""
    x = params["embed"][tokens.long()]
    x = x + _dec_positions(params, tokens.shape[1], cfg.d_model)[None]

    def body(x_, lp):
        h = layer_norm(x_, lp["ln1"]["scale"], lp["ln1"]["bias"])
        x_ = x_ + _attn_full(lp["self_attn"], h, h, cfg, causal=True)
        h = layer_norm(x_, lp["ln_x"]["scale"], lp["ln_x"]["bias"])
        x_ = x_ + _attn_full(lp["cross_attn"], h, enc_out, cfg,
                             causal=False)
        h = layer_norm(x_, lp["ln2"]["scale"], lp["ln2"]["bias"])
        return x_ + _mlp(lp["mlp"], h)

    x = _layers(body, x, params["dec"])
    x = layer_norm(x, params["dec_final_ln"]["scale"],
                   params["dec_final_ln"]["bias"])
    return _masked_logits(params, x, cfg)


def _masked_logits(params, x, cfg: ModelConfig):
    logits = unembed(x, params["embed"])
    vp = params["embed"].shape[0]
    if vp != cfg.vocab_size:
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    enc_out = encode(params, batch["frames"], cfg)
    logits = decode_train(params, batch["tokens"], enc_out, cfg)
    return cross_entropy_loss(logits, batch["labels"])


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Self-attention KV cache (decoder) + the static cross KV over the
    encoder's frames, both stacked (L, ...) in ``dtype`` (the
    reference's: bf16)."""
    nd = cfg.n_layers
    dims = attn_dims(cfg)
    self_sd = TensorSpec((nd,) + KVCache.shape(cfg, batch, seq_len).shape,
                         dtype)
    cross_sd = TensorSpec(
        (nd, batch, dims.n_kv, cfg.encoder_seq, dims.head_dim), dtype)
    return {"self": KVCache(k=self_sd, v=self_sd),
            "cross": KVCache(k=cross_sd, v=cross_sd)}


def decode_step(params, tokens: torch.Tensor, cache: Dict, pos: int,
                cfg: ModelConfig):
    """One decoder serve step against cached self/cross KV: tokens
    (B, 1) at ``pos`` (a host int) → (logits (B, 1, V_pad), cache).

    The learned position is ``pos_dec[min(pos, 447)]``: the reference
    clamps here, where `decode_train` uses sinusoids above 448. The
    self-attention KV is written in place; the cross KV is read as it
    is.
    """
    x = params["embed"][tokens.long()]
    table = params["pos_dec"]
    x = x + table[min(pos, table.shape[0] - 1)][None, None]
    dims = attn_dims(cfg)
    for i in range(cfg.n_layers):
        lp = map_tree(lambda a: a[i], params["dec"])
        self_c = map_tree(lambda a: a[i], cache["self"])
        cross = map_tree(lambda a: a[i], cache["cross"])
        h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
        h_sa, _ = decode_attention(lp["self_attn"], h, self_c, pos, cfg)
        x = x + h_sa
        h = layer_norm(x, lp["ln_x"]["scale"], lp["ln_x"]["bias"])
        # cross-attention against the static encoder KV, every kv head
        # expanded to its q heads
        ca = lp["cross_attn"]
        q = torch.einsum("bsd,dhk->bshk", h, ca["wq"])
        if cfg.qkv_bias:
            q = q + ca["bq"]
        k_full = expand_kv(cross.k.float().transpose(1, 2),
                           dims).transpose(1, 2)  # (B, Hq, S_enc, D)
        v_full = expand_kv(cross.v.transpose(1, 2), dims).transpose(1, 2)
        scores = torch.einsum("bqhd,bhkd->bhk", q, k_full) / math.sqrt(
            dims.head_dim)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhk,bhkd->bhd", probs.to(v_full.dtype), v_full)
        x = x + torch.einsum("bhd,hdm->bm", o.to(ca["wo"].dtype),
                             ca["wo"])[:, None]
        h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
        x = x + _mlp(lp["mlp"], h)
    x = layer_norm(x, params["dec_final_ln"]["scale"],
                   params["dec_final_ln"]["bias"])
    return _masked_logits(params, x, cfg), cache
