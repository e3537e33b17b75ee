"""Decoder-only LM for the dense and MoE families: one period-structured
stack.

The port's copy of the train path of `repro.models.transformer`. Layers
are grouped into *periods*, the smallest repeating pattern of the
architecture (gemma2: [local, global]; llama4: [dense FFN, MoE FFN];
homogeneous archs: period 1). Each period position owns its stacked
parameters with a leading ``n_periods`` axis, so the parameter names
equal the reference's (``blocks/L0/attn/wq``). The reference's
``lax.scan`` over periods is a Python loop here, and its
``jax.checkpoint`` is `torch.utils.checkpoint.checkpoint` per period
(``use_reentrant=False``): it saves memory and changes no number.

Not ported yet (ROADMAP Queue 1 item 2), each refused by name with
`NotImplementedError`: the SSM mixer (``mamba2``, ``jamba``), the
encoder–decoder family (``whisper``), the vision-stub frontend
(``internvl2``) and the decode path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_block, attn_param_defs
from repro_torch.models.layers import (cross_entropy_loss, embed, rms_norm,
                                       softcap, swiglu, unembed)
from repro_torch.models.moe import moe_ffn, moe_param_defs
from repro_torch.models.params import PDef


def padded_vocab(vocab: int) -> int:
    """The vocabulary padded to a multiple of 128, as the reference's
    `padded_vocab` pads it on one device; padded logits are -1e30."""
    return ((vocab + 127) // 128) * 128


def check_ported(cfg: ModelConfig) -> None:
    """Refuse by name an architecture part this port does not cover."""
    missing = []
    if cfg.is_encoder_decoder:
        missing.append("the encoder-decoder family (whisper)")
    if cfg.family == "ssm" or cfg.attn_period:
        missing.append("the SSM mixer (mamba2 / jamba)")
    if cfg.frontend == "vision_stub":
        missing.append("the vision-stub frontend (internvl2)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} is not ported to "
            "repro_torch yet (ROADMAP Queue 1 item 2)")


def period_structure(cfg: ModelConfig
                     ) -> Tuple[int, List[Tuple[str, str, Optional[str]]]]:
    """(period length P, [(mixer, attn_flavor, ffn_kind)] × P)."""
    p = max(cfg.local_global_period, cfg.attn_period, cfg.moe_period, 1)
    layers = []
    for i in range(p):
        if cfg.family == "ssm":
            mixer = "ssm"
        elif cfg.attn_period:
            mixer = "attn" if i == 0 else "ssm"
        else:
            mixer = "attn"
        if cfg.local_global_period:
            flavor = "local" if i % cfg.local_global_period == 0 else "global"
        elif cfg.sliding_window:
            flavor = "local"
        else:
            flavor = "global"
        if cfg.n_experts and i % cfg.moe_period == cfg.moe_period - 1:
            ffn = "moe"
        elif cfg.d_ff == 0:
            ffn = None
        else:
            ffn = "ff"
        layers.append((mixer, flavor, ffn))
    return p, layers


def n_periods(cfg: ModelConfig) -> int:
    p, _ = period_structure(cfg)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of the period {p}")
    return cfg.n_layers // p


def ffn_param_defs(cfg: ModelConfig, n_stack: int):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PDef((n_stack, d, f), ("layers", "embed", "ff")),
        "w_up": PDef((n_stack, d, f), ("layers", "embed", "ff")),
        "w_down": PDef((n_stack, f, d), ("layers", "ff", "embed")),
    }


def param_defs(cfg: ModelConfig) -> Dict:
    """Abstract parameter tree for the full model."""
    check_ported(cfg)
    _, layers = period_structure(cfg)
    np_ = n_periods(cfg)
    d = cfg.d_model
    blocks: Dict[str, Dict] = {}
    for i, (_mixer, _flavor, ffn) in enumerate(layers):
        grp: Dict = {"ln1": PDef((np_, d), ("layers", "embed"), init="zeros"),
                     "attn": attn_param_defs(cfg, np_)}
        if cfg.local_global_period:  # gemma2 post-norms
            grp["post_ln1"] = PDef((np_, d), ("layers", "embed"),
                                   init="zeros")
        if ffn is not None:
            grp["ln2"] = PDef((np_, d), ("layers", "embed"), init="zeros")
            if ffn == "moe":
                grp["moe"] = moe_param_defs(cfg, np_)
            else:
                grp["ffn"] = ffn_param_defs(cfg, np_)
            if cfg.local_global_period:
                grp["post_ln2"] = PDef((np_, d), ("layers", "embed"),
                                       init="zeros")
        blocks[f"L{i}"] = grp
    vp = padded_vocab(cfg.vocab_size)
    defs: Dict = {
        "embed": PDef((vp, d), ("vocab", "embed"), scale=0.02),
        "final_norm": PDef((d,), ("embed",), init="zeros"),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = PDef((vp, d), ("vocab", "embed"))
    return defs


def _mlp_act(cfg: ModelConfig) -> str:
    return "gelu" if cfg.local_global_period else "silu"  # gemma2: GeGLU


def _period(cfg: ModelConfig, layers, positions, x, aux, period_params):
    """One period of the stack (train path) → (x, aux)."""
    for i, (_mixer, flavor, ffn) in enumerate(layers):
        pp = period_params[f"L{i}"]
        h = rms_norm(x, pp["ln1"], cfg.norm_eps, cfg.norm_f32)
        window = cfg.sliding_window if flavor == "local" else None
        h = attention_block(pp["attn"], h, positions, cfg, causal=True,
                            window=window)
        if "post_ln1" in pp:
            h = rms_norm(h, pp["post_ln1"], cfg.norm_eps, cfg.norm_f32)
        x = x + h
        if ffn is not None:
            h2 = rms_norm(x, pp["ln2"], cfg.norm_eps, cfg.norm_f32)
            if ffn == "moe":
                h2, a = moe_ffn(pp["moe"], h2, cfg)
                aux = aux + a
            else:
                h2 = swiglu(h2, pp["ffn"]["w_gate"], pp["ffn"]["w_up"],
                            pp["ffn"]["w_down"], act=_mlp_act(cfg))
            if "post_ln2" in pp:
                h2 = rms_norm(h2, pp["post_ln2"], cfg.norm_eps, cfg.norm_f32)
            x = x + h2
    return x, aux


def _index_tree(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V_pad), aux_loss)."""
    check_ported(cfg)
    x = embed(tokens, params["embed"],
              scale_by_dim=bool(cfg.local_global_period))
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)[None, :].expand(
        x.shape[0], s_total)
    _, layers = period_structure(cfg)
    remat = remat and cfg.remat_policy != "none"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_periods(cfg)):
        pp = _index_tree(params["blocks"], i)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_period, cfg, layers, positions, x, aux, pp,
                                use_reentrant=False)
        else:
            x, aux = _period(cfg, layers, positions, x, aux, pp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    return _logits(params, x, cfg), aux


def lm_loss(params, batch, cfg: ModelConfig, aux_weight: float = 0.01,
            remat: bool = True) -> torch.Tensor:
    """Next-token CE (+ MoE aux). batch: {tokens, labels}."""
    logits, aux = forward(params, batch["tokens"], cfg, remat=remat)
    loss = cross_entropy_loss(logits, batch["labels"])
    return loss + aux_weight * aux


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Unembed + softcap + padded-vocab -1e30 mask."""
    table = params.get("lm_head", params["embed"])
    logits = softcap(unembed(x, table), cfg.logit_softcap)
    vp = table.shape[0]
    if vp != cfg.vocab_size:  # padded rows are numerically invisible
        pad = torch.arange(vp, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits
