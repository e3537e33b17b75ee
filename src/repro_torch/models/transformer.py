"""Generic decoder-only LM covering the dense / MoE / hybrid / VLM / SSM
families through one period-structured stack.

The port's copy of `repro.models.transformer`. Layers are grouped into
*periods*, the smallest repeating pattern of the architecture (gemma2:
[local, global]; jamba: [attn, 7×mamba] with MoE on odd positions;
llama4: [dense FFN, MoE FFN]; homogeneous archs: period 1). Each period
position owns its stacked parameters with a leading ``n_periods`` axis,
so the parameter names equal the reference's (``blocks/L0/attn/wq``).
The reference's ``lax.scan`` over periods is a Python loop here, and its
``jax.checkpoint`` is `torch.utils.checkpoint.checkpoint` per period
(``use_reentrant=False``): it saves memory and changes no number. The
vision stub (internvl2) prepends ``extra_embeds`` to the token
embeddings. The decode path (`cache_spec`, `init_cache`, `decode_step`)
writes each step into the stacked caches in place. The cache's logical
axes wait for the model-sharding rules (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (KVCache, attention_block,
                                          attn_param_defs, decode_attention)
from repro_torch.models.layers import (cross_entropy_loss, embed, rms_norm,
                                       softcap, swiglu, unembed)
from repro_torch.models.mamba2 import (ssd_decode_step, ssd_mixer,
                                       ssm_param_defs, ssm_state_structs)
from repro_torch.models.moe import moe_ffn, moe_param_defs
from repro_torch.models.params import PDef, TensorSpec, map_tree


def padded_vocab(vocab: int) -> int:
    """The vocabulary padded to a multiple of 128, as the reference's
    `padded_vocab` pads it on one device; padded logits are -1e30."""
    return ((vocab + 127) // 128) * 128


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
    _, layers = period_structure(cfg)
    np_ = n_periods(cfg)
    d = cfg.d_model
    blocks: Dict[str, Dict] = {}
    for i, (mixer, _flavor, ffn) in enumerate(layers):
        grp: Dict = {"ln1": PDef((np_, d), ("layers", "embed"),
                                 init="zeros")}
        if mixer == "attn":
            grp["attn"] = attn_param_defs(cfg, np_)
            if cfg.local_global_period:  # gemma2 post-norms
                grp["post_ln1"] = PDef((np_, d), ("layers", "embed"),
                                       init="zeros")
        else:
            grp["ssm"] = ssm_param_defs(cfg, np_)
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
    for i, (mixer, flavor, ffn) in enumerate(layers):
        pp = period_params[f"L{i}"]
        h = rms_norm(x, pp["ln1"], cfg.norm_eps, cfg.norm_f32)
        if mixer == "attn":
            window = cfg.sliding_window if flavor == "local" else None
            h = attention_block(pp["attn"], h, positions, cfg, causal=True,
                                window=window)
            if "post_ln1" in pp:
                h = rms_norm(h, pp["post_ln1"], cfg.norm_eps, cfg.norm_f32)
        else:
            h = ssd_mixer(pp["ssm"], h, cfg)
        x = x + h
        if ffn is not None:
            h2, a = _ffn(cfg, pp, x, ffn)
            aux = aux + a
            x = x + h2
    return x, aux


def _ffn(cfg: ModelConfig, pp, x: torch.Tensor, ffn: str):
    """A period position's FFN sublayer (its norms included) → (output,
    aux loss)."""
    h2 = rms_norm(x, pp["ln2"], cfg.norm_eps, cfg.norm_f32)
    aux = 0.0
    if ffn == "moe":
        h2, aux = moe_ffn(pp["moe"], h2, cfg)
    else:
        h2 = swiglu(h2, pp["ffn"]["w_gate"], pp["ffn"]["w_up"],
                    pp["ffn"]["w_down"], act=_mlp_act(cfg))
    if "post_ln2" in pp:
        h2 = rms_norm(h2, pp["post_ln2"], cfg.norm_eps, cfg.norm_f32)
    return h2, aux


def _index_tree(tree, i: int):
    """Period ``i`` of a stacked tree (views, no copy)."""
    return map_tree(lambda a: a[i], tree)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig,
            extra_embeds: Optional[torch.Tensor] = None,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) [+ extra_embeds (B, S_front, D), the modality stub
    prepended] → (logits (B, S_front + S, V_pad), aux_loss)."""
    x = embed(tokens, params["embed"],
              scale_by_dim=bool(cfg.local_global_period))
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
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
    """Next-token CE (+ MoE aux). batch: {tokens, labels[,
    extra_embeds]}; the logits of the prepended embeddings are
    dropped."""
    logits, aux = forward(params, batch["tokens"], cfg,
                          extra_embeds=batch.get("extra_embeds"),
                          remat=remat)
    n_front = logits.shape[1] - batch["labels"].shape[1]
    if n_front:
        logits = logits[:, n_front:]
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


# --------------------------------------------------------------------------
# Decode path
# --------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The decode cache's `TensorSpec`s by period position, each stacked
    ``(n_periods, ...)``: a `KVCache` of ``dtype`` for an attention
    layer (a local layer's at ``min(sliding_window, seq_len)``), an f32
    `SsmState` for an SSM layer."""
    _, layers = period_structure(cfg)
    np_ = n_periods(cfg)

    def stack(spec: TensorSpec) -> TensorSpec:
        return TensorSpec((np_,) + tuple(spec.shape), spec.dtype)

    structs = {}
    for i, (mixer, flavor, _ffn) in enumerate(layers):
        if mixer == "attn":
            length = seq_len
            if flavor == "local" and cfg.sliding_window:
                length = min(cfg.sliding_window, seq_len)
            sd = stack(KVCache.shape(cfg, batch, length, dtype))
            structs[f"L{i}"] = KVCache(k=sd, v=sd)
        else:
            structs[f"L{i}"] = map_tree(stack, ssm_state_structs(cfg, batch))
    return structs


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None,
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Zeros of `cache_spec` on ``device``."""
    return map_tree(lambda spec: spec.zeros(device),
                    cache_spec(cfg, batch, seq_len, dtype))


def decode_step(params, tokens: torch.Tensor, cache: Dict, pos: int,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One serve step: tokens (B, 1) at position ``pos`` (a host int) →
    (logits (B, 1, V_pad), cache). One Python loop over the periods;
    every period's cache is updated in place (a KV write at ``pos``, the
    SSM state and conv tail copied over) and the same dict returned."""
    x = embed(tokens, params["embed"],
              scale_by_dim=bool(cfg.local_global_period))
    _, layers = period_structure(cfg)
    for p_i in range(n_periods(cfg)):
        pp_all = _index_tree(params["blocks"], p_i)
        for i, (mixer, flavor, ffn) in enumerate(layers):
            pp = pp_all[f"L{i}"]
            c_i = map_tree(lambda a: a[p_i], cache[f"L{i}"])
            h = rms_norm(x, pp["ln1"], cfg.norm_eps, cfg.norm_f32)
            if mixer == "attn":
                window = cfg.sliding_window if flavor == "local" else None
                h, _ = decode_attention(pp["attn"], h, c_i, pos, cfg,
                                        window=window,
                                        attn_softcap_val=cfg.attn_softcap)
                if "post_ln1" in pp:
                    h = rms_norm(h, pp["post_ln1"], cfg.norm_eps,
                                 cfg.norm_f32)
            else:
                h, new = ssd_decode_step(pp["ssm"], h, c_i, cfg)
                c_i.s.copy_(new.s)
                c_i.conv.copy_(new.conv)
            x = x + h
            if ffn is not None:
                x = x + _ffn(cfg, pp, x, ffn)[0]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_f32)
    return _logits(params, x, cfg), cache
