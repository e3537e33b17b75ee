"""Unified model API: parameter defs, the loss, forward and decode
builders, and the decode cache.

The port's copy of `repro.models.api`. Every architecture exposes the
same surface:

  defs  = model_param_defs(cfg, rules=)
  loss  = build_loss_fn(cfg, rules=)(params, batch)
  fwd   = build_forward_fn(cfg, rules=)(params, batch)
  serve = build_decode_fn(cfg, rules=)(params, tokens, cache, pos)
  cache = init_cache_arrays(cfg, batch, seq_len, device=, rules=)
  specs = input_specs(cfg, shape, rules)   # TensorSpecs only

The encoder–decoder family (whisper) dispatches to `models.whisper`,
every other family to `models.transformer`. ``rules`` is the
reference's positional `ShardingRules`, a keyword here that defaults to
`NO_SHARDING`. The built functions take plain tensors or DTensors
(parameters laid out by `params.param_shardings`); on DTensors they run
under DTensor's implicit replication, so the tensors a model makes
itself (positions, masks, RoPE tables) count as replicated.
`input_specs` / `input_logical_axes` are the dry run's stand-ins
(`TensorSpec`s) and their logical axes.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import NO_SHARDING, ShardingRules
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models import transformer, whisper
from repro_torch.models.params import TensorSpec, flatten_names, map_tree
from repro_torch.models.transformer import n_periods  # noqa: F401


def spmd(*trees):
    """DTensor's implicit replication while any leaf of ``trees`` is a
    DTensor (plain tensors then count as replicated); a no-op context
    otherwise. Nests: an inner exit leaves an outer one in force."""
    for tree in trees:
        if any(isinstance(v, DTensor)
               for v in flatten_names(tree).values()):
            return _implicit_replication()
    return contextlib.nullcontext()


@contextlib.contextmanager
def _implicit_replication():
    # `implicit_replication()` resets the flag on exit even when an
    # outer context set it; this restores what was there

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def model_param_defs(cfg: ModelConfig,
                     rules: ShardingRules = NO_SHARDING) -> Dict:
    if cfg.is_encoder_decoder:
        return whisper.param_defs(cfg, rules)
    return transformer.param_defs(cfg, rules)


def build_loss_fn(cfg: ModelConfig, remat: bool = True,
                  rules: ShardingRules = NO_SHARDING):
    if cfg.is_encoder_decoder:
        def enc_dec_loss(params, batch):
            with spmd(params):
                return whisper.loss_fn(params, batch, cfg, rules)
        return enc_dec_loss

    def loss(params, batch):
        with spmd(params):
            return transformer.lm_loss(params, batch, cfg, remat=remat,
                                       rules=rules)

    return loss


def build_forward_fn(cfg: ModelConfig, remat: bool = True,
                     rules: ShardingRules = NO_SHARDING):
    """Prefill path: full-sequence logits."""
    if cfg.is_encoder_decoder:
        def enc_dec_fwd(params, batch):
            with spmd(params):
                enc = whisper.encode(params, batch["frames"], cfg, rules)
                return whisper.decode_train(params, batch["tokens"], enc,
                                            cfg, rules)
        return enc_dec_fwd

    def fwd(params, batch):
        with spmd(params):
            logits, _ = transformer.forward(
                params, batch["tokens"], cfg,
                extra_embeds=batch.get("extra_embeds"), remat=remat,
                rules=rules)
        return logits

    return fwd


def build_decode_fn(cfg: ModelConfig, rules: ShardingRules = NO_SHARDING):
    """(params, tokens (B, 1), cache, pos: int) → (logits (B, 1, V_pad),
    cache updated in place)."""
    module = whisper if cfg.is_encoder_decoder else transformer

    def step(params, tokens, cache, pos):
        with spmd(params):
            return module.decode_step(params, tokens, cache, pos, cfg,
                                      rules)

    return step


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16,
               rules: ShardingRules = NO_SHARDING):
    """The decode cache's `TensorSpec` tree: KV (and whisper's cross KV)
    in ``dtype``, the reference's bf16 by default; SSM states f32."""
    module = whisper if cfg.is_encoder_decoder else transformer
    return module.cache_spec(cfg, batch, seq_len, dtype, rules)


def cache_axes(cfg: ModelConfig, rules: ShardingRules = NO_SHARDING):
    """The logical axes of `cache_spec`'s tree, leaf for leaf: with
    `cache_spec`, the reference's ``cache_spec`` → ``(structs, axes)``."""
    module = whisper if cfg.is_encoder_decoder else transformer
    return module.cache_axes(cfg, rules)


def init_cache_arrays(cfg: ModelConfig, batch: int, seq_len: int,
                      device: Device = None,
                      dtype: torch.dtype = torch.bfloat16,
                      rules: ShardingRules = NO_SHARDING) -> Dict:
    """Zeros of `cache_spec` on ``device`` (``None`` is CUDA)."""
    device = resolve_device(device)
    return map_tree(lambda spec: spec.zeros(device),
                    cache_spec(cfg, batch, seq_len, dtype, rules))


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: ShardingRules = NO_SHARDING) -> Dict:
    """`TensorSpec` stand-ins for every model input of this cell.

    train    : {tokens (B,S), labels (B,S)[, frames/extra_embeds]}
    prefill  : {tokens (B,S)[, frames/extra_embeds]}
    decode   : {tokens (B,1), cache, pos ()}
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def tok(*sh):
        return TensorSpec(tuple(sh), i32)

    if shape.kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            specs = {"frames": TensorSpec((b, cfg.encoder_seq, cfg.d_model),
                                          torch.bfloat16),
                     "tokens": tok(b, s)}
        elif cfg.frontend == "vision_stub":
            nf = cfg.n_frontend_tokens
            specs = {"tokens": tok(b, s - nf),
                     "extra_embeds": TensorSpec((b, nf, cfg.d_model),
                                                torch.bfloat16)}
        else:
            specs = {"tokens": tok(b, s)}
        if shape.kind == "train":
            specs["labels"] = tok(*specs["tokens"].shape)
        return specs
    # decode: one new token against a seq_len cache
    return {"tokens": tok(b, 1),
            "cache": cache_spec(cfg, b, s, rules=rules),
            "pos": tok()}


def input_logical_axes(cfg: ModelConfig, shape: ShapeConfig,
                       rules: ShardingRules = NO_SHARDING) -> Dict:
    """Logical sharding axes matching `input_specs`' structure."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("batch", None)}
        if cfg.is_encoder_decoder:
            axes["frames"] = ("batch", None, None)
        elif cfg.frontend == "vision_stub":
            axes["extra_embeds"] = ("batch", None, None)
        if shape.kind == "train":
            axes["labels"] = ("batch", None)
        return axes
    return {"tokens": ("batch", None), "cache": cache_axes(cfg, rules),
            "pos": ()}
