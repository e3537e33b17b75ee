"""Unified model API: parameter defs, the loss, forward and decode
builders, and the decode cache.

The port's copy of `repro.models.api`. Every architecture exposes the
same surface:

  defs  = model_param_defs(cfg)
  loss  = build_loss_fn(cfg)(params, batch)
  fwd   = build_forward_fn(cfg)(params, batch)
  serve = build_decode_fn(cfg)(params, tokens, cache, pos)
  cache = init_cache_arrays(cfg, batch, seq_len, device=)

The encoder–decoder family (whisper) dispatches to `models.whisper`,
every other family to `models.transformer`. The reference's
`input_specs` and `input_logical_axes` (stand-ins and sharding axes for
its XLA dry-run on a TPU mesh) wait for ROADMAP Queue 1 items 3–4.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.models import transformer, whisper
from repro_torch.models.params import map_tree
from repro_torch.models.transformer import n_periods  # noqa: F401


def model_param_defs(cfg: ModelConfig) -> Dict:
    if cfg.is_encoder_decoder:
        return whisper.param_defs(cfg)
    return transformer.param_defs(cfg)


def build_loss_fn(cfg: ModelConfig, remat: bool = True):
    if cfg.is_encoder_decoder:
        def enc_dec_loss(params, batch):
            return whisper.loss_fn(params, batch, cfg)
        return enc_dec_loss

    def loss(params, batch):
        return transformer.lm_loss(params, batch, cfg, remat=remat)

    return loss


def build_forward_fn(cfg: ModelConfig, remat: bool = True):
    """Prefill path: full-sequence logits."""
    if cfg.is_encoder_decoder:
        def enc_dec_fwd(params, batch):
            enc = whisper.encode(params, batch["frames"], cfg)
            return whisper.decode_train(params, batch["tokens"], enc, cfg)
        return enc_dec_fwd

    def fwd(params, batch):
        logits, _ = transformer.forward(
            params, batch["tokens"], cfg,
            extra_embeds=batch.get("extra_embeds"), remat=remat)
        return logits

    return fwd


def build_decode_fn(cfg: ModelConfig):
    """(params, tokens (B, 1), cache, pos: int) → (logits (B, 1, V_pad),
    cache updated in place)."""
    module = whisper if cfg.is_encoder_decoder else transformer

    def step(params, tokens, cache, pos):
        return module.decode_step(params, tokens, cache, pos, cfg)

    return step


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The decode cache's `TensorSpec` tree: KV (and whisper's cross KV)
    in ``dtype``, the reference's bf16 by default; SSM states f32."""
    module = whisper if cfg.is_encoder_decoder else transformer
    return module.cache_spec(cfg, batch, seq_len, dtype)


def init_cache_arrays(cfg: ModelConfig, batch: int, seq_len: int,
                      device: Device = None,
                      dtype: torch.dtype = torch.bfloat16) -> Dict:
    """Zeros of `cache_spec` on ``device`` (``None`` is CUDA)."""
    device = resolve_device(device)
    return map_tree(lambda spec: spec.zeros(device),
                    cache_spec(cfg, batch, seq_len, dtype))
