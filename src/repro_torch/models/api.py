"""Model API of the train path: parameter defs and the loss and forward
builders.

The port's copy of the train/prefill part of `repro.models.api`:

  defs = model_param_defs(cfg)
  loss = build_loss_fn(cfg)(params, batch)
  fwd  = build_forward_fn(cfg)(params, batch)

Decode (`build_decode_fn`, caches) waits for ROADMAP Queue 1 item 2.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def model_param_defs(cfg: ModelConfig) -> Dict:
    return transformer.param_defs(cfg)


def build_loss_fn(cfg: ModelConfig, remat: bool = True):
    transformer.check_ported(cfg)

    def loss(params, batch):
        return transformer.lm_loss(params, batch, cfg, remat=remat)

    return loss


def build_forward_fn(cfg: ModelConfig, remat: bool = True):
    """Prefill path: full-sequence logits."""
    transformer.check_ported(cfg)

    def fwd(params, batch):
        logits, _ = transformer.forward(params, batch["tokens"], cfg,
                                        remat=remat)
        return logits

    return fwd
