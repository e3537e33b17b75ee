"""The train and serve step builders.

The port's copy of `repro.train.step` for one device.
A step takes the loss and its gradients with `torch.autograd.grad` on
detached views of the parameters (no copy), then applies the AdamW
update in place (`optim/adamw.py`). With ``n_microbatches`` > 1 the
batch is split along its leading axis and the gradients accumulate in
``acc_dtype`` over a loop, as the reference's ``lax.scan`` does, then
scale by 1/m; the loss is the mean of the microbatch losses.

With ``compress_grads=True`` the step is ``(params, opt_state,
residuals, batch) → (params, opt_state, residuals, metrics)``: the
gradients pass through `distributed.compression.compress_with_feedback`
(int8 with error feedback, the residuals carried from step to step)
before the update, as in the reference. `build_serve_step` is one
greedy decode step under ``torch.no_grad``, its argmax left on the
device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.compression import compress_with_feedback
from repro_torch.models.api import build_decode_fn, build_loss_fn
from repro_torch.models.params import flatten_names, unflatten_names
from repro_torch.optim.adamw import AdamWConfig, apply_update


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     compress_grads: bool = False, remat: bool = True,
                     n_microbatches: int = 1,
                     acc_dtype: torch.dtype = torch.float32):
    """(params, opt_state, batch) → (params, opt_state, metrics); with
    ``compress_grads``, (params, opt_state, residuals, batch) →
    (params, opt_state, residuals, metrics)."""
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches={n_microbatches} must be >= 1")
    loss_fn = build_loss_fn(cfg, remat=remat)

    def value_and_grad(params, batch) -> Tuple[torch.Tensor, Dict]:
        flat = {k: v.detach().requires_grad_(True)
                for k, v in flatten_names(params).items()}
        loss = loss_fn(unflatten_names(flat), batch)
        grads = torch.autograd.grad(loss, list(flat.values()))
        return loss.detach(), dict(zip(flat, grads))

    def grads_of(params, batch):
        if n_microbatches == 1:
            loss, grads = value_and_grad(params, batch)
            return loss, unflatten_names(
                {k: g.to(acc_dtype) for k, g in grads.items()})
        m = n_microbatches
        for key, x in batch.items():
            if x.shape[0] % m:
                raise ValueError(f"batch[{key!r}] of leading size "
                                 f"{x.shape[0]} does not split into "
                                 f"{m} microbatches")
        acc, losses = None, []
        for i in range(m):
            mb = {k: x.reshape(m, x.shape[0] // m, *x.shape[1:])[i]
                  for k, x in batch.items()}
            loss, grads = value_and_grad(params, mb)
            losses.append(loss)
            if acc is None:
                acc = {k: torch.zeros(g.shape, dtype=acc_dtype,
                                      device=g.device) for k, g in
                       grads.items()}
            for k, g in grads.items():
                acc[k] = acc[k] + g.to(acc_dtype)
        inv = 1.0 / m
        return torch.stack(losses).mean(), unflatten_names(
            {k: g * inv for k, g in acc.items()})

    if compress_grads:
        def compressed_step(params, opt_state, residuals, batch):
            loss, grads = grads_of(params, batch)
            grads, residuals = compress_with_feedback(grads, residuals)
            params, opt_state, metrics = apply_update(
                params, grads, opt_state, opt_cfg)
            metrics["loss"] = loss
            return params, opt_state, residuals, metrics

        return compressed_step

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, metrics = apply_update(params, grads, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def build_serve_step(cfg: ModelConfig, greedy: bool = True):
    """(params, tokens (B, 1), cache, pos: int) → (next_tok int32
    (B, 1), logits (B, 1, V_pad), cache). The next token is the argmax
    on the device (``greedy``; otherwise the input tokens, as in the
    reference); nothing is copied to the host."""
    decode = build_decode_fn(cfg)

    @torch.no_grad()
    def serve_step(params, tokens, cache, pos):
        logits, cache = decode(params, tokens, cache, pos)
        if greedy:
            next_tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        else:
            next_tok = tokens
        return next_tok.to(torch.int32), logits, cache

    return serve_step
