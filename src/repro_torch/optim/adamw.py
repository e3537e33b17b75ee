"""AdamW with global-norm clipping and a warmup-cosine schedule.

The port's copy of `repro.optim.adamw`, written as plain tensor
functions that repeat the reference's arithmetic in float32: clip by
the global gradient norm, bias correction, weight decay decoupled from
the adaptive step, and the learning rate taken at the *old* step.
`torch.optim.AdamW` is a different update (where eps sits, no
clipping), so it is not used.

`apply_update` updates the parameters and both moments **in place**
(the PyTorch counterpart of the reference's donated buffers): at
granite-moe's full width one copy of params + moments is 10.6 GB, which
the update would otherwise hold twice. It returns the same dicts and a
new `AdamWState` around the same moment tensors with the step advanced.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.models.params import flatten_names, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict  # first moments, f32, param-shaped
    nu: dict  # second moments, f32, param-shaped


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then cosine to ``lr_min``; f32."""
    warm = cfg.lr_peak * (step + 1) / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) \
        * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> AdamWState:
    leaves = list(flatten_names(params).values())
    device = leaves[0].device if leaves else None
    zeros = lambda: map_tree(  # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros())


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten_names(tree).values()))


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, cfg: AdamWConfig
                 ) -> Tuple[dict, AdamWState, dict]:
    """One AdamW step, in place. Returns (params, state', metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, state.step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    flat_g = flatten_names(grads)
    flat_m = flatten_names(state.mu)
    flat_v = flatten_names(state.nu)
    for name, p in flatten_names(params).items():
        g = flat_g[name].float() * scale
        m, v = flat_m[name], flat_v[name]
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
