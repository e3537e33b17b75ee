"""Deterministic synthetic data pipeline.

The port's copy of `repro.data.pipeline`. A batch is a pure function of
(seed, step), so a resumed job regenerates exactly the tokens it would
have seen. The recipe is the reference's — a 64-symbol alphabet, a
0.75 copy mask, a roll by one — drawn from a `torch.Generator` seeded
from (seed, step). The tokens therefore differ from the JAX package's
threefry draws for the same (seed, step); the parity tests feed both
packages the same numpy batches instead.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import Device, resolve_device


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int,
                    step: int, device: Device = None
                    ) -> Dict[str, torch.Tensor]:
    """{tokens, labels} (batch, seq) int64: Markov-ish tokens with
    learnable structure, drawn on the host and moved to ``device``
    (``None`` is CUDA). An encoder–decoder config adds ``frames``
    (batch, encoder_seq, d_model) and the vision stub ``extra_embeds``
    (batch, n_frontend_tokens, d_model): standard normals times 0.02,
    f32, from the same generator."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed((int(seed) << 32) + int(step))
    v_eff = min(cfg.vocab_size, 64)
    base = torch.randint(0, v_eff, (batch, seq + 1), generator=gen)
    mask = torch.rand((batch, seq + 1), generator=gen) < 0.75
    toks = torch.where(mask, torch.roll(base, 1, dims=1), base)
    out = {"tokens": toks[:, :-1].to(device),
           "labels": toks[:, 1:].to(device)}
    front = None
    if cfg.is_encoder_decoder:
        front = "frames", cfg.encoder_seq
    elif cfg.frontend == "vision_stub":
        front = "extra_embeds", cfg.n_frontend_tokens
    if front is not None:
        key, n = front
        out[key] = (torch.randn((batch, n, cfg.d_model), generator=gen)
                    * 0.02).to(device)
    return out
