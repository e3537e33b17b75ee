"""Int8 error-feedback gradient compression.

The port's copy of `repro.distributed.compression`. Each gradient
tensor is quantized to int8 with one symmetric per-tensor scale; the
quantization error is carried to the next step as a residual (error
feedback), so the bias of the rounding does not accumulate. The train
step (`train.step.build_train_step(compress_grads=True)`) applies it to
the gradients before the optimizer, as the reference does.

Trees are the port's parameter trees (nested dicts of tensors); the
residuals are float32 and shaped like the parameters.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.params import flatten_names, map_tree, unflatten_names


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization → (q, scale)."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads, residuals):
    """(quantized-dequantized gradients in each gradient's dtype, new
    residuals): each gradient plus its residual is quantized, and what
    the quantization lost becomes the new residual."""
    flat_r = flatten_names(residuals)
    out_g, out_r = {}, {}
    for name, g in flatten_names(grads).items():
        g32 = g.to(torch.float32) + flat_r[name]
        deq = dequantize_int8(*quantize_int8(g32))
        out_g[name] = deq.to(g.dtype)
        out_r[name] = g32 - deq
    return unflatten_names(out_g), unflatten_names(out_r)


def init_residuals(params):
    """Zero float32 residuals shaped like ``params``, on their devices."""
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
