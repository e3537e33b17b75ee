"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-based
dispatch.

The port's copy of `repro.models.moe` for one device (no expert
padding: the reference pads experts only to a tensor-parallel degree
above 1). The capacity semantics are the reference's exactly:

- each (token, slot) pair gets a running position in its expert's
  buffer, counted in flattened (T·k) order;
- pairs past the capacity C = max(1, int(capacity_factor·T·k/E)) are
  dropped (combine weight zero);
- the aux loss is Switch-style, E · Σ_e frac_tokens(e) · mean_prob(e).

The dispatch scatter into the (E·C, D) buffer is an ``index_add`` into
a buffer with one spare row that takes the dropped pairs, as the
reference's ``mode="drop"`` write does; kept pairs own distinct rows, so
the add is a placement and rounds nothing.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import PDef


def effective_experts(cfg: ModelConfig) -> int:
    return cfg.n_experts


def moe_param_defs(cfg: ModelConfig, n_layers: int):
    d, f = cfg.d_model, cfg.d_ff
    e = effective_experts(cfg)
    L = n_layers
    defs = {
        "router": PDef((L, d, e), ("layers", "embed", None)),
        "w_gate": PDef((L, e, d, f), ("layers", "experts", None, None)),
        "w_up": PDef((L, e, d, f), ("layers", "experts", None, None)),
        "w_down": PDef((L, e, f, d), ("layers", "experts", None, None)),
    }
    if cfg.shared_expert:
        defs["sh_gate"] = PDef((L, d, f), ("layers", "embed", "ff"))
        defs["sh_up"] = PDef((L, d, f), ("layers", "embed", "ff"))
        defs["sh_down"] = PDef((L, f, d), ("layers", "ff", "embed"))
    return defs


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (output (B, S, D), aux load-balance loss scalar)."""
    b, s, d = x.shape
    e, k = effective_experts(cfg), cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    logits = (xt @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)  # (T·k,)
    counts = torch.bincount(flat_e, minlength=e)
    frac = counts.float() / max(t * k, 1)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))

    capacity = max(1, int(cfg.capacity_factor * t * k / e))

    # running position of each (token, slot) in its expert's buffer: a
    # stable sort by expert keeps the flattened (T·k) order within each
    # expert, and a pair's rank in its run is its position
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.empty_like(flat_e)
    pos_in_e[order] = torch.arange(t * k, device=x.device) \
        - starts[flat_e[order]]
    keep = pos_in_e < capacity
    slot = flat_e * capacity + torch.where(keep, pos_in_e, 0)

    # dispatch: row E·C takes the dropped pairs and is cut off after; the
    # token copies are a broadcast, so their gradient is a plain sum
    src = xt[:, None].expand(t, k, d).reshape(t * k, d) \
        * keep[:, None].to(xt.dtype)
    buf = torch.zeros((e * capacity + 1, d), dtype=xt.dtype, device=x.device)
    buf = buf.index_add(0, torch.where(keep, slot, e * capacity), src)
    buf = buf[: e * capacity].reshape(e, capacity, d)

    g = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    y = torch.bmm(F.silu(g) * u, p["w_down"]).reshape(e * capacity, d)

    # combine: each pair's output back, weighted by its router prob
    gathered = y[torch.where(keep, slot, 0)]
    w = (top_p.reshape(-1) * keep.float()).to(x.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(1)

    if cfg.shared_expert:
        out = out + (F.silu(xt @ p["sh_gate"]) * (xt @ p["sh_up"])) \
            @ p["sh_down"]
    return out.reshape(b, s, d), aux
