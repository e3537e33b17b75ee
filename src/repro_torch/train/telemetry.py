"""FINGER telemetry probes of the training path.

The port's copy of `repro.train.telemetry`. The model emits two graph
sequences while it trains:

1. **Attention graphs**: `attention_entropy_probe` recomputes the first
   attention layer's logits on a probe slice and takes each head's
   FINGER-H̃ through the ``entropy_probe`` kernels, without writing the
   softmax matrix to device memory.
2. **MoE routing graphs**: `routing_graph` builds the expert
   co-activation graph of the first MoE layer on a batch, and
   `RoutingGraphTracker` keeps FINGER-JS distances between consecutive
   graphs (H̃ of each through the ``vnge_q`` kernel) with z-score
   anomaly flags.

The probes run under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.jsdist import js_from_entropies
from repro_torch.core.vnge import h_tilde_from_stat_vector
from repro_torch.graphs.types import DenseGraph
from repro_torch.kernels.entropy_probe.ops import attention_graph_entropy
from repro_torch.kernels.vnge_q.ops import vnge_q_stats
from repro_torch.models.attention import qkv_project
from repro_torch.models.layers import embed, rms_norm
from repro_torch.models.transformer import period_structure


def _first_layer(tree):
    if isinstance(tree, dict):
        return {k: _first_layer(v) for k, v in tree.items()}
    return tree[0]


@torch.no_grad()
def attention_probe_logits(params, tokens: torch.Tensor, cfg: ModelConfig,
                           probe_len: int = 256) -> Optional[torch.Tensor]:
    """The first attention layer's causal-masked logits on the first
    ``probe_len`` tokens, (B·H, S, S) f32; None for an attention-free
    architecture."""
    _, layers = period_structure(cfg)
    attn_idx = next((i for i, (m, _, _) in enumerate(layers) if m == "attn"),
                    None)
    if attn_idx is None:
        return None
    toks = tokens[:, :probe_len]
    x = embed(toks, params["embed"],
              scale_by_dim=bool(cfg.local_global_period))
    pp = _first_layer(params["blocks"][f"L{attn_idx}"])
    h = rms_norm(x, pp["ln1"], cfg.norm_eps)
    positions = torch.arange(toks.shape[1], device=toks.device)[None] \
        .expand(toks.shape)
    q, k, _ = qkv_project(pp["attn"], h, positions, cfg)
    rep = q.shape[2] // max(k.shape[2], 1)
    k = torch.repeat_interleave(k, rep, dim=2)[:, :, : q.shape[2]]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    # causal mask: the probe analyses the graph the model actually uses
    s = toks.shape[1]
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                 device=logits.device))
    logits = torch.where(mask, logits, -1e30)
    return logits.reshape(-1, s, s)


def attention_entropy_probe(params, tokens: torch.Tensor, cfg: ModelConfig,
                            probe_len: int = 256
                            ) -> Optional[torch.Tensor]:
    """Per-head VNGE of the first attention layer's graph, (B·H,) f32;
    None for an attention-free architecture."""
    logits = attention_probe_logits(params, tokens, cfg, probe_len)
    return None if logits is None else attention_graph_entropy(logits)


@torch.no_grad()
def routing_graph(params, batch, cfg: ModelConfig,
                  probe_tokens: int = 4096) -> Optional[DenseGraph]:
    """Expert co-activation graph of the first MoE layer on this batch."""
    if not cfg.n_experts:
        return None
    _, layers = period_structure(cfg)
    moe_idx = next((i for i, (_, _, f) in enumerate(layers) if f == "moe"),
                   None)
    if moe_idx is None:
        return None
    x = embed(batch["tokens"], params["embed"],
              scale_by_dim=bool(cfg.local_global_period))
    pp = _first_layer(params["blocks"][f"L{moe_idx}"])
    xt = x.reshape(-1, x.shape[-1])[:probe_tokens]
    logits = xt @ pp["moe"]["router"]
    k = max(cfg.top_k, 2)  # pairs need two; top-1 archs take top-2
    _, top_e = torch.topk(logits, k, dim=-1)
    e = cfg.n_experts
    w = torch.zeros((e, e), dtype=torch.float32, device=xt.device)
    ones = torch.ones(top_e.shape[0], dtype=torch.float32, device=xt.device)
    for a in range(k):
        for b in range(a + 1, k):
            w.index_put_((top_e[:, a], top_e[:, b]), ones, accumulate=True)
    w = w + w.T
    w = w * (1.0 - torch.eye(e, device=w.device))
    return DenseGraph(weights=w, n_nodes=e)


def _h_tilde_dense(g: DenseGraph) -> torch.Tensor:
    """H̃ of a dense graph (eq. 2) through the ``vnge_q`` kernel; an
    empty graph gives the reference's unguarded value, not 0."""
    return h_tilde_from_stat_vector(vnge_q_stats(g.weights),
                                    empty_is_zero=False)


@dataclasses.dataclass
class RoutingGraphTracker:
    """JS-distance stream over routing graphs + z-score anomaly flags."""

    z_threshold: float = 3.0
    prev: Optional[DenseGraph] = None
    distances: List[float] = dataclasses.field(default_factory=list)
    anomalies: List[int] = dataclasses.field(default_factory=list)

    def update(self, g: Optional[DenseGraph], step: int) -> Optional[float]:
        if g is None:
            return None
        if self.prev is None:
            self.prev = g
            return None
        avg = DenseGraph(weights=0.5 * (g.weights + self.prev.weights),
                         n_nodes=g.n_nodes)
        d = float(js_from_entropies(_h_tilde_dense(avg),
                                    _h_tilde_dense(self.prev),
                                    _h_tilde_dense(g)))
        self.prev = g
        hist = self.distances
        if len(hist) >= 8:
            mu = float(np.mean(hist))
            sd = float(np.std(hist)) + 1e-9
            if (d - mu) / sd > self.z_threshold:
                self.anomalies.append(step)
        self.distances.append(d)
        return d
