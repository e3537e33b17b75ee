"""Mixture-of-Experts FFN: token-choice top-k routing with capacity-based
dispatch.

The port's copy of `repro.models.moe`. Under a `ShardingRules` with a
tensor-parallel degree above 1 the experts are padded to a multiple of
it (`effective_experts`; granite-moe-3b-a800m goes from 40 to 48) and
the padded experts' router logits are masked to -1e30, so no token is
routed to them. The capacity semantics are the reference's exactly:

- each (token, slot) pair gets a running position in its expert's
  buffer, counted in flattened (T·k) order;
- pairs past the capacity C = max(1, int(capacity_factor·T·k/E)) are
  dropped (combine weight zero);
- the aux loss is Switch-style, E · Σ_e frac_tokens(e) · mean_prob(e).

The dispatch scatter into the (E·C, D) buffer is an ``index_add`` into
a buffer with one spare row that takes the dropped pairs, as the
reference's ``mode="drop"`` write does; kept pairs own distinct rows, so
the add is a placement and rounds nothing.

On DTensors (a `DeviceMesh`) the routing and dispatch run under
`local_map`: each rank routes its own tokens (its batch rows) over all
experts, gathering the per-expert counts of the data-parallel ranks so
that every (token, slot) pair takes its global running position and
the capacity is the global one, then dispatches, computes and combines
only the pairs routed to its experts (the "model" axis, EP): each
device computes its experts for its tokens, as the reference's
``constrain(buf, ("experts", "batch", None))`` lays the buffer out.
The output is a partial sum over the expert ranks, reduced where the
next op needs it. The aux loss is each data rank's partial sum, the
same on every expert rank, so each leaves 1/n_ep of it and its
gradient is counted once.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (NO_SHARDING, ShardingRules,
                                              pad_to_multiple)
from repro_torch.models.layers import matmul
from repro_torch.models.params import PDef


def effective_experts(cfg: ModelConfig,
                      rules: ShardingRules = NO_SHARDING) -> int:
    """Experts padded to the TP degree (granite: 40 -> 48)."""
    tp = rules.tp_size if rules and rules.tensor else 1
    e = cfg.n_experts
    if tp > 1 and e % tp != 0:
        e = pad_to_multiple(e, tp)
    return e


def moe_param_defs(cfg: ModelConfig, n_layers: int,
                   rules: ShardingRules = NO_SHARDING):
    d, f = cfg.d_model, cfg.d_ff
    e = effective_experts(cfg, rules)
    L = n_layers
    # experts shard over "model" (EP); wide experts (f >= 4096) also
    # shard their hidden dim over the FSDP axis, narrow ones their
    # embed dim (the reference's choice)
    wide = f >= 4096
    ff_ax = "ff_data" if wide else None
    d_ax = None if wide else "embed"
    defs = {
        "router": PDef((L, d, e), ("layers", "embed", None)),
        "w_gate": PDef((L, e, d, f), ("layers", "experts", d_ax, ff_ax)),
        "w_up": PDef((L, e, d, f), ("layers", "experts", d_ax, ff_ax)),
        "w_down": PDef((L, e, f, d), ("layers", "experts", ff_ax, d_ax)),
    }
    if cfg.shared_expert:
        defs["sh_gate"] = PDef((L, d, f), ("layers", "embed", "ff"))
        defs["sh_up"] = PDef((L, d, f), ("layers", "embed", "ff"))
        defs["sh_down"] = PDef((L, f, d), ("layers", "ff", "embed"))
    return defs


class _DataGroup:
    """The tokens of one data-parallel rank among ``size``: the global
    token count, and the per-expert counts of every rank gathered, so
    that a rank's (token, slot) pairs take their global running
    positions (the ranks before it in the flattened token order)."""

    def __init__(self, mesh, dim: int, size: int, index: int, t_total: int):
        self.mesh, self.dim, self.size = mesh, dim, size
        self.index, self.t_total = index, t_total

    def counts(self, counts: torch.Tensor):
        """This rank's per-expert counts → (all ranks' sum, the sum over
        the ranks before this one)."""
        every = funcol.all_gather_tensor(counts[None], gather_dim=0,
                                         group=(self.mesh, self.dim))
        every = every.wait() if hasattr(every, "wait") else every
        return every.sum(0), every[: self.index].sum(0)


def _routed(xt, router, w_gate, w_up, w_down, cfg: ModelConfig, e: int,
            experts: Tuple[int, int], group: "_DataGroup" = None,
            aux_scale: float = 1.0):
    """Route the T tokens of ``xt`` (T, D) over ``e`` experts, then
    dispatch, compute and combine only the pairs routed to experts
    ``[e0, e1)`` (``w_*`` hold those experts) → (output (T, D), aux loss
    × ``aux_scale``). With a data ``group``, ``xt`` is this rank's share
    of the tokens: capacity, positions and the aux loss's fractions are
    the global ones, the aux loss this rank's partial sum."""
    t, d = xt.shape
    k = cfg.top_k
    logits = (xt @ router).float()
    if e != cfg.n_experts:  # mask padded experts out of routing
        logits = torch.where(torch.arange(e, device=xt.device)
                             >= cfg.n_experts, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)  # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)  # (T·k,)
    counts = torch.zeros(e, dtype=flat_e.dtype, device=xt.device) \
        .index_add_(0, flat_e, torch.ones_like(flat_e))
    if group is None:
        t_all, before = t, None
        frac = counts.float() / max(t * k, 1)
        aux = e * torch.sum(frac * torch.mean(probs, dim=0))
    else:
        t_all = group.t_total
        counts_all, before = group.counts(counts)
        frac = counts_all.float() / max(t_all * k, 1)
        aux = e * torch.sum(frac * probs.sum(0)) / t_all

    capacity = max(1, int(cfg.capacity_factor * t_all * k / e))

    # running position of each (token, slot) in its expert's buffer: a
    # stable sort by expert keeps the flattened (T·k) order within each
    # expert, and a pair's rank in its run is its position
    order = torch.argsort(flat_e, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.empty_like(flat_e)
    pos_in_e[order] = torch.arange(t * k, device=xt.device) \
        - starts[flat_e[order]]
    e0, e1 = experts
    keep = (pos_in_e < capacity) & (flat_e >= e0) & (flat_e < e1)
    if before is None:
        n_c, local = capacity, pos_in_e
    else:  # global positions; buffer rows for this rank's pairs only
        # (a token picks an expert once: at most t of them an expert)
        n_c = min(capacity, t)
        local = pos_in_e
        pos_in_e = pos_in_e + before[flat_e]
        keep = keep & (pos_in_e < capacity)
    rows = (e1 - e0) * n_c
    slot = (flat_e - e0) * n_c + torch.where(keep, local, 0)

    # dispatch: the spare last row takes the dropped pairs and is cut
    # off after; the token copies are a broadcast, so their gradient is
    # a plain sum
    src = xt[:, None].expand(t, k, d).reshape(t * k, d) \
        * keep[:, None].to(xt.dtype)
    buf = torch.zeros((rows + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_add(0, torch.where(keep, slot, rows), src)
    buf = buf[:rows].reshape(e1 - e0, n_c, d)

    g = torch.bmm(buf, w_gate)
    u = torch.bmm(buf, w_up)
    y = torch.bmm(F.silu(g) * u, w_down).reshape(rows, d)

    # combine: each pair's output back, weighted by its router prob
    gathered = y[torch.where(keep, slot, 0)]
    w = (top_p.reshape(-1) * keep.float()).to(xt.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(1)
    return out, aux * aux_scale


def _routed_dtensor(p, xt, cfg: ModelConfig, rules: ShardingRules, e: int):
    """`_routed` under `local_map` on a DTensor ``xt``: each rank routes
    its own tokens (its batch rows; positions and capacity global
    through the per-expert counts of the ranks before it) and dispatches,
    computes and combines only the pairs routed to its experts (see the
    module docstring)."""
    mesh = xt.device_mesh
    names = mesh.mesh_dim_names

    def mesh_dims(logical):
        entry = rules.spec_for((logical,))[0]
        axes = () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))
        return [names.index(a) for a in axes if a in names]

    ep = mesh_dims("experts")
    dp = [i for i, pl in enumerate(xt.placements)
          if isinstance(pl, Shard) and pl.dim == 0 and mesh.size(i) > 1]
    if len(dp) > 1:
        raise ValueError(f"moe_ffn: tokens split over {len(dp)} mesh axes; "
                         "fold them into one (sharding.fold_pods)")
    coord = mesh.get_coordinate()
    idx, parts = 0, 1
    for i in ep:
        idx, parts = idx * mesh.size(i) + coord[i], parts * mesh.size(i)
    size = -(-e // parts)
    experts = (idx * size, min((idx + 1) * size, e))
    t_total = xt.shape[0]
    group = _DataGroup(mesh, dp[0], mesh.size(dp[0]), coord[dp[0]],
                       t_total) if dp else None
    n_ep = math.prod(mesh.size(i) for i in ep)
    x_in = [Shard(0) if i in dp else Replicate() for i in range(mesh.ndim)]
    rep = [Replicate()] * mesh.ndim
    out = [Shard(0) if i in dp else Partial() if i in ep else Replicate()
           for i in range(mesh.ndim)]
    # the aux loss: a partial sum over the data ranks, and the same on
    # every expert rank, so 1/n_ep of it from each
    aux_pl = [Partial() if i in dp or i in ep else Replicate()
              for i in range(mesh.ndim)]
    x_grad = [Shard(0) if i in dp else Partial() if i in ep
              else Replicate() for i in range(mesh.ndim)]
    r_grad = [Partial() if i in dp or i in ep else Replicate()
              for i in range(mesh.ndim)]
    w_in = [Shard(0) if i in ep else Replicate() for i in range(mesh.ndim)]
    w_grad = [Shard(0) if i in ep else Partial() if i in dp
              else Replicate() for i in range(mesh.ndim)]

    def fn(x_l, r_l, wg_l, wu_l, wd_l):
        return _routed(x_l, r_l, wg_l, wu_l, wd_l, cfg, e, experts, group,
                       aux_scale=1.0 / n_ep)

    def dt(a):
        if isinstance(a, DTensor):
            return a

        return distribute_tensor(a, mesh, rep, src_data_rank=None)

    mapped = local_map(
        fn, out_placements=(out, aux_pl),
        in_placements=(x_in, rep, w_in, w_in, w_in),
        in_grad_placements=(x_grad, r_grad, w_grad, w_grad, w_grad),
        device_mesh=mesh, redistribute_inputs=True)
    return mapped(dt(xt), dt(p["router"]), dt(p["w_gate"]),
                  dt(p["w_up"]), dt(p["w_down"]))


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig,
            rules: ShardingRules = NO_SHARDING
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (output (B, S, D), aux load-balance loss scalar)."""
    b, s, d = x.shape
    e = effective_experts(cfg, rules)
    xt = x.reshape(b * s, d)
    if isinstance(xt, DTensor):
        out, aux = _routed_dtensor(p, xt, cfg, rules, e)
    else:
        out, aux = _routed(xt, p["router"], p["w_gate"], p["w_up"],
                           p["w_down"], cfg, e, (0, e))
    if cfg.shared_expert:
        out = out + matmul(F.silu(matmul(xt, p["sh_gate"]))
                           * matmul(xt, p["sh_up"]), p["sh_down"])
    return out.reshape(b, s, d), aux
