"""Theorem 2: O(Δn + Δm) incremental update of the FINGER statistics.

The port's copy of `repro.core.incremental`. Given the state of G and a
delta ΔG carrying its pre-change weights ``w_old``, computes the state
of G' = G ⊕ ΔG:

  ΔS  = 2 Σ_{ΔE} Δw_ij
  ΔQ  = 2 Σ_{ΔV} s_i Δs_i + Σ_{ΔV} Δs_i² + 4 Σ_{ΔE} w_ij Δw_ij
        + 2 Σ_{ΔE} Δw_ij²
  Q'  = (Q - 1)/(1 + c ΔS)² - c'² ΔQ + 1,   c' = 1/(S + ΔS)

with eq. (3)'s s_max' = s_max + max(0, max_{ΔV}(s_i + Δs_i) - s_max).
A delta that empties the graph (S' within float-cancellation residue of
0) snaps to the canonical empty state (Q = 1, S = s_max = 0); a delta
that revives an empty graph uses c' = 1/S' directly.

Every function works on the trailing axes, so the same code serves one
stream and a stacked (B, ·) batch. ``method`` selects the Δ-statistics
path:

- ``dense``      : scatter-add into a dense (n,) Δs;
- ``compact``    : sorted-endpoint segment sums over the 2Δm endpoints;
- ``fused_tick`` : the compact statistics through the hand-written
  `repro_torch.kernels.delta_stats` kernel (its plain version on CPU).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.state import FingerState
from repro_torch.core.vnge import c_from_s_total
from repro_torch.graphs.types import (
    GraphDelta,
    gate_delta_by_nodes,
    in_range,
    node_mask_after_joins,
    node_mask_after_leaves,
    scatter_nodes,
    take_nodes,
)

__all__ = [
    "delta_stats",
    "delta_stats_compact",
    "delta_stats_from_sorted",
    "gate_delta_for_update",
    "h_tilde_after",
    "sorted_delta_endpoints",
    "update_state",
]

# A post-delta total strength below this fraction of the delta's own
# moved mass (2 Σ|Δw|) is float-cancellation residue of a
# delete-everything delta, not a real graph.
_EMPTY_RESIDUE_TOL = 1e-6


def delta_stats(state: FingerState, delta: GraphDelta):
    """(ΔS, ΔQ, dense Δs, max_{ΔV}(s_i + Δs_i)) for Theorem 2."""
    m = delta.mask
    dw = delta.dw * m
    s = state.strengths
    ds = scatter_nodes(torch.zeros_like(s), delta.senders, dw)
    ds = scatter_nodes(ds, delta.receivers, dw)
    delta_s_total = 2.0 * dw.sum(-1)
    node_term = (2.0 * s * ds + ds * ds).sum(-1)
    edge_term = ((4.0 * delta.w_old * dw + 2.0 * dw * dw) * m).sum(-1)
    touched = scatter_nodes(torch.zeros_like(s), delta.senders, m, "amax")
    touched = scatter_nodes(touched, delta.receivers, m, "amax")
    new_s = torch.where(touched > 0, s + ds, float("-inf"))
    return delta_s_total, node_term + edge_term, ds, new_s.amax(-1)


def sorted_delta_endpoints(strengths: torch.Tensor, delta: GraphDelta):
    """GraphDelta → (sorted ids, sorted Δw, sorted strengths, validity).

    The 2Δm endpoints are concatenated, masked or out-of-range slots map
    to the sentinel id n (which sorts last), and the touched strengths
    are gathered (0 on sentinel slots).
    """
    n = strengths.shape[-1]
    dw = delta.dw * delta.mask
    nodes = torch.cat([delta.senders, delta.receivers], -1)
    valid = torch.cat([delta.mask, delta.mask], -1) > 0
    valid = valid & in_range(nodes, n)
    nodes = torch.where(valid, nodes, n).to(torch.int32)
    vals = torch.where(valid, torch.cat([dw, dw], -1), 0.0)
    order = torch.argsort(nodes, dim=-1, stable=True)
    sorted_nodes = torch.gather(nodes, -1, order)
    sorted_vals = torch.gather(vals, -1, order)
    in_graph = sorted_nodes < n
    sorted_strengths = take_nodes(strengths, sorted_nodes)
    return sorted_nodes, sorted_vals, sorted_strengths, \
        in_graph.to(torch.float32)


def delta_stats_from_sorted(sorted_nodes, sorted_vals, sorted_strengths,
                            endpoint_valid, dwm, w_old):
    """Sorted-endpoint segment reduction → (..., 4) [ΔS, ΔQ, max s', |ΔV|].

    The plain version of the `delta_stats` kernel; ``dwm`` is the masked
    per-edge Δw. The max is -inf for an all-masked delta.
    """
    head = torch.ones_like(sorted_nodes, dtype=torch.bool)
    head[..., 1:] = sorted_nodes[..., 1:] != sorted_nodes[..., :-1]
    head = head & (endpoint_valid > 0)
    seg = (torch.cumsum(head.to(torch.int64), -1) - 1).clamp(min=0)
    seg_ds = torch.zeros_like(sorted_vals).scatter_add(-1, seg, sorted_vals)
    ds_here = torch.gather(seg_ds, -1, seg)
    node_term = torch.where(
        head, 2.0 * sorted_strengths * ds_here + ds_here * ds_here,
        0.0).sum(-1)
    edge_term = (4.0 * w_old * dwm + 2.0 * dwm * dwm).sum(-1)
    delta_s = 2.0 * dwm.sum(-1)
    max_new = torch.where(head, sorted_strengths + ds_here,
                          float("-inf")).amax(-1)
    n_touched = head.to(torch.float32).sum(-1)
    return torch.stack([delta_s, node_term + edge_term, max_new,
                        n_touched], -1)


def delta_stats_compact(state: FingerState, delta: GraphDelta):
    """(ΔS, ΔQ, max_{ΔV}(s_i + Δs_i)) without a dense Δs."""
    prep = sorted_delta_endpoints(state.strengths, delta)
    stats = delta_stats_from_sorted(*prep, delta.dw * delta.mask,
                                    delta.w_old)
    return stats[..., 0], stats[..., 1], stats[..., 2]


def _apply_delta_strengths(strengths: torch.Tensor,
                           delta: GraphDelta) -> torch.Tensor:
    """strengths + Δs via an O(Δm) endpoint scatter."""
    dwm = delta.dw * delta.mask
    out = scatter_nodes(strengths, delta.senders, dwm)
    return scatter_nodes(out, delta.receivers, dwm)


def gate_delta_for_update(state_node_mask, delta: GraphDelta):
    """Resolve the node dimension of one Theorem-2 step.

    Returns ``(gated_delta, mask_after_joins)``: joins apply to the
    state's node mask first, then edges touching a node inactive under
    that post-join mask — or outside the layout — are gated to zero.
    ``mask_after_joins`` is None for a legacy unmasked state.
    """
    mask = state_node_mask
    if mask is None:
        if delta.node_ids is not None:
            raise ValueError(
                "node join/leave delta applied to a state without a "
                "node_mask; build the state from a mask-aware graph "
                "(g.pad_to(n) / DenseGraph.from_weights(..., n_pad=...) "
                "/ StreamEngine.init_states) so the mask is part of the "
                "carried state")
        ok = in_range(delta.senders, delta.n_nodes) \
            & in_range(delta.receivers, delta.n_nodes)
        return dataclasses.replace(
            delta, mask=delta.mask * ok.to(delta.mask.dtype)), None
    if delta.node_ids is not None:
        mask = node_mask_after_joins(mask, delta)
    return gate_delta_by_nodes(delta, mask), mask


def update_state(state: FingerState, delta: GraphDelta,
                 exact_smax: bool = False,
                 method: str = "dense") -> FingerState:
    """Theorem 2 update: state(G) ⊕ ΔG → state(G').

    ``exact_smax=True`` takes s_max over the updated strength row (an
    O(n) beyond-paper fix that keeps H̃ exact under deletions); False
    follows eq. (3), which never decreases s_max. A delta addressed in
    a larger layout than the state's is rejected.
    """
    if state.layout is not None and delta.n_nodes > state.layout.n_pad:
        raise ValueError(
            f"update_state: delta is addressed in an n_pad="
            f"{delta.n_nodes} layout but the state's layout is n_pad="
            f"{state.layout.n_pad} (generation "
            f"{state.layout.generation}); migrate the state first")
    delta, mask_joined = gate_delta_for_update(state.node_mask, delta)
    if method == "dense":
        delta_s_total, delta_q_term, ds, max_new_s = \
            delta_stats(state, delta)
        strengths_new = state.strengths + ds
    elif method == "compact":
        delta_s_total, delta_q_term, max_new_s = \
            delta_stats_compact(state, delta)
        strengths_new = _apply_delta_strengths(state.strengths, delta)
    elif method == "fused_tick":
        # Imported lazily: the kernel package imports this module.
        from repro_torch.kernels.delta_stats.ops import delta_stats_fused

        delta_s_total, delta_q_term, max_new_s = delta_stats_fused(
            state, delta, pre_gated=True)
        strengths_new = _apply_delta_strengths(state.strengths, delta)
    else:
        raise ValueError(f"unknown delta-stats method {method!r}")

    s_total_raw = state.s_total + delta_s_total
    abs_moved = 2.0 * (delta.dw.abs() * delta.mask).sum(-1)
    empty = s_total_raw <= _EMPTY_RESIDUE_TOL * abs_moved

    c = state.c
    denom = 1.0 + c * delta_s_total
    denom = torch.where(denom.abs() > 1e-30, denom, 1e-30)
    c_new = c_from_s_total(s_total_raw)
    q_new = (state.q - 1.0) / (denom * denom) \
        - c_new * c_new * delta_q_term + 1.0
    q_new = torch.where(empty, 1.0, q_new)

    strengths_new = torch.where(empty[..., None], 0.0, strengths_new)
    mask_new = mask_joined
    if mask_new is not None:
        if delta.node_ids is not None:
            mask_new = node_mask_after_leaves(mask_new, delta)
        strengths_new = strengths_new * mask_new
    if exact_smax:
        s_max_new = strengths_new.amax(-1)
    else:
        d_s_max = torch.clamp(max_new_s - state.s_max, min=0.0)
        s_max_new = torch.where(empty, 0.0, state.s_max + d_s_max)

    return FingerState(
        q=q_new, s_total=torch.where(empty, 0.0, s_total_raw),
        s_max=s_max_new, strengths=strengths_new, node_mask=mask_new,
        layout=state.layout)


def h_tilde_after(state: FingerState, delta: GraphDelta,
                  exact_smax: bool = False, method: str = "dense"):
    """eq. (3): (H̃(G ⊕ ΔG), the updated state), in O(Δn + Δm)."""
    new_state = update_state(state, delta, exact_smax=exact_smax,
                             method=method)
    return new_state.h_tilde(), new_state
