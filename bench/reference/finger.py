"""Plain reference: FINGER-H̃ and the Jensen–Shannon distance of the
seed-defined graphs, worked out from the graphs themselves.

For one stream it makes the stream's graph again from the seed
(`bench.graphs`), applies the cycle's deltas to its own edge weights (it
reads only their pairs, changes and node slots, never ``w_old``), and
for each graph of the cycle computes

  S = Σ_i s_i,  Q = 1 − (Σ_i s_i² + 2 Σ_E w²) / S²,
  H̃ = −Q ln(2 s_max / S)   (0 on an empty graph),
  JSdist(G, G') = sqrt(max(H̃(Ḡ) − ½ (H̃(G) + H̃(G')), 0)),  Ḡ = (G + G')/2,

over the whole strength row each time: no incremental update. It
imports nothing of the program and takes nothing the program made.

A delta means what `GraphDelta` documents: joins first, then each
live lane whose two endpoints are live and inside the layout changes its
edge by ``dw``, then leaves. ``dtype`` float64 is the reference;
bfloat16 is the control, the reference put in the program's place one
precision below the float32 the configuration states.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench import graphs


def graph_stats(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
                n_pad: int) -> Dict[str, torch.Tensor]:
    """S, Q, s_max, H̃ and the strength row of one graph, in ``w``'s
    dtype."""
    s = torch.zeros(n_pad, dtype=w.dtype, device=w.device)
    s.index_add_(0, lo, w)
    s.index_add_(0, hi, w)
    s_total = s.sum()
    sum_s2 = (s * s).sum()
    sum_w2 = (w * w).sum()
    s_max = s.max()
    empty = s_total <= 0
    c = torch.where(empty, torch.zeros_like(s_total),
                    1.0 / torch.where(empty, torch.ones_like(s_total),
                                      s_total))
    q = 1.0 - c * c * (sum_s2 + 2.0 * sum_w2)
    arg = torch.clamp(2.0 * c * s_max, min=1e-30)
    h = torch.where(empty, torch.zeros_like(q), -q * torch.log(arg))
    return {"s_total": s_total, "q": q, "s_max": s_max, "h": h,
            "strengths": s}


def cycle(graph_spec: dict, seed: int, stream: int,
          deltas: Dict[str, np.ndarray], n_pad: int,
          dtype: torch.dtype = torch.float64, device="cpu") -> dict:
    """One stream over one cycle of deltas (each field (period, ·)).

    Returns ``scores`` (period,) — the distance of tick t, between the
    graph before it and the graph after it — and ``states``, a function
    of t giving the graph after t ticks (t in [0, period]): ``q``,
    ``s_total``, ``s_max``, ``strengths`` and ``node_mask`` as numpy
    float64. The graph is made on ``device``, where the set-up made it.
    """
    g = graphs.stream_graph(graph_spec, seed, stream, device=device)
    return cycle_from(g["lo"], g["hi"], g["w"], g["n_live"], deltas, n_pad,
                      dtype, device)


def cycle_from(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
               n_live: int, deltas: Dict[str, np.ndarray], n_pad: int,
               dtype: torch.dtype = torch.float64, device="cpu") -> dict:
    """`cycle` from an explicit graph: its edges ``lo < hi`` (sorted by
    pair, int64), their float64 weights ``w`` and its first ``n_live``
    live nodes."""
    g = {"w": w.to(device=device, dtype=torch.float64), "n_live": n_live}
    base = lo.to(device) << graphs.NODE_BITS | hi.to(device)
    d = {f: torch.as_tensor(v, device=device) for f, v in deltas.items()}
    period = d["dw"].shape[0]
    lo_d = torch.minimum(d["senders"], d["receivers"]).long()
    hi_d = torch.maximum(d["senders"], d["receivers"]).long()
    lane_key = lo_d << graphs.NODE_BITS | hi_d
    lanes = d["mask"] > 0
    touched = torch.unique(lane_key[lanes])
    pos = torch.searchsorted(base, touched).clamp(max=base.numel() - 1)
    extra = touched[base[pos] != touched]
    keys = torch.cat([base, extra])
    w = torch.cat([g["w"], torch.zeros(extra.numel(), dtype=torch.float64,
                                       device=device)])
    sorted_keys, order = torch.sort(keys)
    slot_of = order[torch.searchsorted(sorted_keys, lane_key).clamp(
        max=keys.numel() - 1)]

    live = torch.zeros(n_pad, dtype=torch.bool, device=device)
    live[:g["n_live"]] = True
    weights, masks = [w], [live.clone()]
    for t in range(period):
        ids, flag = d["node_ids"][t].long(), d["node_flag"][t]
        inside = (ids >= 0) & (ids < n_pad)
        live[ids[inside & (flag > 0)]] = True
        ok = lanes[t] & (lo_d[t] >= 0) & (hi_d[t] < n_pad)
        ok &= live[lo_d[t].clamp(0, n_pad - 1)] \
            & live[hi_d[t].clamp(0, n_pad - 1)]
        w = w.index_add(0, slot_of[t][ok], d["dw"][t][ok].to(torch.float64))
        live[ids[inside & (flag < 0)]] = False
        weights.append(w)
        masks.append(live.clone())

    _, lo_k, hi_k = graphs.split_keys(keys)

    def stats(wt: torch.Tensor) -> Dict[str, torch.Tensor]:
        return graph_stats(lo_k, hi_k, wt.to(dtype), n_pad)

    full = [stats(wt) for wt in weights]
    scores = np.empty(period)
    for t in range(period):
        mid = stats(0.5 * (weights[t] + weights[t + 1]))["h"]
        div = mid - 0.5 * (full[t]["h"] + full[t + 1]["h"])
        scores[t] = float(torch.sqrt(torch.clamp(div, min=0.0)))

    def states(t: int) -> dict:
        st = full[t]
        out = {k: float(st[k]) for k in ("q", "s_total", "s_max")}
        out["strengths"] = st["strengths"].double().cpu().numpy()
        out["node_mask"] = masks[t].double().cpu().numpy()
        return out

    return {"scores": scores, "states": states}


def batch_scalars(graph_spec: dict, seed: int, streams: torch.Tensor,
                  deltas: Dict[str, torch.Tensor], n_pad: int,
                  ticks: int) -> Dict[str, torch.Tensor]:
    """Q, S and s_max of a block of streams after the first ``ticks``
    deltas of the cycle (each field (period, rows, ·)), in float64 on
    ``streams``' device: the whole strength row of each stream, so that
    the exact s_max of many streams is checked, not only of those whose
    rows are compared."""
    dev, f64 = streams.device, torch.float64
    rows = streams.numel()
    keys, _, w = graphs.edges(graph_spec, seed, streams)
    row, lo, hi = graphs.split_keys(keys)
    s = torch.zeros(rows * n_pad, dtype=f64, device=dev)
    s.index_add_(0, row * n_pad + lo, w)
    s.index_add_(0, row * n_pad + hi, w)
    sum_w2 = torch.zeros(rows, dtype=f64, device=dev)
    sum_w2.index_add_(0, row, w * w)
    live = (torch.arange(n_pad, device=dev)[None, :]
            < graphs.n_live(graph_spec, seed, streams)[:, None]).reshape(-1)

    d = {f: v[:ticks].to(dev) for f, v in deltas.items()}
    lane_row = torch.arange(rows, device=dev)[None, :, None].expand_as(
        d["senders"]).long()
    a, b = d["senders"].long(), d["receivers"].long()
    pair = graphs.pair_key(lane_row, a.clamp(0, n_pad - 1),
                           b.clamp(0, n_pad - 1))
    uniq, pid = torch.unique(pair.reshape(-1), return_inverse=True)
    pid = pid.view_as(pair)
    pos = torch.searchsorted(keys, uniq).clamp(max=max(keys.numel() - 1, 0))
    base = torch.where(keys[pos] == uniq, w[pos], 0.0)
    cur = base.clone()
    node_row = torch.arange(rows, device=dev)[:, None] * n_pad
    for t in range(ticks):
        ids, flag = d["node_ids"][t].long(), d["node_flag"][t]
        inside = (ids >= 0) & (ids < n_pad)
        at = (node_row + ids.clamp(0, n_pad - 1)).reshape(-1)
        join = (inside & (flag > 0)).reshape(-1)
        live[at[join]] = True
        ok = (d["mask"][t] > 0) & (a[t] >= 0) & (a[t] < n_pad) \
            & (b[t] >= 0) & (b[t] < n_pad)
        ia = node_row + a[t].clamp(0, n_pad - 1)
        ib = node_row + b[t].clamp(0, n_pad - 1)
        ok &= live[ia] & live[ib]
        dw = torch.where(ok, d["dw"][t].to(f64), 0.0)
        s.index_add_(0, ia.reshape(-1), dw.reshape(-1))
        s.index_add_(0, ib.reshape(-1), dw.reshape(-1))
        cur.index_add_(0, pid[t].reshape(-1), dw.reshape(-1))
        leave = (inside & (flag < 0)).reshape(-1)
        live[at[leave]] = False
    sum_w2.index_add_(0, uniq >> (2 * graphs.NODE_BITS),
                      cur * cur - base * base)
    s = s.view(rows, n_pad)
    s_total = s.sum(1)
    c = torch.where(s_total > 0, 1.0 / s_total, 0.0)
    return {"q": 1.0 - c * c * ((s * s).sum(1) + 2.0 * sum_w2),
            "s_total": s_total, "s_max": s.amax(1)}
