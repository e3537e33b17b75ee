"""The one traffic generator: a cycle of deltas drawn from a mix file.

A mix (``bench/mixes/<name>.json``) gives the parameters; this module
turns them and a seed into the deltas of every stream. The deltas form a
cycle of ``2 * cycle_ticks`` ticks: ``cycle_ticks`` forward ticks whose
lanes touch distinct edges of each stream, then their exact inverses in
reverse order (an edge that flaps, then flaps back). So

- every ``w_old`` is exact: in the forward half an edge is touched once,
  so its old weight is the generator's weight (0 for a pair the graph
  lacks), and the inverse of a lane carries the weight the forward lane
  left; every weight and change is a multiple of 2^-12 below 2, exact
  in float32;
- after each full cycle every stream's graph is its start again, so a
  run can go on for any number of ticks, and the graph after tick i is
  the graph after tick ``i mod period``, with no mirror of the edges;
- the host keeps one cycle of deltas, whatever the window's length.

Mix parameters (fractions are of the streams or lanes named):

- ``active_share`` (1 where the key is absent): the share of streams
  that send a delta in a tick, drawn from the seed for each stream and
  forward tick; every other stream sends an empty delta (no live lane,
  no node flag, padded to k_pad and j_pad), and so does it in that
  tick's inverse;
- ``stream_zipf``, ``rate_scale``: a stream that sends a delta in a
  tick sends 1 to k_pad changes. A stream's rate of changes is
  ``rate_scale · u^-stream_zipf`` for a uniform ``u`` drawn once for the
  stream (a Pareto weight: a Zipf law over the streams' ranks), and a
  tick's count of live lanes is that rate times an exponential draw
  (bursts), rounded up, at least 1 and at most k_pad;
- ``existing_share``: live lanes on an edge the graph has; of those
  ``delete_share`` are deleted and the rest re-weighted by a uniform
  factor within ``±reweight``. A stream's changed edges are spread
  evenly over ``v`` in [0, 1) from a random start and sit at position
  ``floor(m · v^edge_skew)`` of its m edges sorted by pair, so above 1
  they crowd onto the lowest ids, the hubs;
- the other live lanes name a pair the graph lacks; ``add_share`` of
  them add it with a weight in ``add_weight``, the rest change nothing;
- ``join_share``: streams in which an inactive node joins;
  ``toggle_share``: streams in which an isolated node leaves (its
  inverse brings it back);
- ``candidates``: draws of the partner of an absent pair before the lane
  is dropped (every draw an edge the graph has, or a repeat).

Two lanes of a forward half that name one pair keep the first, so a
tick may carry fewer live lanes than drawn.
"""
from __future__ import annotations

from typing import Dict

import torch

from bench import graphs

FIELDS = ("senders", "receivers", "dw", "w_old", "mask", "node_ids",
          "node_flag")

# salts of the traffic's hash purposes
_SALT = {name: 100 + i for i, name in enumerate((
    "rate", "lanes", "kind", "edge_off", "op", "factor", "absent_off",
    "partner", "add_w", "join", "toggle", "active"))}


def period(mix: dict) -> int:
    return 2 * int(mix["cycle_ticks"])


def check(mix: dict, n_pad: int, k_pad: int, j_pad: int,
          graph: dict) -> None:
    """Refuse a mix that a configuration cannot carry."""
    p = int(mix["cycle_ticks"])
    if j_pad < 2:
        raise ValueError("the mix uses two node slots a delta (a join "
                         f"and a toggle); j_pad={j_pad}")
    if p > graphs.POOL:
        raise ValueError(f"cycle_ticks={p} exceeds the toggle pool of "
                         f"{graphs.POOL} nodes")
    if n_pad - graph["n_live"][1] < p:
        raise ValueError(f"n_pad={n_pad} leaves fewer than cycle_ticks="
                         f"{p} inactive slots for joins")
    if graph["n_live"][0] - graphs.POOL < p * k_pad:
        raise ValueError("too few edge nodes for distinct absent pairs")


def _member(keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    if keys.numel() == 0:
        return torch.zeros_like(query, dtype=torch.bool)
    pos = torch.searchsorted(keys, query).clamp(max=keys.numel() - 1)
    return keys[pos] == query


def _quantize(x: torch.Tensor) -> torch.Tensor:
    q = graphs.WEIGHT_QUANTUM
    return torch.round(x / q) * q


def block_deltas(mix: dict, graph: dict, seed: int, streams: torch.Tensor,
                 keys: torch.Tensor, offsets: torch.Tensor,
                 weights: torch.Tensor, k_pad: int,
                 j_pad: int) -> Dict[str, torch.Tensor]:
    """The cycle's deltas of a block of streams, from the block's edges
    (`graphs.edges` of the same streams): each field (period, rows, ·),
    on the block's device, ids int64 and values float64."""
    dev = streams.device
    p = int(mix["cycle_ticks"])
    rows = streams.numel()
    g_count = p * k_pad
    key = {name: graphs.purpose_key(seed, s) for name, s in _SALT.items()}
    s = streams[:, None]                                     # (rows, 1)
    row = torch.arange(rows, device=dev, dtype=torch.int64)[:, None]
    g = torch.arange(g_count, device=dev, dtype=torch.int64)[None, :]
    t_of_g = g // k_pad
    lane = g % k_pad
    ticks = torch.arange(p, device=dev, dtype=torch.int64)[None, :]

    # a stream's rate from a Zipf law over the streams, a tick's count
    # of lanes from an exponential draw around it
    u_rate = (graphs.hash_(key["rate"], s).to(torch.float64) + 0.5) \
        / 4294967296.0
    rate = float(mix["rate_scale"]) * u_rate ** -float(mix["stream_zipf"])
    burst = -torch.log1p(-graphs.uniform(key["lanes"], s, ticks))
    n_lanes = torch.clamp(torch.ceil(rate * burst), 1, k_pad).to(torch.int64)
    # u < 1 always, so an active_share of 1 leaves every stream sending
    active = graphs.uniform(key["active"], s, ticks) \
        < float(mix.get("active_share", 1.0))
    live = lane < torch.gather(n_lanes, 1, t_of_g.expand(rows, g_count))
    live &= torch.gather(active, 1, t_of_g.expand(rows, g_count))
    existing = graphs.uniform(key["kind"], s, g) \
        < float(mix["existing_share"])
    u_op = graphs.uniform(key["op"], s, g)

    # lanes on edges the graph has: evenly spread over v from a random
    # start, at position floor(m v^edge_skew) of the row's sorted edges
    m_row = (offsets[1:] - offsets[:-1])[:, None]
    v = torch.remainder(graphs.uniform(key["edge_off"], s)
                        + g.to(torch.float64) / g_count, 1.0)
    at = torch.floor(m_row * v ** float(mix["edge_skew"])).to(torch.int64)
    pick = offsets[:-1, None] + torch.minimum(at, m_row - 1)
    _, e_lo, e_hi = graphs.split_keys(keys[pick])
    e_w = weights[pick]
    factor = (2.0 * graphs.uniform(key["factor"], s, g) - 1.0) \
        * float(mix["reweight"])
    e_dw = torch.where(u_op < float(mix["delete_share"]), -e_w,
                       _quantize(e_w * factor))

    # lanes on pairs the graph lacks: distinct first endpoints, the
    # partner from the destination law, the first draw that is no edge
    n_e = graphs.edge_nodes(graph, seed, s)
    a = (graphs.below(key["absent_off"], n_e, s)
         + g * torch.clamp(n_e // g_count, min=1)) % n_e
    n_cand = int(mix["candidates"])
    law = graph["dst"] if graph["dst"]["law"] == "power" \
        else {"law": "power", "gamma": 1.0}
    c_idx = g[..., None] * n_cand + torch.arange(n_cand, device=dev)
    x = graphs.draw_endpoint(law, key["partner"], n_e[..., None],
                             s[..., None], c_idx, 0)
    cand = graphs.pair_key(row[..., None], a[..., None], x)
    ok = (x != a[..., None]) & ~_member(keys, cand)
    first = torch.argmax(ok.to(torch.float32), dim=-1, keepdim=True)
    found = torch.gather(ok, -1, first)[..., 0]
    x = torch.gather(x, -1, first)[..., 0]
    add_lo, add_hi = torch.minimum(a, x), torch.maximum(a, x)
    w_lo, w_hi = mix["add_weight"]
    steps = torch.full_like(g.expand(rows, g_count),
                            round((w_hi - w_lo) / graphs.WEIGHT_QUANTUM))
    add_w = w_lo + graphs.below(key["add_w"], steps, s, g).to(
        torch.float64) * graphs.WEIGHT_QUANTUM
    add_dw = torch.where(u_op < float(mix["add_share"]), add_w, 0.0)

    live = live & (existing | found)
    senders = torch.where(existing, e_lo, add_lo)
    receivers = torch.where(existing, e_hi, add_hi)
    # two lanes of a row may still name one pair (a hub's edge drawn
    # twice; absent pairs (a, x) and (x, a)): the later one is dropped
    pkey = torch.where(live, graphs.pair_key(row, senders, receivers),
                       -1 - g)
    sk, order = torch.sort(pkey, dim=1, stable=True)
    dup = torch.zeros_like(live)
    dup[:, 1:] = (sk[:, 1:] == sk[:, :-1]) & (sk[:, 1:] >= 0)
    repeat = torch.zeros_like(live).scatter_(1, order, dup)
    live = live & ~repeat

    dw = torch.where(existing, e_dw, add_dw)
    w_old = torch.where(existing, e_w, 0.0)
    zero = torch.zeros_like(senders)
    fwd = {
        "senders": torch.where(live, senders, zero),
        "receivers": torch.where(live, receivers, zero),
        "dw": torch.where(live, dw, 0.0),
        "w_old": torch.where(live, w_old, 0.0),
        "mask": live.to(torch.float64),
    }
    fwd = {k: v.reshape(rows, p, k_pad).transpose(0, 1)
           for k, v in fwd.items()}

    # node slots: slot 0 a join of a fresh inactive slot, slot 1 a toggle
    # of a fresh isolated live node; later slots padding
    n_live_s = graphs.n_live(graph, seed, s)
    join = active & (graphs.uniform(key["join"], s, ticks)
                     < float(mix["join_share"]))
    toggle = active & (graphs.uniform(key["toggle"], s, ticks)
                       < float(mix["toggle_share"]))
    j_before = torch.cumsum(join.to(torch.int64), 1) - join.to(torch.int64)
    t_before = torch.cumsum(toggle.to(torch.int64), 1) \
        - toggle.to(torch.int64)
    ids = torch.zeros(rows, p, j_pad, dtype=torch.int64, device=dev)
    flag = torch.zeros(rows, p, j_pad, dtype=torch.float64, device=dev)
    ids[..., 0] = torch.where(join, n_live_s + j_before, 0)
    flag[..., 0] = join.to(torch.float64)
    ids[..., 1] = torch.where(toggle, n_e + t_before, 0)
    flag[..., 1] = -toggle.to(torch.float64)
    fwd["node_ids"] = ids.transpose(0, 1)
    fwd["node_flag"] = flag.transpose(0, 1)

    inv = {
        "senders": fwd["senders"], "receivers": fwd["receivers"],
        "dw": -fwd["dw"], "w_old": fwd["w_old"] + fwd["dw"],
        "mask": fwd["mask"], "node_ids": fwd["node_ids"],
        "node_flag": -fwd["node_flag"],
    }
    return {f: torch.cat([fwd[f], inv[f].flip(0)], 0).contiguous()
            for f in FIELDS}


def host_dtype(field: str) -> torch.dtype:
    return torch.int32 if field in ("senders", "receivers", "node_ids") \
        else torch.float32
