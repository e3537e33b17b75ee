"""The seed-defined graphs of a configuration, one per stream.

Every number here comes from a counter-based hash of (seed, purpose,
stream, index), so any subset of streams can be made again on any
device, alone or inside a block, with the same result: the set-up makes
all B streams on the card in blocks, and the reference makes its sampled
streams again by themselves. The hash works on int64 tensors whose
values stay below 2^32, so no product overflows.

A stream's graph (the configuration's ``graph`` section):

- ``n_live`` nodes are live, drawn per stream from the inclusive range;
  the first ``n_live - pool`` carry the edges, the last ``pool`` are
  live and isolated (the nodes that toggles take out and bring back),
  and the slots from ``n_live`` up are inactive (the nodes that joins
  bring in).
- ``edges`` endpoint pairs are drawn, each endpoint from its law:
  ``power`` puts node ``floor(n * u ** gamma)`` (low ids are the hubs),
  ``sequential`` gives the source ``floor(e * n / edges)`` (every node
  lists about the same number of partners, as a co-purchase list does).
  Self loops are dropped and repeated pairs kept once, so the graph is
  simple and its edge count a little below ``edges``.
- An edge's weight is a function of its pair, a multiple of 2^-12 in
  ``weight``'s half-open range, so every sum the deltas make stays exact
  in float64.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

M32 = 0xFFFFFFFF
_MUL = 0x045D9F3B
_GOLD = 0x9E3779B1
WEIGHT_QUANTUM = 1.0 / 4096.0
NODE_BITS = 20  # node ids below 2^20 in a pair key
POOL = 16  # live isolated nodes a stream keeps for toggles

# salts of the hash, one a purpose
SALT = {"n_live": 1, "src": 2, "dst": 3, "weight": 4}


def _mix_int(x: int) -> int:
    x &= M32
    x ^= x >> 16
    x = (x * _MUL) & M32
    x ^= x >> 16
    x = (x * _MUL) & M32
    return x ^ (x >> 16)


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = (x * _MUL) & M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & M32
    return x ^ (x >> 16)


def purpose_key(seed: int, salt: int) -> int:
    """A 32-bit key for one purpose of one seed (seeds may exceed 32
    bits: the high word is folded in)."""
    seed = int(seed)
    high = _mix_int(((seed >> 32) & M32) ^ _mix_int(salt))
    return _mix_int((high + (seed & M32) * _GOLD) & M32)


def hash_(key: int, *parts: torch.Tensor) -> torch.Tensor:
    """32-bit hash of ``key`` and the int64 tensors ``parts`` (each
    value in [0, 2^32)), broadcast together."""
    x = None
    for p in parts:
        base = key if x is None else x
        x = _mix((base + p) & M32)
    return x


def uniform(key: int, *parts: torch.Tensor) -> torch.Tensor:
    """float64 in [0, 1) from the hash."""
    return hash_(key, *parts).to(torch.float64) / 4294967296.0


def below(key: int, n: torch.Tensor, *parts: torch.Tensor) -> torch.Tensor:
    """An int64 in [0, n) from the hash (n ≤ 2^32)."""
    return (hash_(key, *parts) * n) >> 32


def n_live(spec: dict, seed: int, streams: torch.Tensor) -> torch.Tensor:
    """Each stream's live node count (int64)."""
    lo, hi = spec["n_live"]
    span = torch.full_like(streams, hi - lo + 1)
    return lo + below(purpose_key(seed, SALT["n_live"]), span, streams)


def edge_nodes(spec: dict, seed: int, streams: torch.Tensor) -> torch.Tensor:
    """Each stream's count of nodes that carry edges: ids [0, n_e)."""
    return n_live(spec, seed, streams) - POOL


def draw_endpoint(law: dict, key: int, n_e: torch.Tensor,
                  streams: torch.Tensor, idx: torch.Tensor,
                  count: int) -> torch.Tensor:
    """Node ids in [0, n_e) of the law ``law`` for the (stream, index)
    grid; ``count`` is the number of indices a stream draws (the
    sequential law spreads them over the nodes)."""
    if law["law"] == "sequential":
        return (idx * n_e) // count
    if law["law"] != "power":
        raise ValueError(f"unknown endpoint law {law['law']!r}")
    u = uniform(key, streams, idx)
    node = torch.floor(n_e.to(torch.float64) * u ** float(law["gamma"]))
    return torch.minimum(node.to(torch.int64), n_e - 1)


def pair_weight(seed: int, streams: torch.Tensor, lo: torch.Tensor,
                hi: torch.Tensor, spec: dict) -> torch.Tensor:
    """The weight of edge (lo, hi) of each stream, float64."""
    w_lo, w_hi = spec["weight"]
    steps = round((w_hi - w_lo) / WEIGHT_QUANTUM)
    q = below(purpose_key(seed, SALT["weight"]),
              torch.full_like(lo, steps), streams, lo, hi)
    return w_lo + q.to(torch.float64) * WEIGHT_QUANTUM


def edges(spec: dict, seed: int, streams: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The edges of ``streams`` (a 1-D int64 tensor of stream ids, on
    the device to work on).

    Returns ``(keys, offsets, weights)``: the sorted unique pair keys
    ``row << 2*NODE_BITS | lo << NODE_BITS | hi`` (``row`` the position
    in ``streams``), each row's first index into them (``rows + 1``
    entries), and each edge's float64 weight.
    """
    dev = streams.device
    count = int(spec["edges"])
    rows = streams.numel()
    idx = torch.arange(count, dtype=torch.int64, device=dev)[None, :]
    st = streams[:, None]
    n_e = edge_nodes(spec, seed, st)
    a = draw_endpoint(spec["src"], purpose_key(seed, SALT["src"]), n_e, st,
                      idx, count)
    b = draw_endpoint(spec["dst"], purpose_key(seed, SALT["dst"]), n_e, st,
                      idx, count)
    del idx
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    del a, b
    row = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    keys = (row << (2 * NODE_BITS)) | (lo << NODE_BITS) | hi
    keys = torch.where(lo == hi, torch.iinfo(torch.int64).max, keys)
    del lo, hi
    keys = torch.unique(keys.reshape(-1), sorted=True)
    if keys.numel() and keys[-1] == torch.iinfo(torch.int64).max:
        keys = keys[:-1]
    bounds = torch.arange(rows + 1, dtype=torch.int64, device=dev) \
        << (2 * NODE_BITS)
    offsets = torch.searchsorted(keys, bounds)
    r, lo, hi = split_keys(keys)
    weights = pair_weight(seed, streams[r], lo, hi, spec)
    return keys, offsets, weights


def split_keys(keys: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(row, lo, hi) of pair keys."""
    mask = (1 << NODE_BITS) - 1
    return (keys >> (2 * NODE_BITS), (keys >> NODE_BITS) & mask,
            keys & mask)


def pair_key(row: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """The key of the unordered pair (a, b) in row ``row``."""
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    return (row << (2 * NODE_BITS)) | (lo << NODE_BITS) | hi


def stream_graph(spec: dict, seed: int, stream: int,
                 device="cpu") -> Dict[str, torch.Tensor]:
    """One stream's graph alone: ``lo``, ``hi`` (int64), ``w`` (float64)
    and ``n_live``."""
    streams = torch.tensor([stream], dtype=torch.int64, device=device)
    keys, _, w = edges(spec, seed, streams)
    _, lo, hi = split_keys(keys)
    return {"lo": lo, "hi": hi, "w": w,
            "n_live": int(n_live(spec, seed, streams)[0])}
