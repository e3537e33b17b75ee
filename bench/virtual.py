"""A ``sparse_tick`` configuration: its set-up over a virtual id space,
and the program's slot-space state read back into the reference's ids.

A configuration whose ``service`` says ``"method": "sparse_tick"``
gives ``n_slots`` and ``m_pad`` as `ServiceConfig` takes them, and its
``n_pad`` is the virtual id bound n_virtual, a power of two 2^k. The
graph law (`bench.graphs`) and the mix (`bench.traffic`) run unchanged
with n_slots in the place of a dense configuration's n_pad: they draw
dense ids in [0, n_slots), and the reference (`bench.reference`) works
in those ids. One bijection of the k-bit ids, fixed by the seed and
shared by every stream (AS views share AS numbers), moves them into
[0, 2^k):

    x = (d XOR a) * b mod 2^k;  x = x XOR (x >> h);
    x = x * c mod 2^k;          v = x XOR (x >> h)

with h = ceil(k / 2), ``a`` a k-bit key and ``b``, ``c`` odd k-bit
multipliers, all three from the seed. Each step is one to one on k-bit
integers (a XOR with a constant, a product by an odd number modulo 2^k,
a right xorshift), so the whole map is.

Set-up hands the port what a deployment's producer would: each stream's
graph as an `EdgeList` in virtual ids with its live nodes in the node
mask, to `FingerService.open`, the deployment's own entry, which builds
the (B, n_slots) state and the B `SlotMap`s; and each tick's B
per-stream virtual deltas, made once a cycle, which `ingest` translates
through the maps (the program's work, inside the timed window).

After the window each sampled stream's slot rows and masks go through
its `SlotMap` to virtual ids and through the bijection back to dense
ids, where `bench.compare.gaps` judges them as a dense stream's; the
node slots and edge-store slots that the map leaves free are judged
against nothing live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from bench import graphs, roofline, traffic
from repro_torch.graphs.types import EdgeList, GraphDelta

WARM_STEPS = 2          # steps after the first tick that warm the loop
TRACED_STREAM_TICKS = 4096  # stream-ticks a traced run profiles at most,
TRACED_MIN_TICKS = 8        # unless that is fewer ticks than this
_SALT = {"key": 200, "mul_b": 201, "mul_c": 202}


def is_sparse(cfg: dict) -> bool:
    return cfg["service"]["method"] == "sparse_tick"


def id_space(cfg: dict) -> int:
    """The count of dense ids the graph law and the mix draw from: the
    configuration's ``n_pad``, or its ``n_slots`` under sparse_tick."""
    svc = cfg["service"]
    return svc["n_slots"] if is_sparse(cfg) else svc["n_pad"]


def relabel(seed: int, bits: int, ids: torch.Tensor) -> torch.Tensor:
    """The seed's bijection of ``bits``-bit ids (int64 in [0, 2^bits),
    ``bits`` at most 31), applied to ``ids``."""
    if not 1 <= bits <= 31:
        raise ValueError(f"a virtual space of 2^{bits} ids; need 1-31 bits")
    m = (1 << bits) - 1
    h = (bits + 1) // 2
    a, b, c = (graphs.purpose_key(seed, s) & m for s in _SALT.values())
    x = ((ids ^ a) * (b | 1)) & m
    x = x ^ (x >> h)
    x = (x * (c | 1)) & m
    return x ^ (x >> h)


class Relabel:
    """The run's bijection over its dense ids [0, n_slots), with the
    inverse of its image."""

    def __init__(self, cfg: dict, seed: int):
        n_virtual = int(cfg["service"]["n_pad"])
        bits = n_virtual.bit_length() - 1
        if n_virtual != 1 << bits:
            raise ValueError(f"n_pad={n_virtual}, the virtual bound of a "
                             "sparse_tick configuration, is no power of 2")
        n = id_space(cfg)
        if n > n_virtual:
            raise ValueError(f"n_slots={n} exceeds the virtual bound "
                             f"n_pad={n_virtual}")
        self.n_virtual = n_virtual
        self.forward = relabel(seed, bits, torch.arange(n))
        self._back = {v: d for d, v in enumerate(self.forward.tolist())}

    def back(self, vid: int) -> int:
        """The dense id of virtual id ``vid``; -1 outside the image."""
        return self._back.get(int(vid), -1)


@dataclasses.dataclass
class SparseInputs:
    """What set-up makes from the seed for a sparse_tick configuration:
    every stream's graph (virtual endpoints and float32 weights on the
    host, by block of streams), the cycle of dense-id host deltas that
    the reference reads (each field (period, B, ·)), and the same cycle
    as each tick's B per-stream virtual deltas."""

    blocks: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]]
    n_live: torch.Tensor
    host: Dict[str, torch.Tensor]
    deltas: List[List[GraphDelta]]
    ids: Relabel
    n_slots: int

    def bytes_needed(self, tick: int) -> int:
        """The bytes the delta of cycle tick ``tick`` needs moved."""
        h = {f: v[tick].numpy() for f, v in self.host.items()}
        return roofline.sparse_bytes_needed(
            h["senders"], h["receivers"], h["dw"], h["mask"], h["node_ids"],
            h["node_flag"], self.n_slots)

    def graphs(self) -> Iterator[EdgeList]:
        """Each stream's initial graph in virtual ids, one at a time (a
        node mask is n_virtual floats)."""
        live = self.ids.forward
        b = 0
        for lo, hi, w, offsets in self.blocks:
            for r in range(len(offsets) - 1):
                at = slice(int(offsets[r]), int(offsets[r + 1]))
                m = at.stop - at.start
                mask = torch.zeros(self.ids.n_virtual, dtype=torch.float32)
                mask[live[:int(self.n_live[b])]] = 1.0
                yield EdgeList(senders=lo[at], receivers=hi[at],
                               weights=w[at], mask=torch.ones(m),
                               n_nodes=self.ids.n_virtual, node_mask=mask)
                b += 1


def make_inputs(cfg: dict, mix: dict, seed: int, device: torch.device,
                block: int) -> SparseInputs:
    """The sparse configuration's graphs and cycle of deltas, drawn on
    the device ``block`` streams at a time, as the dense set-up draws
    them."""
    svc, graph = cfg["service"], cfg["graph"]
    b, n_slots = svc["batch_size"], svc["n_slots"]
    k_pad, j_pad = svc["k_pad"], svc["j_pad"]
    traffic.check(mix, n_slots, k_pad, j_pad, graph)
    ids = Relabel(cfg, seed)
    fwd = ids.forward.to(device)
    period = traffic.period(mix)
    host = {f: torch.empty((period, b, j_pad if f.startswith("node")
                            else k_pad), dtype=traffic.host_dtype(f))
            for f in traffic.FIELDS}
    blocks = []
    for b0 in range(0, b, block):
        b1 = min(b, b0 + block)
        streams = torch.arange(b0, b1, dtype=torch.int64, device=device)
        keys, offsets, w = graphs.edges(graph, seed, streams)
        _, lo, hi = graphs.split_keys(keys)
        vlo, vhi = fwd[lo], fwd[hi]
        blocks.append((torch.minimum(vlo, vhi).int().cpu(),
                       torch.maximum(vlo, vhi).int().cpu(),
                       w.float().cpu(), offsets.cpu()))
        d = traffic.block_deltas(mix, graph, seed, streams, keys, offsets,
                                 w, k_pad, j_pad)
        for f in traffic.FIELDS:
            host[f][:, b0:b1] = d[f].to(traffic.host_dtype(f)).cpu()
        del keys, offsets, w, lo, hi, d
    n_live = graphs.n_live(graph, seed, torch.arange(b)).cpu()
    return SparseInputs(blocks, n_live, host,
                        virtual_deltas(host, ids), ids, n_slots)


def virtual_deltas(host: Dict[str, torch.Tensor],
                   ids: Relabel) -> List[List[GraphDelta]]:
    """Each tick's B per-stream deltas, the host cycle's ids moved into
    the virtual space (padding lanes and slots too: their masks and
    flags keep them out)."""
    fwd = ids.forward
    fields = {f: (fwd[v.long()].int() if f in ("senders", "receivers",
                                                "node_ids") else v)
              for f, v in host.items()}
    out = []
    for t in range(len(host["dw"])):
        rows = {f: v[t].unbind(0) for f, v in fields.items()}
        out.append([GraphDelta(n_nodes=ids.n_virtual,
                               **{f: rows[f][s] for f in traffic.FIELDS})
                    for s in range(len(rows["dw"]))])
    return out


def read_back(state: Dict[str, np.ndarray], maps: list, ids: Relabel
              ) -> Tuple[Dict[str, np.ndarray], dict]:
    """The sampled streams' slot-space state (each field (S, ·)) in dense
    ids through their `SlotMap`s and the bijection, and what the maps
    leave over: ``stray_masks`` (node slots that hold no mapped node yet
    are live), ``stray_strengths`` (their widest strength, a stream
    each), and ``stores``: a stream's edge store as ``(weights of its
    mapped edges by dense pair, the values of every other slot)``."""
    n = ids.forward.numel()
    rows = {f: np.zeros((len(maps), n)) for f in ("strengths", "node_mask")}
    stray_masks, stray_strengths, stores = 0, [], []
    for j, sm in enumerate(maps):
        used = np.zeros(state["strengths"].shape[1], bool)
        for vid, slot in sm.node_slot.items():
            d = ids.back(vid)
            if d >= 0:
                used[slot] = True
                for f in rows:
                    rows[f][j, d] = state[f][j, slot]
        stray_masks += int(np.count_nonzero(state["node_mask"][j][~used]))
        stray_strengths.append(float(np.max(
            np.abs(state["strengths"][j][~used]), initial=0.0)))
        store = state["edge_weights"][j]
        held = np.zeros(store.shape[0], bool)
        weights = {}
        for (va, vb), slot in sm.edge_slot.items():
            a, b = ids.back(va), ids.back(vb)
            if a >= 0 and b >= 0:
                held[slot] = True
                weights[(min(a, b), max(a, b))] = float(store[slot])
        stores.append((weights, store[~held]))
    dense = {f: v for f, v in state.items() if f != "edge_weights"}
    dense.update(rows)
    return dense, {"stray_masks": stray_masks,
                   "stray_strengths": stray_strengths, "stores": stores}
