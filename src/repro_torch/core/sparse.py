"""Sparse large-n stream state: FINGER over an active-slot universe.

The port's copy of `repro.core.sparse`. The dense serving layout sizes
every per-stream row by ``n_pad``, the padded bound of the *virtual*
node-id space, so a stream whose graph lives in a huge id space (the
paper's Wikipedia graphs, Table 2: millions of ids) pays for all of it
even when a few hundred nodes are active. This module separates the
two sizes:

- the **virtual space** (``n_virtual``, the serving config's ``n_pad``)
  is a host-side addressing bound only; no tensor is sized by it;
- the **slot space** (`SparseLayout`: ``n_slots`` node slots and an
  ``m_pad``-slot edge-weight store) sizes every device tensor, so a
  stream costs O(n_slots + m_pad) memory whatever ``n_virtual`` is.

VNGE is invariant under node relabelling, so a `SparseStreamState` over
slot ids carries exactly the FINGER statistics of the virtual graph:
the Theorem-2 / Algorithm-2 math is that of `core.incremental` and
`core.jsdist` applied to a slot-space view of the state. The new parts
are

- `SlotMap`, the host translator from virtual ids to slots (node slots
  on join, edge slots on a new edge, both freed on deletion or leave),
  which also raises the named errors a scatter could not:
  `SparseCapacityError` when a stream runs out of slots, and
  `ValueError`s for out-of-virtual-space ids and duplicate lanes;
- the ``(m_pad,)`` ``edge_weights`` store, which keeps the state
  self-describing (the statistics never read it: ``w_old`` rides in the
  delta, as on the dense path).

`sparse_state_from_graph` builds the state and its map straight from an
edge list: it never forms the (n_virtual, n_virtual) matrix that the
reference's construction scans, which at a virtual space of 2²⁰ ids
would be terabytes per stream. `repro_torch.kernels.sparse_tick` runs
the batched tick in one launch on the card; `sparse_jsdist_tick` below
is its plain version and works on any leading batch shape.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.core.incremental import update_state
from repro_torch.core.jsdist import js_from_entropies
from repro_torch.core.state import FingerState, finger_state
from repro_torch.graphs.types import (
    DenseGraph,
    EdgeList,
    GraphDelta,
    in_range,
    node_mask_after_joins,
    take_nodes,
)

__all__ = [
    "EDGE_SLOT_SENTINEL",
    "SparseCapacityError",
    "SparseLayout",
    "SparseStreamState",
    "SlotMap",
    "sparse_jsdist_tick",
    "sparse_state_from_graph",
    "sparse_states_from_graphs",
    "stack_sparse_states",
]

# Edge-slot id of padding and dropped lanes: out of range for every
# store capacity, so every edge-store write skips it.
EDGE_SLOT_SENTINEL = np.int32(2**31 - 1)

# A post-delta edge weight at or below this fraction of the moved mass
# is a deletion: the edge's slot returns to the free list.
_DELETED_EDGE_TOL = 1e-9

_STATE_FIELDS = ("q", "s_total", "s_max", "strengths", "node_mask",
                 "edge_weights")


class SparseCapacityError(RuntimeError):
    """A sparse stream ran out of node or edge slots. Grow the capacity
    (`FingerService.grow_capacity` / `SparseLayout.grown`) instead of
    letting a scatter drop the update silently."""


@dataclasses.dataclass(frozen=True)
class SparseLayout:
    """Device capacities of one sparse stream batch.

    ``n_slots`` node slots and ``m_pad`` edge-store slots; ``generation``
    counts capacity migrations as `NodeLayout.generation` counts dense
    layout migrations. Hashable and frozen.
    """

    n_slots: int
    m_pad: int
    generation: int = 0

    def __post_init__(self):
        if self.n_slots <= 0:
            raise ValueError(
                f"SparseLayout: n_slots must be positive, got "
                f"{self.n_slots}")
        if self.m_pad <= 0:
            raise ValueError(
                f"SparseLayout: m_pad must be positive, got {self.m_pad}")
        if self.generation < 0:
            raise ValueError(
                f"SparseLayout: generation must be >= 0, got "
                f"{self.generation}")

    def grown(self, n_slots: Optional[int] = None,
              m_pad: Optional[int] = None) -> "SparseLayout":
        """The next layout after a capacity bump (either axis may stay).

        Slot ids are kept (growth only appends free slots), so no state
        renumbering or delta remap is needed; the generation still
        counts the migration.
        """
        n_new = self.n_slots if n_slots is None else int(n_slots)
        m_new = self.m_pad if m_pad is None else int(m_pad)
        if n_new < self.n_slots or m_new < self.m_pad:
            raise ValueError(
                f"SparseLayout.grown: ({n_new}, {m_new}) shrinks the "
                f"current capacity ({self.n_slots}, {self.m_pad}); "
                "sparse capacity only grows")
        if (n_new, m_new) == (self.n_slots, self.m_pad):
            raise ValueError(
                "SparseLayout.grown: new capacity equals the current "
                f"({self.n_slots}, {self.m_pad})")
        return SparseLayout(n_new, m_new, generation=self.generation + 1)


@dataclasses.dataclass(frozen=True)
class SparseStreamState:
    """FINGER sufficient statistics over the slot universe.

    The statistics of a `FingerState` of the virtual graph (relabelling
    invariance), with every tensor sized by the `SparseLayout`
    capacities. Fields may carry leading batch axes, as in `FingerState`.
    """

    q: torch.Tensor             # Lemma-1 quadratic proxy Q
    s_total: torch.Tensor       # S = trace(L) = 1/c
    s_max: torch.Tensor         # largest nodal strength
    strengths: torch.Tensor     # (..., n_slots) per-slot strengths
    node_mask: torch.Tensor     # (..., n_slots) 0/1 allocated and active
    edge_weights: torch.Tensor  # (..., m_pad) slot-addressed edge store
    layout: SparseLayout

    @property
    def n_slots(self) -> int:
        return int(self.strengths.shape[-1])

    @property
    def m_pad(self) -> int:
        return int(self.edge_weights.shape[-1])

    def n_active(self) -> torch.Tensor:
        return self.node_mask.sum(-1).to(torch.int32)

    def tensors(self) -> dict:
        """The tensor fields by name."""
        return {f: getattr(self, f) for f in _STATE_FIELDS}

    def map_tensors(self, fn) -> "SparseStreamState":
        """A copy with ``fn`` applied to every tensor field."""
        return dataclasses.replace(
            self, **{k: fn(v) for k, v in self.tensors().items()})

    def to(self, device) -> "SparseStreamState":
        return self.map_tensors(lambda t: t.to(device))

    def dense_view(self) -> FingerState:
        """The slot-space `FingerState` with the same statistics.

        ``layout=None``: slot-space deltas are addressed in
        ``n_nodes == n_slots``, so the dense layout check has nothing
        to check.
        """
        return FingerState(
            q=self.q, s_total=self.s_total, s_max=self.s_max,
            strengths=self.strengths, node_mask=self.node_mask,
            layout=None)

    def h_tilde(self) -> torch.Tensor:
        return self.dense_view().h_tilde()


def stack_sparse_states(states: Iterable[SparseStreamState]
                        ) -> SparseStreamState:
    """[state_b] → one state with a leading (B,) axis; every state must
    share the `SparseLayout`."""
    states = list(states)
    if not states:
        raise ValueError("stack_sparse_states: empty stream list")
    layouts = {s.layout for s in states}
    if len(layouts) != 1:
        raise ValueError(
            f"stack_sparse_states needs one SparseLayout, got "
            f"{sorted(layouts, key=repr)}")
    return SparseStreamState(
        **{f: torch.stack([getattr(s, f) for s in states])
           for f in _STATE_FIELDS},
        layout=states[0].layout)


def _require_slot_delta(state: SparseStreamState, delta: GraphDelta,
                        where: str) -> None:
    if delta.edge_slots is None:
        raise ValueError(
            f"{where}: delta carries no edge_slots — sparse ticks need "
            "slot-space deltas; translate virtual deltas through the "
            "stream's SlotMap first (FingerService does this at ingest)")
    if delta.n_nodes != state.layout.n_slots:
        raise ValueError(
            f"{where}: delta is addressed in an n_slots={delta.n_nodes} "
            f"slot space but the state's layout has n_slots="
            f"{state.layout.n_slots} (generation "
            f"{state.layout.generation}); grow the capacity first "
            "(FingerService.grow_capacity)")


def _advance_edge_store(state: SparseStreamState, delta: GraphDelta,
                        s_total_after: torch.Tensor) -> torch.Tensor:
    """Carry the (..., m_pad) edge store through the full ΔG update.

    Each lane that survives the gate (edge mask, and both endpoints
    live under the post-join mask) writes ``max(w_old + dw, 0)`` at its
    slot; padding and gated lanes, `EDGE_SLOT_SENTINEL` and any slot
    outside ``[0, m_pad)`` write nothing. A delta that empties the
    graph (S' ≤ 0) zeroes the whole store, as the strengths snap.

    Slots are unique within a tick among the lanes that write (the
    `SlotMap` contract), so the order of the writes does not matter.
    The TPU kernel's one-hot sums where this assigns; the two differ
    only on a slot written twice, which the contract excludes.
    """
    mask_joined = state.node_mask
    if delta.node_ids is not None:
        mask_joined = node_mask_after_joins(mask_joined, delta)
    gate = delta.mask * take_nodes(mask_joined, delta.senders) \
        * take_nodes(mask_joined, delta.receivers)
    m = state.edge_weights.shape[-1]
    write = (gate > 0) & in_range(delta.edge_slots, m)
    # Lanes that write nothing go to a scratch column at index m.
    idx = torch.where(write, delta.edge_slots, m).long()
    new_w = torch.clamp(delta.w_old + delta.dw, min=0.0)
    ew = state.edge_weights
    scratch = torch.zeros_like(ew[..., :1])
    ew = torch.cat([ew, scratch], -1).scatter(-1, idx, new_w)[..., :m]
    return torch.where(s_total_after[..., None] > 0, ew, 0.0)


def sparse_jsdist_tick(state: SparseStreamState, delta: GraphDelta,
                       exact_smax: bool = False
                       ) -> Tuple[torch.Tensor, SparseStreamState]:
    """Algorithm 2 on sparse streams: (JSdist, updated state).

    Two Theorem-2 updates (ΔG/2 and ΔG) through the dense math on the
    slot-space view, then the edge-store scatter. Works on one stream
    or any leading batch shape; the plain version of the
    `sparse_tick` kernel.
    """
    _require_slot_delta(state, delta, "sparse_jsdist_tick")
    view = state.dense_view()
    half = update_state(view, delta.scaled(0.5), exact_smax=exact_smax,
                        method="compact")
    full = update_state(view, delta, exact_smax=exact_smax,
                        method="compact")
    dist = js_from_entropies(half.h_tilde(), view.h_tilde(),
                             full.h_tilde())
    ew = _advance_edge_store(state, delta, full.s_total)
    return dist, SparseStreamState(
        q=full.q, s_total=full.s_total, s_max=full.s_max,
        strengths=full.strengths, node_mask=full.node_mask,
        edge_weights=ew, layout=state.layout)


# ---------------------------------------------------------------------------
# Host-side virtual-id -> slot translation
# ---------------------------------------------------------------------------


def _host(x, dtype) -> np.ndarray:
    """A tensor or array as a host numpy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class SlotMap:
    """Per-stream host translator from virtual node ids to device slots.

    Owns the allocation discipline of one stream's slot space: node
    slots are allocated on join and freed on leave, edge slots are
    allocated the first time an edge appears and freed when a delta
    deletes it (post-delta weight ≈ 0) or its endpoint leaves. All
    frees and allocations commit only after the whole delta validates,
    so a rejected delta never corrupts the map, and freed slots are
    not reused within the same delta (a tick's scatter must never write
    one slot twice).

    ``translate`` is stateful: call it once per applied delta, in tick
    order. ``stage`` / ``commit`` split it in two for atomicity over a
    batch: serving ingestion stages every stream of a tick first
    (nothing changes; a rejection leaves every map as it was) and
    commits once the whole batch has validated.
    """

    def __init__(self, layout: SparseLayout, n_virtual: int,
                 stream: Optional[int] = None):
        if int(n_virtual) <= 0:
            raise ValueError(
                f"SlotMap: n_virtual must be positive, got {n_virtual}")
        self.layout = layout
        self.n_virtual = int(n_virtual)
        self.stream = stream
        self.node_slot: Dict[int, int] = {}
        self.edge_slot: Dict[Tuple[int, int], int] = {}
        # stacks: allocation pops from the end, frees push back
        self._free_nodes: List[int] = list(range(layout.n_slots - 1,
                                                 -1, -1))
        self._free_edges: List[int] = list(range(layout.m_pad - 1,
                                                 -1, -1))
        self._node_edges: Dict[int, Set[Tuple[int, int]]] = {}

    def _where(self) -> str:
        tag = "" if self.stream is None else f"[stream {self.stream}] "
        return f"SlotMap.translate: {tag}"

    @property
    def n_free_nodes(self) -> int:
        return len(self._free_nodes)

    @property
    def n_free_edges(self) -> int:
        return len(self._free_edges)

    def grow(self, new_layout: SparseLayout) -> None:
        """Adopt a grown layout: the new slots go to the bottom of the
        free lists (existing assignments keep their ids)."""
        if new_layout.n_slots < self.layout.n_slots \
                or new_layout.m_pad < self.layout.m_pad:
            raise ValueError(
                f"SlotMap.grow: ({new_layout.n_slots}, "
                f"{new_layout.m_pad}) shrinks the current capacity "
                f"({self.layout.n_slots}, {self.layout.m_pad})")
        self._free_nodes = list(
            range(new_layout.n_slots - 1, self.layout.n_slots - 1, -1)
        ) + self._free_nodes
        self._free_edges = list(
            range(new_layout.m_pad - 1, self.layout.m_pad - 1, -1)
        ) + self._free_edges
        self.layout = new_layout

    def grow_virtual(self, n_virtual: int) -> None:
        """Raise the virtual addressing bound (a host-only repad)."""
        if int(n_virtual) < self.n_virtual:
            raise ValueError(
                f"SlotMap.grow_virtual: n_virtual={n_virtual} shrinks "
                f"the current bound {self.n_virtual}")
        self.n_virtual = int(n_virtual)

    # -- persistence -----------------------------------------------------
    def to_json(self) -> dict:
        """The map as a JSON-serializable dict in the reference's
        format: capacities, the two assignment tables, and the free
        lists in stack order (allocation order is part of the
        translation contract: the next join must take the same slot
        after a round trip)."""
        return {
            "n_slots": int(self.layout.n_slots),
            "m_pad": int(self.layout.m_pad),
            "generation": int(self.layout.generation),
            "n_virtual": int(self.n_virtual),
            "stream": self.stream,
            "node_slot": [[int(v), int(s)]
                          for v, s in sorted(self.node_slot.items())],
            "edge_slot": [[int(lo), int(hi), int(s)]
                          for (lo, hi), s
                          in sorted(self.edge_slot.items())],
            "free_nodes": [int(s) for s in self._free_nodes],
            "free_edges": [int(s) for s in self._free_edges],
        }

    @classmethod
    def from_json(cls, payload: dict) -> "SlotMap":
        """Rebuild a map serialized by `to_json` (either package's):
        assignments, free lists in their order, and the per-node edge
        index derived from the edge table."""
        layout = SparseLayout(n_slots=int(payload["n_slots"]),
                              m_pad=int(payload["m_pad"]),
                              generation=int(payload["generation"]))
        sm = cls(layout, int(payload["n_virtual"]),
                 stream=payload.get("stream"))
        sm.node_slot = {int(v): int(s)
                        for v, s in payload["node_slot"]}
        sm.edge_slot = {(int(lo), int(hi)): int(s)
                        for lo, hi, s in payload["edge_slot"]}
        sm._free_nodes = [int(s) for s in payload["free_nodes"]]
        sm._free_edges = [int(s) for s in payload["free_edges"]]
        sm._node_edges = {int(v): set() for v in sm.node_slot}
        for key in sm.edge_slot:
            sm._node_edges.setdefault(key[0], set()).add(key)
            sm._node_edges.setdefault(key[1], set()).add(key)
        return sm

    def translate(self, delta: GraphDelta) -> GraphDelta:
        """Virtual-space `GraphDelta` → slot-space delta with edge slots.

        Follows the dense gating exactly: joins allocate before the edge
        lanes are resolved, lanes touching an inactive (unallocated)
        node are dropped (the dense node mask would gate them to zero),
        leaves free after them. Raises `SparseCapacityError` when the
        node or edge capacity is exhausted and `ValueError` for
        out-of-virtual-space ids or duplicate edge lanes. Equivalent to
        ``commit(stage(delta))``.
        """
        return self.commit(self.stage(delta))

    def stage(self, delta: GraphDelta) -> "_StagedTranslation":
        """The pure half of `translate`: validate and resolve slots
        without changing the map. Apply with `commit` (once, before any
        further stage on this map)."""
        where = self._where()
        if delta.edge_slots is not None:
            raise ValueError(
                where + "delta already carries edge_slots; a delta is "
                "translated exactly once")
        if delta.n_nodes > self.n_virtual:
            raise ValueError(
                where + f"delta is addressed in an n_pad="
                f"{delta.n_nodes} virtual space but this stream's bound "
                f"is n_pad={self.n_virtual}; repad the service first")
        senders = _host(delta.senders, np.int64)
        receivers = _host(delta.receivers, np.int64)
        dw = _host(delta.dw, np.float32)
        w_old = _host(delta.w_old, np.float32)
        mask = _host(delta.mask, np.float32)
        k_pad = senders.shape[0]

        valid = mask > 0
        bad = valid & ((np.minimum(senders, receivers) < 0)
                       | (np.maximum(senders, receivers)
                          >= self.n_virtual))
        if bad.any():
            ids = np.unique(np.concatenate(
                [senders[bad], receivers[bad]]))
            ids = [int(i) for i in ids
                   if i < 0 or i >= self.n_virtual]
            raise ValueError(
                where + f"edge endpoint id(s) {ids[:8]} outside the "
                f"n_pad={self.n_virtual} virtual space; re-pad the "
                "stream to a larger n_pad to grow past it")

        joins: List[int] = []
        if delta.node_ids is not None:
            nid = _host(delta.node_ids, np.int64)
            nflag = _host(delta.node_flag, np.float32)
            oob = (nflag != 0) & ((nid < 0) | (nid >= self.n_virtual))
            if oob.any():
                raise ValueError(
                    where + f"join/leave node id(s) "
                    f"{sorted(set(int(i) for i in nid[oob]))} outside "
                    f"the n_pad={self.n_virtual} virtual space")
            joins = nid[nflag > 0].tolist()

        # -- stage (no change to the map until everything validates) ----
        staged_nodes: Dict[int, int] = {}
        for vid in joins:
            if vid in self.node_slot or vid in staged_nodes:
                continue  # re-join of an active node: a mask no-op
            idx = len(staged_nodes)
            if idx >= len(self._free_nodes):
                raise SparseCapacityError(
                    where + f"node slots exhausted (n_slots="
                    f"{self.layout.n_slots}, all allocated) while "
                    f"joining node {vid}; grow the capacity "
                    "(FingerService.grow_capacity)")
            staged_nodes[vid] = self._free_nodes[-(1 + idx)]

        def slot_of(vid: int) -> Optional[int]:
            if vid in self.node_slot:
                return self.node_slot[vid]
            return staged_nodes.get(vid)

        out_snd = np.zeros(k_pad, np.int32)
        out_rcv = np.zeros(k_pad, np.int32)
        out_dw = np.zeros(k_pad, np.float32)
        out_wold = np.zeros(k_pad, np.float32)
        out_mask = np.zeros(k_pad, np.float32)
        out_slot = np.full(k_pad, EDGE_SLOT_SENTINEL, np.int32)

        staged_edges: Dict[Tuple[int, int], int] = {}
        deleted: List[Tuple[int, int]] = []
        seen: Set[Tuple[int, int]] = set()
        # Python ints and floats: the float32 values of the delta,
        # exactly, without a numpy scalar per operation.
        lanes = np.flatnonzero(valid).tolist()
        snd_l, rcv_l = senders.tolist(), receivers.tolist()
        dw_l, wold_l = dw.tolist(), w_old.tolist()
        for lane in lanes:
            lo = min(snd_l[lane], rcv_l[lane])
            hi = max(snd_l[lane], rcv_l[lane])
            if lo == hi:
                continue  # self-loop: from_arrays drops these already
            s_lo, s_hi = slot_of(lo), slot_of(hi)
            if s_lo is None or s_hi is None:
                # dense semantics: an edge touching an inactive node is
                # gated to exactly zero, so the lane is dropped here
                continue
            key = (lo, hi)
            if key in seen:
                raise ValueError(
                    where + f"duplicate edge lane for ({lo}, {hi}) in "
                    "one delta; the slot-addressed edge store cannot "
                    "scatter one slot twice per tick — merge the "
                    "lanes' dw host-side")
            seen.add(key)
            live = key in self.edge_slot
            if live:
                slot = self.edge_slot[key]
            else:
                idx = len(staged_edges)
                if idx >= len(self._free_edges):
                    raise SparseCapacityError(
                        where + f"edge slots exhausted (m_pad="
                        f"{self.layout.m_pad}, "
                        f"{len(self.edge_slot) + idx} live) while "
                        f"adding edge ({lo}, {hi}); grow the capacity "
                        "(FingerService.grow_capacity)")
                slot = self._free_edges[-(1 + idx)]
                staged_edges[key] = slot
            wo, d = wold_l[lane], dw_l[lane]
            if live and wo + d <= _DELETED_EDGE_TOL * (abs(wo) + abs(d)):
                deleted.append(key)
            out_snd[lane] = min(s_lo, s_hi)
            out_rcv[lane] = max(s_lo, s_hi)
            out_dw[lane] = d
            out_wold[lane] = wo
            out_mask[lane] = 1.0
            out_slot[lane] = slot

        out_nid = out_nflag = None
        freed_nodes: List[int] = []
        if delta.node_ids is not None:
            j_pad = nid.shape[0]
            out_nid = np.zeros(j_pad, np.int32)
            out_nflag = np.zeros(j_pad, np.float32)
            for lane, (vid, flag) in enumerate(zip(nid.tolist(),
                                                   nflag.tolist())):
                if flag > 0:
                    out_nid[lane] = slot_of(vid)
                    out_nflag[lane] = 1.0
                elif flag < 0:
                    slot = slot_of(vid)
                    if slot is None:
                        continue  # leave of an inactive node: a no-op
                    out_nid[lane] = slot
                    out_nflag[lane] = -1.0
                    freed_nodes.append(vid)

        slot_delta = GraphDelta(
            senders=torch.from_numpy(out_snd),
            receivers=torch.from_numpy(out_rcv),
            dw=torch.from_numpy(out_dw),
            w_old=torch.from_numpy(out_wold),
            mask=torch.from_numpy(out_mask),
            n_nodes=self.layout.n_slots,
            node_ids=None if out_nid is None else torch.from_numpy(out_nid),
            node_flag=(None if out_nflag is None
                       else torch.from_numpy(out_nflag)),
            layout_generation=None,
            edge_slots=torch.from_numpy(out_slot),
        )
        return _StagedTranslation(
            delta=slot_delta, staged_nodes=staged_nodes,
            staged_edges=staged_edges, deleted=deleted,
            freed_nodes=freed_nodes)

    def commit(self, staged: "_StagedTranslation") -> GraphDelta:
        """Apply a staged translation to the map and return its
        slot-space delta. The staged slots index this map's free lists,
        so nothing may stage or commit on this map in between."""
        staged_nodes = staged.staged_nodes
        staged_edges = staged.staged_edges
        if staged_nodes:
            del self._free_nodes[-len(staged_nodes):]
            for vid, slot in staged_nodes.items():
                self.node_slot[vid] = slot
                self._node_edges.setdefault(vid, set())
        if staged_edges:
            del self._free_edges[-len(staged_edges):]
            for key, slot in staged_edges.items():
                self.edge_slot[key] = slot
                self._node_edges.setdefault(key[0], set()).add(key)
                self._node_edges.setdefault(key[1], set()).add(key)
        for key in staged.deleted:
            self._release_edge(key)
        for vid in staged.freed_nodes:
            for key in list(self._node_edges.get(vid, ())):
                # isolated-leave contract: normally already deleted
                self._release_edge(key)
            self._node_edges.pop(vid, None)
            self._free_nodes.append(self.node_slot.pop(vid))
        return staged.delta

    def _release_edge(self, key: Tuple[int, int]) -> None:
        slot = self.edge_slot.pop(key, None)
        if slot is None:
            return
        self._free_edges.append(slot)
        for vid in key:
            edges = self._node_edges.get(vid)
            if edges is not None:
                edges.discard(key)


@dataclasses.dataclass
class _StagedTranslation:
    """One `SlotMap.stage` result awaiting `commit` (see SlotMap)."""

    delta: GraphDelta
    staged_nodes: Dict[int, int]
    staged_edges: Dict[Tuple[int, int], int]
    deleted: List[Tuple[int, int]]
    freed_nodes: List[int]


# ---------------------------------------------------------------------------
# Construction from host graphs
# ---------------------------------------------------------------------------

Graph = Union[DenseGraph, EdgeList]


def _edges_and_active(g: Graph):
    """(lo, hi, w, active) of a host graph: its nonzero undirected edges
    with lo < hi in (lo, hi) lexicographic order, and its active node
    ids in ascending order.

    The reference reads the edges off the upper triangle of the dense
    (n, n) matrix; for an `EdgeList` this gives the same edges and
    weights from the edge list alone. Lanes of one edge are summed in
    the order the reference's two scatters add them (lanes stored as
    (lo, hi) first, then those stored as (hi, lo), each in lane order);
    self-loops and edges whose sum is 0 are dropped, and masked weights
    are 0 on padding and on edges touching an inactive node.
    """
    if g.node_mask is None:
        active = np.arange(g.n_nodes, dtype=np.int64)
    else:
        active = np.flatnonzero(_host(g.node_mask, np.float32) > 0)
    if isinstance(g, DenseGraph):
        w = _host(g.masked_weights(), np.float32)
        lo, hi = np.triu_indices(g.n_nodes, k=1)
        vals = w[lo, hi]
        nz = vals != 0.0
        return lo[nz], hi[nz], vals[nz], active
    w = _host(g.masked_weights(), np.float32)
    snd = _host(g.senders, np.int64)
    rcv = _host(g.receivers, np.int64)
    keep = (w != 0.0) & (snd != rcv)
    order = np.flatnonzero(keep)
    order = order[np.argsort(snd[order] > rcv[order], kind="stable")]
    lo = np.minimum(snd[order], rcv[order])
    hi = np.maximum(snd[order], rcv[order])
    keys, inv = np.unique(lo * np.int64(g.n_nodes) + hi,
                          return_inverse=True)
    vals = np.zeros(keys.size, np.float32)
    np.add.at(vals, inv.reshape(-1), w[order])
    nz = vals != 0.0
    keys, vals = keys[nz], vals[nz]
    return keys // g.n_nodes, keys % g.n_nodes, vals, active


def sparse_state_from_graph(
    g: Graph,
    layout: SparseLayout,
    n_virtual: Optional[int] = None,
    stream: Optional[int] = None,
) -> Tuple[SparseStreamState, SlotMap]:
    """Host graph → (slot-space state, its `SlotMap`), one O(n + m) pass.

    Active nodes take slots in ascending virtual-id order and edges in
    (i, j) lexicographic order, with the free lists in the reference's
    stack order, so state and map equal the reference's. Built from the
    edge list: no (n, n) matrix is formed for an `EdgeList`. The
    statistics are computed on the slot-space graph (relabelling
    invariance makes them the virtual graph's). CPU tensors.
    """
    n_virtual = g.n_nodes if n_virtual is None else int(n_virtual)
    if g.n_nodes > n_virtual:
        raise ValueError(
            f"sparse_state_from_graph: graph n_nodes={g.n_nodes} "
            f"exceeds the virtual bound n_virtual={n_virtual}")
    lo, hi, vals, active = _edges_and_active(g)
    if active.size > layout.n_slots:
        raise SparseCapacityError(
            f"sparse_state_from_graph: {active.size} active node(s) "
            f"exceed n_slots={layout.n_slots}; use a larger capacity")
    m = int(lo.size)
    if m > layout.m_pad:
        raise SparseCapacityError(
            f"sparse_state_from_graph: {m} edge(s) exceed "
            f"m_pad={layout.m_pad}; use a larger capacity")

    # Active node r takes slot r and edge l takes slot l: the slots the
    # reference pops off its fresh free lists in that order.
    slot_map = SlotMap(layout, n_virtual, stream=stream)
    n_act = int(active.size)
    vids = active.tolist()
    slot_map.node_slot = dict(zip(vids, range(n_act)))
    del slot_map._free_nodes[len(slot_map._free_nodes) - n_act:]
    keys = list(zip(lo.tolist(), hi.tolist()))
    slot_map.edge_slot = dict(zip(keys, range(m)))
    del slot_map._free_edges[len(slot_map._free_edges) - m:]
    node_edges = {v: set() for v in vids}
    for key in keys:
        node_edges[key[0]].add(key)
        node_edges[key[1]].add(key)
    slot_map._node_edges = node_edges

    snd = np.searchsorted(active, lo).astype(np.int32)
    rcv = np.searchsorted(active, hi).astype(np.int32)
    ew = np.zeros(layout.m_pad, np.float32)
    ew[:m] = vals
    slot_mask = np.zeros(layout.n_slots, np.float32)
    slot_mask[:n_act] = 1.0
    el = EdgeList.from_arrays(
        snd, rcv, vals, n_nodes=layout.n_slots, m_pad=max(m, 1),
        n_pad=layout.n_slots, node_mask=torch.from_numpy(slot_mask))
    fs = finger_state(el)
    state = SparseStreamState(
        q=fs.q, s_total=fs.s_total, s_max=fs.s_max,
        strengths=fs.strengths, node_mask=torch.from_numpy(slot_mask),
        edge_weights=torch.from_numpy(ew), layout=layout)
    return state, slot_map


def sparse_states_from_graphs(
    graphs: Iterable[Graph],
    layout: SparseLayout,
    n_virtual: int,
) -> Tuple[SparseStreamState, List[SlotMap]]:
    """B host graphs → stacked (B, …) sparse state + per-stream maps.

    ``graphs`` may be any iterable and is consumed one graph at a time,
    so a generator never holds more than one virtual-space graph (whose
    node mask alone is n_virtual floats) in memory.
    """
    states, maps = [], []
    for i, g in enumerate(graphs):
        st, sm = sparse_state_from_graph(g, layout, n_virtual=n_virtual,
                                         stream=i)
        states.append(st)
        maps.append(sm)
    if not states:
        raise ValueError("sparse_states_from_graphs: empty stream list")
    return stack_sparse_states(states), maps
