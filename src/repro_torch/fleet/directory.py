"""The fleet's tenant directory: who lives where, and how to rebuild
them.

The port's counterpart of `repro.fleet.directory`; `to_json` and
`from_json` equal the reference's key for key, so a ``fleet.json``
written by either package reads in the other.

One `TenantEntry` per tenant holds the routing triple
(pool, shard, slot), the tenant's *virtual→position* map into its
shard's node layout, and the recovery material: a tenant-space base
state snapshot plus a write-ahead log of the tenant's own deltas since
that base. The WAL is what makes shard failure survivable without
replicating device state — a dead shard's tenants are rebuilt as
``base ⊕ replay(wal)`` and re-installed on survivors.

All tenant-space: ``slot_of_node[v]`` maps the tenant's own node id
``v`` (its private, zero-based node space) to a slot position inside
its stream's row on the shard (-1 = never placed). Sparse-pool tenants
carry no map (the shard's `SlotMap` owns the translation; virtual ids
pass through).

The directory indexes its entries by shard and by slot, and an entry
that belongs to a directory re-indexes itself when its routing triple
is assigned, so the router's load, free-slot and slot→tenant queries
cost the shard's tenants, not the whole fleet's (a fleet admits
thousands of tenants).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.fleet.errors import UnknownTenantError
from repro_torch.graphs.layout import compose_index_maps
from repro_torch.graphs.types import GraphDelta

_ROUTING = ("pool", "shard", "slot")


@dataclasses.dataclass
class TenantEntry:
    """One tenant's placement + recovery material (mutable; the
    directory is host-side bookkeeping, not device state)."""

    name: str
    pool: int
    shard: int
    slot: int
    n_nodes: int
    # virtual node id -> position in the stream row (-1 unplaced);
    # None for sparse-pool tenants (virtual ids pass through).
    slot_of_node: Optional[np.ndarray]
    base_step: int = 0
    # Tenant-space FingerState snapshot at base_step:
    # {q, s_total, s_max, strengths(n,), node_mask(n,)} — None means
    # "on disk" (the shard checkpoint at base_step holds it).
    base_state: Optional[dict] = None
    # (fleet_step, tenant-space GraphDelta) since base_step, oldest
    # first. Replayed during recovery.
    wal: List[Tuple[int, GraphDelta]] = dataclasses.field(
        default_factory=list)
    last_score: float = 0.0
    # Fleet step at which this tenant's row was (re)installed on its
    # current shard (admit/promote/recover). Until the shard ticks
    # past it, the device score at the slot is stale — `scores`
    # reports `last_score` instead. Transient (not serialized).
    installed_step: int = -1
    # Highest WAL step ever pruned for this tenant (retention policy or
    # save-time truncation). Recovery needs the contiguous range
    # (base_step, now]; if wal_floor > base_step, part of that range is
    # gone and `recover()` must raise instead of silently replaying a
    # gapped log.
    wal_floor: int = 0

    def __setattr__(self, name, value):
        directory = self.__dict__.get("_directory")
        if directory is None or name not in _ROUTING:
            object.__setattr__(self, name, value)
            return
        directory._unindex(self)
        object.__setattr__(self, name, value)
        directory._index(self)

    def used_positions(self) -> np.ndarray:
        """Positions this tenant occupies in its stream row."""
        if self.slot_of_node is None:
            return np.zeros((0,), np.int32)
        return self.slot_of_node[self.slot_of_node >= 0]

    def to_json(self) -> dict:
        return {
            "name": self.name, "pool": self.pool, "shard": self.shard,
            "slot": self.slot, "n_nodes": int(self.n_nodes),
            "slot_of_node": None if self.slot_of_node is None
            else [int(p) for p in self.slot_of_node],
            "base_step": int(self.base_step),
            "last_score": float(self.last_score),
            "wal_floor": int(self.wal_floor),
        }

    @classmethod
    def from_json(cls, d: dict) -> "TenantEntry":
        som = d.get("slot_of_node")
        return cls(name=d["name"], pool=int(d["pool"]),
                   shard=int(d["shard"]), slot=int(d["slot"]),
                   n_nodes=int(d["n_nodes"]),
                   slot_of_node=None if som is None
                   else np.asarray(som, np.int32),
                   base_step=int(d.get("base_step", 0)),
                   last_score=float(d.get("last_score", 0.0)),
                   wal_floor=int(d.get("wal_floor",
                                       d.get("base_step", 0))))


class TenantDirectory:
    """Name → `TenantEntry`, plus the shard-side reverse views the
    router and rebalancer need (indexed; see the module docstring).
    Iteration and every list it returns follow admission order."""

    def __init__(self):
        self._entries: Dict[str, TenantEntry] = {}
        self._order: Dict[str, int] = {}
        self._counter = itertools.count()
        # (pool, shard) -> name -> entry; (pool, shard, slot) -> name ->
        # entry; (pool, shard) -> heap of candidate free slots
        self._by_shard: Dict[Tuple[int, int], Dict[str, TenantEntry]] = {}
        self._by_slot: Dict[Tuple[int, int, int],
                            Dict[str, TenantEntry]] = {}
        self._free: Dict[Tuple[int, int], List[int]] = {}

    # -- the index ---------------------------------------------------------
    def _index(self, e: TenantEntry) -> None:
        self._by_shard.setdefault((e.pool, e.shard), {})[e.name] = e
        self._by_slot.setdefault((e.pool, e.shard, int(e.slot)),
                                 {})[e.name] = e

    def _unindex(self, e: TenantEntry) -> None:
        key = (e.pool, e.shard)
        self._by_shard.get(key, {}).pop(e.name, None)
        skey = (e.pool, e.shard, int(e.slot))
        at = self._by_slot.get(skey)
        if at is not None:
            at.pop(e.name, None)
            if not at:
                del self._by_slot[skey]
                if key in self._free:
                    heapq.heappush(self._free[key], int(e.slot))

    def _sorted(self, entries) -> List[TenantEntry]:
        return sorted(entries, key=lambda e: self._order[e.name])

    # -- the reference's surface ------------------------------------------
    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self):
        return iter(list(self._entries.values()))

    def names(self) -> List[str]:
        return list(self._entries)

    def add(self, entry: TenantEntry) -> None:
        if entry.name in self._entries:
            self.remove(entry.name)
        self._entries[entry.name] = entry
        self._order[entry.name] = next(self._counter)
        object.__setattr__(entry, "_directory", self)
        self._index(entry)

    def get(self, name: str) -> TenantEntry:
        try:
            return self._entries[name]
        except KeyError:
            raise UnknownTenantError(
                f"unknown tenant {name!r} "
                f"(have {sorted(self._entries)})") from None

    def remove(self, name: str) -> TenantEntry:
        entry = self._entries.pop(name)
        self._unindex(entry)
        del self._order[name]
        object.__setattr__(entry, "_directory", None)
        return entry

    def tenants_on(self, pool: int, shard: int) -> List[TenantEntry]:
        return self._sorted(self._by_shard.get((pool, shard), {}).values())

    def slots_in_use(self, pool: int, shard: int) -> set:
        return {e.slot for e in
                self._by_shard.get((pool, shard), {}).values()}

    def tenant_at(self, pool: int, shard: int,
                  slot: int) -> Optional[TenantEntry]:
        at = self._by_slot.get((pool, shard, int(slot)))
        if not at:
            return None
        return self._sorted(at.values())[0]

    # -- the router's O(1)/O(log n) queries --------------------------------
    def load(self, pool: int, shard: int) -> int:
        """Tenants on one shard (`len(slots_in_use(...))` for a
        directory whose slots are distinct)."""
        return len(self._by_shard.get((pool, shard), ()))

    def first_free_slot(self, pool: int, shard: int,
                        capacity: int) -> Optional[int]:
        """The smallest slot in ``[0, capacity)`` no tenant on the shard
        holds; None when all are taken."""
        key = (pool, shard)
        heap = self._free.get(key)
        if heap is None:
            heap = self._free[key] = list(range(capacity))
        while heap and (heap[0] >= capacity
                        or (pool, shard, heap[0]) in self._by_slot):
            heapq.heappop(heap)
        return heap[0] if heap else None

    def compose(self, pool: int, shard: int,
                index_map: np.ndarray) -> None:
        """A shard's layout migration (old→new position map) renumbers
        every tenant map on it — positions whose slot the compaction
        dropped become unplaced (-1), which is loss-free: a dropped
        slot was inactive in every stream."""
        for e in self.tenants_on(pool, shard):
            if e.slot_of_node is not None:
                e.slot_of_node = compose_index_maps(
                    e.slot_of_node, index_map)

    def to_json(self) -> list:
        return [e.to_json() for e in self._entries.values()]

    @classmethod
    def from_json(cls, entries: list) -> "TenantDirectory":
        d = cls()
        for rec in entries:
            d.add(TenantEntry.from_json(rec))
        return d
