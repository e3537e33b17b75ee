"""Tenant routing: bucket admission and per-tenant delta translation.

The port's counterpart of `repro.fleet.router`. The router owns two
host jobs:

- `place`: best-fit admission — the smallest bucket (pool) whose
  ``n_pad`` covers the tenant's node space and still has a free stream
  slot on a live shard, spilling upward through the bucket ladder;
  `AdmissionError` by name when nothing fits.
- `translate`: one tenant's *tenant-space* `GraphDelta` (node ids in
  the tenant's private zero-based space) → the *shard-space* delta its
  stream row ticks with — virtual ids mapped through the tenant's
  ``slot_of_node`` position map (joins allocate fresh positions), lanes
  re-padded to the pool's static ``k_pad``/``j_pad``, and the result
  stamped with the shard's live `NodeLayout` generation so a migration
  racing a staged tick is remapped by the serving grace machinery
  instead of scattering into stale slots. `stage_dense` is the same
  translation written straight into a shard's staging buffers (the
  dense fleet's ingest path).

Positions are per-stream: each stream row has its own (n_pad,) state,
so two tenants on one shard both use low positions — only the shared
static layout (and its migrations) couples them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.fleet.config import FleetConfig, PoolSpec
from repro_torch.fleet.directory import TenantDirectory, TenantEntry
from repro_torch.fleet.errors import AdmissionError, FleetIngestError
from repro_torch.graphs.types import GraphDelta, _drop_self_loops


def _host(x) -> np.ndarray:
    """A delta field as a host numpy array (a CPU tensor's own memory)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _first_seen(ids: np.ndarray) -> np.ndarray:
    """``ids`` without repeats, in the order of their first occurrence."""
    return np.fromiter(dict.fromkeys(ids.tolist()), np.int32,
                       count=-1) if ids.size > 1 else ids.astype(np.int32)


class ShardStage:
    """Preallocated (B, k_pad)/(B, j_pad) staging buffers for one
    shard's tick worth of translated tenant deltas.

    `stage_dense` writes each tenant's shard-space lanes straight into
    its slot's row; untouched rows stay all-zero — exactly the
    free-slot no-op delta. `finish` turns the buffers into ONE stacked
    `GraphDelta` (already (B, k_pad), so `FingerService.ingest` stacks
    nothing). The buffers are reused across ticks (`reset` zero-fills
    them in place), so the ingestor must hold its own copy of a tick's
    delta before the next `reset`; see `finish`.
    """

    def __init__(self, batch: int, k_pad: int, j_pad: Optional[int]):
        self.batch, self.k_pad, self.j_pad = batch, k_pad, j_pad
        self.senders = np.zeros((batch, k_pad), np.int32)
        self.receivers = np.zeros((batch, k_pad), np.int32)
        self.dw = np.zeros((batch, k_pad), np.float32)
        self.w_old = np.zeros((batch, k_pad), np.float32)
        self.mask = np.zeros((batch, k_pad), np.float32)
        if j_pad is None:
            self.node_ids = self.node_flag = None
        else:
            self.node_ids = np.zeros((batch, j_pad), np.int32)
            self.node_flag = np.zeros((batch, j_pad), np.float32)

    def _buffers(self) -> dict:
        out = {"senders": self.senders, "receivers": self.receivers,
               "dw": self.dw, "w_old": self.w_old, "mask": self.mask}
        if self.node_ids is not None:
            out["node_ids"] = self.node_ids
            out["node_flag"] = self.node_flag
        return out

    def reset(self) -> None:
        for buf in self._buffers().values():
            buf.fill(0)

    def write_row(self, slot: int, lo: np.ndarray, hi: np.ndarray,
                  dw: np.ndarray, w_old: np.ndarray,
                  join_pos: np.ndarray, leave_pos: np.ndarray) -> None:
        k = lo.shape[0]
        self.senders[slot, :k] = lo
        self.receivers[slot, :k] = hi
        self.dw[slot, :k] = dw
        self.w_old[slot, :k] = w_old
        self.mask[slot, :k] = 1.0
        if self.node_ids is not None and (join_pos.size
                                          or leave_pos.size):
            j, l = join_pos.size, leave_pos.size
            self.node_ids[slot, :j] = join_pos
            self.node_ids[slot, j:j + l] = leave_pos
            self.node_flag[slot, :j] = 1.0
            self.node_flag[slot, j:j + l] = -1.0

    def finish(self, svc) -> GraphDelta:
        """The tick's stacked (B, k_pad) shard-space GraphDelta, stamped
        with the shard's live layout generation.

        Its tensors share memory with the buffers only where the
        shard's ingestor copies them before `ingest` returns: the
        double-buffered ingestor on CUDA copies each delta into a pinned
        slot of its own. The sync ingestor, and the double-buffered one
        on the CPU, queue the tensors as given, so for them the buffers
        are copied here — the next tick's `reset` would otherwise
        rewrite a queued delta.
        """
        copy = svc.config.ingestion != "double_buffered" \
            or svc.device.type != "cuda"
        t = {k: torch.from_numpy(v.copy() if copy else v)
             for k, v in self._buffers().items()}
        return GraphDelta(n_nodes=svc.layout.n_pad,
                          layout_generation=svc.layout.generation, **t)


class FleetRouter:
    def __init__(self, config: FleetConfig,
                 directory: TenantDirectory):
        self._config = config
        self._directory = directory
        self._stages: Dict[Tuple[int, int], ShardStage] = {}

    # -- admission --------------------------------------------------------
    def place(self, n_required: int,
              live_shards: Dict[int, List[int]],
              min_pool: int = 0, max_pool: Optional[int] = None,
              dense_only: bool = False) -> Tuple[int, int, int]:
        """Best-fit (pool, shard, slot) for a tenant of ``n_required``
        node slots: ascending buckets from ``min_pool``, least-loaded
        live shard within the bucket, smallest free slot within the
        shard. ``dense_only`` restricts to dense pools (migrations and
        recovery install dense rows — a sparse edge store cannot be
        rebuilt from FINGER statistics)."""
        pools = self._config.pools
        hi = len(pools) if max_pool is None else max_pool + 1
        for pool_i in range(min_pool, hi):
            pool = pools[pool_i]
            if dense_only and pool.method == "sparse_tick":
                continue
            if n_required > pool.n_pad:
                continue
            best = None
            for shard_i in live_shards.get(pool_i, []):
                load = self._directory.load(pool_i, shard_i)
                if load >= pool.streams_per_shard:
                    continue
                if best is None or load < best[1]:
                    best = (shard_i, load)
            if best is not None:
                shard_i = best[0]
                slot = self._directory.first_free_slot(
                    pool_i, shard_i, pool.streams_per_shard)
                return pool_i, shard_i, slot
        raise AdmissionError(
            f"no pool can host a tenant of {n_required} node slot(s) "
            f"(buckets {[(p.name, p.n_pad) for p in pools]}, "
            f"searched pools [{min_pool}, {hi}), "
            f"dense_only={dense_only}) — every fitting bucket is full "
            "or too small")

    # -- delta translation ------------------------------------------------
    @staticmethod
    def _split_node_slots(delta: GraphDelta
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Tenant-space (join_ids, leave_ids) from the delta's node
        lanes (deduplicated, order-preserving)."""
        z = np.zeros((0,), np.int32)
        if delta.node_ids is None:
            return z, z
        flag = _host(delta.node_flag)
        if not flag.any():
            return z, z
        ids = _host(delta.node_ids)
        return _first_seen(ids[flag > 0]), _first_seen(ids[flag < 0])

    def required_positions(self, entry: TenantEntry,
                           delta: GraphDelta) -> int:
        """Stream-row positions the tenant needs *after* this delta:
        its placed high-water count plus the delta's first-time joins.
        Positions are never freed on leave (a rejoining node reuses
        its slot), so this is monotone — the promotion trigger."""
        if entry.slot_of_node is None:
            return entry.n_nodes  # sparse: virtual bound governs
        join, _ = self._split_node_slots(delta)
        som = entry.slot_of_node
        placed = int(np.count_nonzero(som >= 0))
        new = sum(1 for v in join.tolist()
                  if v >= som.shape[0] or som[v] < 0)
        return placed + new

    @staticmethod
    def _check_node_lanes(entry: TenantEntry, pool: PoolSpec,
                          join: np.ndarray, leave: np.ndarray) -> None:
        if (join.size or leave.size) and pool.j_pad is None:
            raise FleetIngestError(
                f"tenant {entry.name!r}: delta carries node "
                f"join/leave slots but pool {pool.name!r} has "
                "j_pad=None (no node lanes); use a pool with join "
                "slots")

    def translate(self, entry: TenantEntry, delta: GraphDelta,
                  svc, pool: PoolSpec) -> GraphDelta:
        """Tenant-space delta → shard-space delta for ``entry``'s
        stream (see module docstring). Mutates the entry's
        ``slot_of_node`` (join placement) — call once per delta."""
        join, leave = self._split_node_slots(delta)
        self._check_node_lanes(entry, pool, join, leave)
        if pool.method == "sparse_tick":
            return self._translate_sparse(entry, delta, join, leave,
                                          pool)
        snd, rcv, dw, w_old, join_pos, leave_pos = self._dense_lanes(
            entry, delta, join, leave, svc)
        try:
            return GraphDelta.from_arrays(
                snd, rcv, dw, w_old, n_nodes=svc.layout.n_pad,
                k_pad=pool.k_pad, j_pad=pool.j_pad, join=join_pos,
                leave=leave_pos, layout=svc.layout)
        except ValueError as e:
            raise FleetIngestError(
                f"tenant {entry.name!r}: {e}") from e

    def _translate_sparse(self, entry, delta, join, leave,
                          pool: PoolSpec) -> GraphDelta:
        """Sparse shards translate virtual ids themselves (per-stream
        `SlotMap`s inside the service); the fleet only re-pads the
        lanes to the pool's static sizes."""
        m = _host(delta.mask) > 0
        if delta.n_nodes > pool.n_pad:
            raise FleetIngestError(
                f"tenant {entry.name!r}: delta addresses "
                f"{delta.n_nodes} virtual node(s), beyond pool "
                f"{pool.name!r}'s virtual bound n_pad={pool.n_pad}")
        try:
            return GraphDelta.from_arrays(
                _host(delta.senders)[m], _host(delta.receivers)[m],
                _host(delta.dw)[m], _host(delta.w_old)[m],
                n_nodes=delta.n_nodes, n_pad=pool.n_pad,
                k_pad=pool.k_pad, j_pad=pool.j_pad,
                join=join, leave=leave)
        except ValueError as e:
            raise FleetIngestError(
                f"tenant {entry.name!r}: {e}") from e

    def _dense_lanes(self, entry: TenantEntry, delta: GraphDelta,
                     join: np.ndarray, leave: np.ndarray, svc):
        """The dense translation shared by `translate` and
        `stage_dense`: place first-time joins at the smallest positions
        the tenant does not hold, map the live lanes and the node lanes
        through ``slot_of_node``, and reject by name what the tenant
        never joined. Returns (senders, receivers, Δw, w_old, join
        positions, leave positions) in shard space."""
        som = entry.slot_of_node
        if delta.n_nodes > som.shape[0]:
            som = np.concatenate([
                som, np.full((delta.n_nodes - som.shape[0],), -1,
                             np.int32)])
            entry.slot_of_node = som
            entry.n_nodes = int(delta.n_nodes)
        n_pad = svc.layout.n_pad
        new = [v for v in join.tolist() if som[v] < 0]
        if new:
            used = set(som[som >= 0].tolist())
            pos = 0
            for v in new:
                while pos in used:
                    pos += 1
                if pos >= n_pad:
                    # ensure_capacity should have repadded/promoted
                    # first; reaching here means the caller skipped it.
                    raise FleetIngestError(
                        f"tenant {entry.name!r}: join of node {v} "
                        f"overflows the shard layout n_pad={n_pad}; "
                        "the rebalancer must repad or promote first")
                som[v] = pos
                used.add(pos)
        m = _host(delta.mask) > 0
        senders, receivers = _host(delta.senders)[m], _host(delta.receivers)[m]
        snd, rcv = som[senders], som[receivers]
        if (snd < 0).any() or (rcv < 0).any():
            bad = sorted(set(senders[snd < 0].tolist()
                             + receivers[rcv < 0].tolist()))
            raise FleetIngestError(
                f"tenant {entry.name!r}: delta edge(s) touch node(s) "
                f"{bad} the tenant never joined")
        leave_pos = som[leave.astype(np.int64)] if leave.size \
            else np.zeros((0,), np.int32)
        if leave.size and (leave_pos < 0).any():
            bad = sorted(leave[leave_pos < 0].tolist())
            raise FleetIngestError(
                f"tenant {entry.name!r}: leave of never-joined "
                f"node(s) {bad}")
        join_pos = som[join.astype(np.int64)] if join.size \
            else np.zeros((0,), np.int32)
        return (snd.astype(np.int32), rcv.astype(np.int32),
                _host(delta.dw).astype(np.float32, copy=False)[m],
                _host(delta.w_old).astype(np.float32, copy=False)[m],
                join_pos.astype(np.int32), leave_pos.astype(np.int32))

    # -- vectorized staging (the dense fleet ingest path) -----------------
    def stage_for(self, key: Tuple[int, int],
                  pool: PoolSpec) -> ShardStage:
        """The (zeroed) staging buffers of one dense shard's tick,
        reused across ticks — allocation happens once per shard, not
        once per tick."""
        stage = self._stages.get(key)
        if stage is None or (stage.batch, stage.k_pad, stage.j_pad) != \
                (pool.streams_per_shard, pool.k_pad, pool.j_pad):
            stage = ShardStage(pool.streams_per_shard, pool.k_pad,
                               pool.j_pad)
            self._stages[key] = stage
        else:
            stage.reset()
        return stage

    def stage_dense(self, entry: TenantEntry, delta: GraphDelta,
                    svc, pool: PoolSpec, stage: ShardStage) -> None:
        """The dense `translate`, written into the staging buffers: the
        same tenant→slot position math and the same named rejections,
        but the result lands directly in ``stage``'s row ``entry.slot``
        instead of allocating a per-tenant `GraphDelta`. Mutates
        ``entry.slot_of_node`` (join placement) — call once per
        (tenant, tick)."""
        join, leave = self._split_node_slots(delta)
        self._check_node_lanes(entry, pool, join, leave)
        snd, rcv, dw, w_old, join_pos, leave_pos = self._dense_lanes(
            entry, delta, join, leave, svc)
        snd, rcv, dw, w_old = _drop_self_loops(
            snd, rcv, dw, w_old, kind="FleetRouter.stage_dense")
        if snd.shape[0] > pool.k_pad:
            raise FleetIngestError(
                f"tenant {entry.name!r}: k={snd.shape[0]} delta edges "
                f"exceed k_pad={pool.k_pad}")
        j = int(join.size + leave.size)
        if pool.j_pad is not None and j > pool.j_pad:
            raise FleetIngestError(
                f"tenant {entry.name!r}: {j} node join/leave slots "
                f"exceed j_pad={pool.j_pad}")
        stage.write_row(entry.slot, np.minimum(snd, rcv),
                        np.maximum(snd, rcv), dw, w_old, join_pos,
                        leave_pos)

    def empty_delta(self, pool: PoolSpec, svc) -> GraphDelta:
        """The free-slot no-op delta of one shard tick (stamped with
        the shard's live layout for dense pools, so it stacks with
        translated tenant deltas)."""
        z = np.zeros((0,), np.float32)
        if pool.method == "sparse_tick":
            return GraphDelta.from_arrays(
                z, z, z, z, n_nodes=0, n_pad=pool.n_pad,
                k_pad=pool.k_pad, j_pad=pool.j_pad)
        return GraphDelta.from_arrays(
            z, z, z, z, n_nodes=0, k_pad=pool.k_pad,
            j_pad=pool.j_pad, layout=svc.layout)
