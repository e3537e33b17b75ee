"""Live cross-shard tenant migration and occupancy-driven shard upkeep.

The port's counterpart of `repro.fleet.rebalance`. `Rebalancer` is the
fleet's migration engine, built on the serving layer's machinery:

- **Promotion** (tenant outgrows its bucket): checkpoint-through — the
  tenant's stream row is extracted from its shard
  (`FingerService.extract_stream`, a copy of the row), gathered into
  *tenant space* through its position map (or its stream's `SlotMap`
  for a sparse tenant), re-embedded at identity positions into a shard
  of a bigger bucket (`install_stream`), and its old slot zeroed
  (`clear_stream`). Exact: every FINGER statistic is invariant under
  position relabeling and zero padding.
- **Auto-compaction**: a dense shard whose live-slot occupancy drops
  below `FleetConfig.compact_occupancy` is compacted to its live count
  (`FingerService.compact`, on the device, with the plan from the warm
  `PlanCache`), and the dropped-slot renumbering is composed into every
  resident tenant's position map.
- **Warming**: per shard, the plans a steady-state rebalance can hit
  (the pool-size regrow target, the pending compaction target), each
  stream-row hook run once on zero dummies, and the stacked pool ticks
  of the current and the predicted groupings. The port compiles
  nothing, so warming is the first use of each shape (the kernels'
  load, the allocator's blocks); it returns the reference's report.
  With ``background=True`` it runs on a thread of its own
  (`WarmupHandle`), on a CUDA stream of its own.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.fleet import pooltick
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving import migrate
from repro_torch.serving.service import WarmupHandle


class Rebalancer:
    def __init__(self, fleet):
        self._fleet = fleet

    # -- capacity-driven migration ---------------------------------------
    def ensure_capacity(self, name: str, delta: GraphDelta) -> Optional[str]:
        """Make ``name``'s shard able to absorb ``delta``: no-op when
        it fits, a warm `repad` back to the pool bound when the shard
        was compacted below it, a promotion to the next bucket when the
        tenant outgrows the pool itself. Returns the action taken
        (None / "repad" / "promote")."""
        fleet = self._fleet
        entry = fleet.directory.get(name)
        pool = fleet.config.pools[entry.pool]
        if pool.method == "sparse_tick":
            return None  # virtual bound is the pool bound; static
        required = fleet.router.required_positions(entry, delta)
        svc = fleet.shard_service(entry.pool, entry.shard)
        if required <= svc.layout.n_pad:
            return None
        if required <= pool.n_pad:
            svc.repad(pool.n_pad)
            return "repad"
        self.promote(name)
        return "promote"

    def promote(self, name: str,
                to_pool: Optional[str] = None) -> dict:
        """Move one tenant to a bigger bucket, live (see module
        docstring). Returns a small report dict; propagates
        `AdmissionError` when no bigger bucket has room.

        Sparse-pool tenants promote too: their FINGER row is gathered
        to tenant space through the stream's host `SlotMap` (virtual
        id → slot) instead of a dense position map, then re-embedded
        at identity positions into a dense bucket; the tenant's
        edge-slot store is left behind (the dense methods carry none)."""
        fleet = self._fleet
        entry = fleet.directory.get(name)
        pool = fleet.config.pools[entry.pool]
        src = fleet.shard_service(entry.pool, entry.shard)
        if to_pool is None:
            min_pool, max_pool = entry.pool + 1, None
        else:
            min_pool = max_pool = fleet.config.pool_index(to_pool)
        tgt_pool, tgt_shard, tgt_slot = fleet.router.place(
            entry.n_nodes, fleet.live_shards(), min_pool=min_pool,
            max_pool=max_pool, dense_only=True)
        # Checkpoint-through: device row -> host -> tenant space.
        row = src.extract_stream(entry.slot).to("cpu")
        if pool.method == "sparse_tick":
            base = self._sparse_row_to_tenant(
                row, entry, src.slot_maps[entry.slot])
        else:
            base = self._row_to_tenant(row, entry)
        fleet.install_dense(tgt_pool, tgt_shard, tgt_slot, base)
        src.clear_stream(entry.slot)
        old = (entry.pool, entry.shard, entry.slot)
        entry.pool, entry.shard, entry.slot = (tgt_pool, tgt_shard,
                                               tgt_slot)
        entry.slot_of_node = np.arange(entry.n_nodes, dtype=np.int32)
        entry.base_state = base
        entry.base_step = fleet.step
        entry.wal = []
        entry.wal_floor = fleet.step
        entry.installed_step = fleet.step
        return {"tenant": name, "from": old,
                "to": (tgt_pool, tgt_shard, tgt_slot),
                "n_nodes": entry.n_nodes}

    @staticmethod
    def _scalars(row) -> dict:
        return {"q": float(row.q), "s_total": float(row.s_total),
                "s_max": float(row.s_max)}

    @classmethod
    def _row_to_tenant(cls, row, entry) -> dict:
        """One extracted stream row -> tenant-space base snapshot
        (strengths/mask gathered through the position map; the scalar
        statistics are position-invariant)."""
        n_t = entry.n_nodes
        som = entry.slot_of_node
        strengths = np.zeros((n_t,), np.float32)
        mask = np.zeros((n_t,), np.float32)
        valid = np.nonzero(som >= 0)[0]
        row_s = row.strengths.numpy()
        row_m = np.ones_like(row_s) if row.node_mask is None \
            else row.node_mask.numpy()
        strengths[valid] = row_s[som[valid]]
        mask[valid] = row_m[som[valid]]
        return {**cls._scalars(row), "strengths": strengths,
                "node_mask": mask}

    @classmethod
    def _sparse_row_to_tenant(cls, row, entry, slot_map) -> dict:
        """One extracted sparse stream row -> tenant-space base
        snapshot. Sparse tenants carry no dense position map; the
        stream's host `SlotMap` (virtual id → node slot) is the
        gather. Only slots the map owns are read — free slots hold
        exact zeros either way."""
        n_t = entry.n_nodes
        strengths = np.zeros((n_t,), np.float32)
        mask = np.zeros((n_t,), np.float32)
        row_s = row.strengths.numpy()
        row_m = row.node_mask.numpy()
        for vid, slot in slot_map.node_slot.items():
            if vid < n_t:
                strengths[vid] = row_s[slot]
                mask[vid] = row_m[slot]
        return {**cls._scalars(row), "strengths": strengths,
                "node_mask": mask}

    # -- occupancy-driven upkeep -----------------------------------------
    def maybe_compact(self, pool_i: int, shard_i: int):
        """Compact one dense shard when its live-slot occupancy fell
        below the fleet threshold; compose the renumbering into every
        resident tenant's position map. Returns the
        `CompactionReport` or None."""
        fleet = self._fleet
        pool = fleet.config.pools[pool_i]
        if pool.method == "sparse_tick":
            return None
        svc = fleet.shard_service(pool_i, shard_i)
        n_pad = svc.layout.n_pad
        n_live = migrate.live_slot_count(svc.states())
        if n_live == 0 or n_live >= n_pad:
            return None
        if n_live / n_pad >= fleet.config.compact_occupancy:
            return None
        report = svc.compact()
        if report.new_n_pad < report.old_n_pad:
            fleet.directory.compose(pool_i, shard_i, report.index_map)
        return report

    def auto_rebalance(self) -> List[dict]:
        """One upkeep sweep over every live dense shard. Safe to run
        with a staged tick: compaction remaps the queued deltas
        through the serving grace machinery (the in-flight-delta
        survival path)."""
        actions = []
        fleet = self._fleet
        for pool_i, shard_i in fleet.live_shard_ids():
            report = self.maybe_compact(pool_i, shard_i)
            if report is not None:
                actions.append({
                    "action": "compact", "pool": pool_i,
                    "shard": shard_i,
                    "old_n_pad": report.old_n_pad,
                    "new_n_pad": report.new_n_pad})
        return actions

    # -- warming ----------------------------------------------------------
    def warm(self, background: bool = False
             ) -> Union[list, WarmupHandle]:
        """Warm every plan, hook and stacked tick the steady-state
        rebalance path can touch (see module docstring)."""
        if not background:
            return self._warm_all()
        device = self._fleet.device

        def run() -> list:
            if device.type != "cuda":
                return self._warm_all()
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                with torch.cuda.stream(stream):
                    warmed = self._warm_all()
                stream.synchronize()
                return warmed

        return WarmupHandle(run)

    def _warm_all(self) -> list:
        warmed = []
        fleet = self._fleet
        for pool_i, shard_i in fleet.live_shard_ids():
            pool = fleet.config.pools[pool_i]
            svc = fleet.shard_service(pool_i, shard_i)
            targets = []
            if pool.method != "sparse_tick":
                if svc.layout.n_pad < pool.n_pad:
                    targets.append(pool.n_pad)
                n_live = migrate.live_slot_count(svc.states())
                if 0 < n_live < svc.layout.n_pad:
                    targets.append(n_live)
            done = svc.warm_next_layouts(targets)
            # The stream-row hooks a promotion runs (row copy, row
            # write, row clear) and the one-slot score read, once each
            # on zero dummies of the shard's shapes.
            dummy = svc.states().map_tensors(torch.zeros_like)
            row = migrate.take_stream(dummy, 0)
            migrate.put_stream(dummy, row.to("cpu"), 0)
            migrate.clear_stream(dummy, 0)
            float(torch.zeros((pool.streams_per_shard,),
                              device=svc.device)[0])
            warmed.append({"pool": pool.name, "shard": shard_i,
                           "layouts": done})
        warmed.extend(self._warm_pool_ticks())
        return warmed

    def _warm_pool_ticks(self) -> list:
        """Run once the stacked pool ticks the fleet's steady-state
        `poll()` can hit: the current layout grouping of every pool,
        plus — for the dense methods — every regrouping one upkeep
        action away: a compaction peels one shard into a singleton
        group at its compacted layout (leaving the rest of its group
        one shard smaller), a repad peels it back out at the pool
        bound. Sparse shards have no compaction/repad surface, so only
        their current capacity grouping is warmed."""
        fleet = self._fleet
        warmed = []
        if not fleet.config.stacked_ticks:
            return warmed
        by_pool: Dict[int, list] = {}
        for pool_i, shard_i in fleet.live_shard_ids():
            by_pool.setdefault(pool_i, []).append(shard_i)
        for pool_i, shard_ids in sorted(by_pool.items()):
            pool = fleet.config.pools[pool_i]
            if not pooltick.stackable(pool.method):
                continue
            groups: Dict[tuple, list] = {}
            for shard_i in shard_ids:
                svc = fleet.shard_service(pool_i, shard_i)
                key = (svc.layout.n_pad, svc.layout.generation,
                       svc.capacity)
                groups.setdefault(key, []).append(svc)
            plans = []
            for members in groups.values():
                if pool.method == "sparse_tick":
                    plans.append([(s.config, s.capacity)
                                  for s in members])
                    continue
                cur = [(s.config.with_(n_pad=s.layout.n_pad), s.layout)
                       for s in members]
                plans.append(cur)
                for i, svc in enumerate(members):
                    peeled = cur[:i] + cur[i + 1:]
                    targets = []
                    n_live = migrate.live_slot_count(svc.states())
                    if 0 < n_live < svc.layout.n_pad:
                        targets.append(
                            (svc.config.with_(n_pad=n_live),
                             svc.layout.compacted(n_live)))
                    if svc.layout.n_pad < pool.n_pad:
                        targets.append(
                            (svc.config.with_(n_pad=pool.n_pad),
                             svc.layout.grown(pool.n_pad)))
                    for tgt in targets:
                        plans.append([tgt])
                        if peeled:
                            plans.append(peeled)
            seen = set()
            count = 0
            for entries in plans:
                if not entries:
                    continue
                sig = tuple(lay for _, lay in entries)
                if sig in seen:
                    continue
                seen.add(sig)
                pooltick.warm_pool_tick(entries, device=fleet.device)
                count += 1
            warmed.append({"pool": pool.name,
                           "stacked_groups": count})
        return warmed
