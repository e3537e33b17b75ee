"""`FingerFleet`: the multi-tenant serving fleet facade.

The port's counterpart of `repro.fleet.fleet`. One fleet = ordered
buckets (pools) of `FingerService` shards on one device + a tenant
directory. Tenants are admitted with a host graph, stream tenant-space
deltas through `ingest`/`poll` (strict alternation; every live shard
ticks every poll, so shard step == fleet step always), are promoted
across buckets when they outgrow one, survive shard death
(`kill_shard`/`recover`), and persist as a whole (`save`/`restore` —
per-shard serving checkpoints + one ``fleet.json`` tenant manifest,
read by both packages).

The fleet runs on CUDA unless opened (or restored) with
``device="cpu"``; recovery replays on the same device. With
``FleetConfig.stacked_ticks`` each pool's live shards tick as one
launch per layout group (`fleet.pooltick`), and the group's (S, B)
score matrix stays on the device as the tick's score plane: `scores`
and `top_anomalies` read it to the host at most once per group per
tick, and never gather a shard's full scores otherwise.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparse import SparseCapacityError, sparse_state_from_graph
from repro_torch.core.state import FingerState, finger_state
from repro_torch.fleet import pooltick
from repro_torch.fleet.config import FleetConfig
from repro_torch.fleet.directory import TenantDirectory, TenantEntry
from repro_torch.fleet.errors import (AdmissionError, FleetConfigError,
                                      FleetLifecycleError,
                                      ShardUnavailableError)
from repro_torch.fleet.rebalance import Rebalancer
from repro_torch.fleet.recovery import DeadShard, recover_shard
from repro_torch.fleet.router import FleetRouter
from repro_torch.graphs.types import DenseGraph, GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.serving import FingerService
from repro_torch.serving.service import ServiceLifecycleError, WarmupHandle

_MANIFEST = "fleet.json"


class FingerFleet:
    """Build with `open` (fresh) or `restore` (from a fleet
    directory); never construct directly."""

    def __init__(self, config: FleetConfig,
                 shards: List[List[Optional[FingerService]]],
                 directory: TenantDirectory, device: torch.device,
                 step: int = 0):
        self._config = config
        self._shards = shards
        self._directory = directory
        self._device = device
        self._router = FleetRouter(config, directory)
        self._rebalancer = Rebalancer(self)
        self._step = step
        self._staged = False
        self._closed = False
        self._dead: Dict[Tuple[int, int], DeadShard] = {}
        # The per-pool score plane: pool -> [(shard_ids, (S, B) device
        # score matrix)] per stacked launch of the latest tick, plus
        # its lazily-read host copy (one transfer per pool per tick,
        # shared by every scores()/top_anomalies() read).
        self._pool_scores_dev: Dict[int, list] = {}
        self._pool_scores_host: Dict[int, Dict[int, np.ndarray]] = {}
        self._last_poll_launches = 0
        self._last_save_pause_s = 0.0

    # -- construction -----------------------------------------------------
    @staticmethod
    def _seed_graph() -> DenseGraph:
        """The free-slot placeholder every stream opens with: one
        inactive node, zero weight — all statistics exactly zero."""
        return DenseGraph.from_weights(
            np.zeros((1, 1), np.float32),
            node_mask=np.zeros((1,), np.float32))

    @classmethod
    def open(cls, config: FleetConfig,
             device: Device = None) -> "FingerFleet":
        """Validate the config and open every pool's shards, all free,
        on ``device`` (``None`` is CUDA)."""
        config.validate()
        device = resolve_device(device)
        shards: List[List[Optional[FingerService]]] = []
        for pool in config.pools:
            row: List[Optional[FingerService]] = []
            for i in range(pool.shards):
                scfg = pool.service_config(
                    config.directory, i,
                    compilation_cache_dir=config.compilation_cache_dir)
                row.append(FingerService.open(
                    scfg, [cls._seed_graph()] * pool.streams_per_shard,
                    device=device))
            shards.append(row)
        return cls(config, shards, TenantDirectory(), device)

    # -- introspection ----------------------------------------------------
    @property
    def config(self) -> FleetConfig:
        return self._config

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def step(self) -> int:
        return self._step

    @property
    def directory(self) -> TenantDirectory:
        return self._directory

    @property
    def router(self) -> FleetRouter:
        return self._router

    @property
    def rebalancer(self) -> Rebalancer:
        return self._rebalancer

    def shard_service(self, pool_i: int, shard_i: int) -> FingerService:
        pools = self._config.pools
        if not (0 <= pool_i < len(pools)
                and 0 <= shard_i < pools[pool_i].shards):
            raise ShardUnavailableError(
                f"no shard ({pool_i}, {shard_i}) in this fleet")
        svc = self._shards[pool_i][shard_i]
        if svc is None:
            raise ShardUnavailableError(
                f"shard ({self._config.pools[pool_i].name!r}, "
                f"{shard_i}) is dead (killed and not reopened)")
        return svc

    def live_shard_ids(self) -> List[Tuple[int, int]]:
        return [(p, s)
                for p in range(len(self._config.pools))
                for s in range(self._config.pools[p].shards)
                if self._shards[p][s] is not None]

    def live_shards(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for p, s in self.live_shard_ids():
            out.setdefault(p, []).append(s)
        return out

    def _is_dead(self, pool_i: int, shard_i: int) -> bool:
        return self._shards[pool_i][shard_i] is None

    def _check_open(self, what: str) -> None:
        if self._closed:
            raise FleetLifecycleError(f"{what} on a closed FingerFleet")

    def _require_unstaged(self, what: str) -> None:
        if self._staged:
            raise FleetLifecycleError(
                f"{what} with a staged tick pending; poll() it first")

    # -- admission --------------------------------------------------------
    def admit(self, name: str, graph) -> TenantEntry:
        """Admit a tenant with its current host graph (tenant node space
        = the graph's). Best-fit bucket, least-loaded shard; the stream
        row is installed live (`install_stream`)."""
        self._check_open("admit")
        self._require_unstaged("admit")
        if name in self._directory:
            raise AdmissionError(f"tenant {name!r} already admitted")
        n_t = int(graph.n_nodes)
        pool_i, shard_i, slot = self._router.place(
            n_t, self.live_shards())
        pool = self._config.pools[pool_i]
        svc = self.shard_service(pool_i, shard_i)
        # The same O(n + m) pass `StreamEngine.init_states` runs on the
        # unpadded graph, so a fleet tenant's starting state equals a
        # single service's opened on the same graph (zero-padding into
        # the shard layout commutes with every FINGER statistic).
        st = finger_state(graph)
        base = {
            "q": float(st.q), "s_total": float(st.s_total),
            "s_max": float(st.s_max),
            "strengths": st.strengths.cpu().numpy().astype(
                np.float32, copy=True),
            "node_mask":
                np.ones((n_t,), np.float32) if st.node_mask is None
                else st.node_mask.cpu().numpy().astype(np.float32,
                                                       copy=True),
        }
        if pool.method == "sparse_tick":
            try:
                row, slot_map = sparse_state_from_graph(
                    graph, svc.capacity, n_virtual=svc.config.n_pad,
                    stream=slot)
            except SparseCapacityError as e:
                raise AdmissionError(
                    f"tenant {name!r}: {e}") from e
            svc.install_stream(slot, row, slot_map=slot_map)
            slot_of_node = None
        else:
            self._install_row(svc, slot, base)
            slot_of_node = np.arange(n_t, dtype=np.int32)
        entry = TenantEntry(
            name=name, pool=pool_i, shard=shard_i, slot=slot,
            n_nodes=n_t, slot_of_node=slot_of_node,
            base_step=self._step, base_state=base,
            installed_step=self._step, wal_floor=self._step)
        self._directory.add(entry)
        return entry

    def evict(self, name: str) -> None:
        """Remove a tenant and free its stream slot."""
        self._check_open("evict")
        self._require_unstaged("evict")
        entry = self._directory.get(name)
        if not self._is_dead(entry.pool, entry.shard):
            self.shard_service(entry.pool,
                               entry.shard).clear_stream(entry.slot)
        self._directory.remove(name)

    def install_dense(self, pool_i: int, shard_i: int, slot: int,
                      base: dict) -> None:
        """Install a tenant-space snapshot at identity positions into
        one dense stream row (shared by promotion and recovery);
        repads the shard back to its pool bound first if it was
        compacted below the tenant's size."""
        svc = self.shard_service(pool_i, shard_i)
        if int(base["strengths"].shape[0]) > svc.layout.n_pad:
            svc.repad(self._config.pools[pool_i].n_pad)
        self._install_row(svc, slot, base)

    @staticmethod
    def _install_row(svc: FingerService, slot: int, base: dict) -> None:
        n_t = int(base["strengths"].shape[0])
        n_pad = svc.layout.n_pad
        strengths = torch.zeros((n_pad,), dtype=torch.float32)
        strengths[:n_t] = torch.as_tensor(base["strengths"])
        mask = torch.zeros((n_pad,), dtype=torch.float32)
        mask[:n_t] = torch.as_tensor(base["node_mask"])

        def scalar(key):
            return torch.tensor(base[key], dtype=torch.float32)

        row = FingerState(
            q=scalar("q"), s_total=scalar("s_total"),
            s_max=scalar("s_max"), strengths=strengths, node_mask=mask,
            layout=svc.states().layout)
        svc.install_stream(slot, row)

    # -- the serving loop -------------------------------------------------
    def ingest(self, deltas: Dict[str, GraphDelta]) -> None:
        """Stage one fleet tick: tenant-space host deltas keyed by
        tenant name (absent tenants tick an empty delta). Runs the
        capacity pre-pass (repad / promotion) first, translates every
        delta, appends them to their tenants' WALs once every
        translation succeeded, then hands each shard its stacked delta.
        Deltas for tenants on a dead shard are WAL-only — they replay
        at `recover`."""
        self._check_open("ingest")
        self._require_unstaged("ingest")
        for name in deltas:
            self._directory.get(name)  # fail fast, by name
        for name, d in deltas.items():
            entry = self._directory.get(name)
            if self._is_dead(entry.pool, entry.shard):
                continue
            self._rebalancer.ensure_capacity(name, d)
        step_next = self._step + 1
        # Translation: dense tenants stage their rows straight into
        # their shard's preallocated (B, k_pad) buffers (one stacked
        # GraphDelta per shard, no per-tenant allocation); sparse
        # tenants keep the per-tenant path — their SlotMap translation
        # is stateful inside the service.
        stages: Dict[Tuple[int, int], object] = {}
        sparse_slots: Dict[Tuple[int, int], Dict[int, GraphDelta]] = {}
        wal_pending: List[Tuple[TenantEntry, GraphDelta]] = []
        for name, d in deltas.items():
            entry = self._directory.get(name)
            wal_pending.append((entry, d))
            if self._is_dead(entry.pool, entry.shard):
                continue
            svc = self.shard_service(entry.pool, entry.shard)
            pool = self._config.pools[entry.pool]
            key = (entry.pool, entry.shard)
            if pool.method == "sparse_tick":
                t = self._router.translate(entry, d, svc, pool)
                sparse_slots.setdefault(key, {})[entry.slot] = t
            else:
                stage = stages.get(key)
                if stage is None:
                    stage = self._router.stage_for(key, pool)
                    stages[key] = stage
                self._router.stage_dense(entry, d, svc, pool, stage)
        # WAL: one buffered commit per tick, after every translation
        # succeeded — a rejected tick leaves no partial WAL — with the
        # retention policy applied in the same pass.
        retention = self._config.wal_retention_ticks
        for entry, d in wal_pending:
            entry.wal.append((step_next, d))
            if retention is not None:
                cutoff = step_next - retention
                if entry.wal[0][0] <= cutoff:
                    pruned_to = max(s for s, _ in entry.wal
                                    if s <= cutoff)
                    entry.wal = [w for w in entry.wal
                                 if w[0] > cutoff]
                    entry.wal_floor = max(entry.wal_floor, pruned_to)
        for pool_i, shard_i in self.live_shard_ids():
            pool = self._config.pools[pool_i]
            svc = self.shard_service(pool_i, shard_i)
            key = (pool_i, shard_i)
            if pool.method == "sparse_tick":
                slots = sparse_slots.get(key, {})
                empty = self._router.empty_delta(pool, svc)
                svc.ingest([slots.get(s, empty)
                            for s in range(pool.streams_per_shard)])
            else:
                stage = stages.get(key)
                if stage is None:  # no tenant delta: all-zero rows
                    stage = self._router.stage_for(key, pool)
                svc.ingest(stage.finish(svc))
        self._staged = True

    def poll(self) -> int:
        """Advance the whole fleet one tick (all live shards — shard
        step stays == fleet step). Ticks an all-empty delta when
        nothing was staged. Returns the new fleet step.

        With ``config.stacked_ticks`` each pool's live shards advance
        as ONE stacked launch per layout group (`fleet.pooltick`),
        leaving the (S, B) score matrix on the device as the tick's
        score plane. A group that fails `pooltick.group_fits` ticks
        shard by shard with each shard's `poll()`. A due periodic save
        runs AFTER every pool's tick has been launched, and its pause
        is recorded in `last_save_pause_s`.
        """
        self._check_open("poll")
        if not self._staged:
            self.ingest({})
        self._pool_scores_dev = {}
        self._pool_scores_host = {}
        launches = 0
        live = self.live_shards()
        for pool_i in sorted(live):
            pool = self._config.pools[pool_i]
            if not (self._config.stacked_ticks
                    and pooltick.stackable(pool.method)):
                for shard_i in live[pool_i]:
                    self.shard_service(pool_i, shard_i).poll()
                    launches += 1
                continue
            # Group live shards by live layout: shards of one pool
            # share a config, but a compacted shard has a private
            # (smaller, regenerated) layout and ticks in its own
            # group; sparse shards additionally key on their live
            # SparseLayout capacity (grow_capacity re-keys a shard).
            groups: Dict[tuple, list] = {}
            for shard_i in live[pool_i]:
                svc = self.shard_service(pool_i, shard_i)
                gkey = (svc.layout.n_pad, svc.layout.generation,
                        svc.capacity)
                groups.setdefault(gkey, []).append((shard_i, svc))
            planes = []
            for members in groups.values():
                group = [svc for _, svc in members]
                if not pooltick.group_fits(
                        [svc.config for svc in group],
                        device=self._device):
                    for svc in group:
                        svc.poll()
                        launches += 1
                    continue
                dists = pooltick.tick_pool(group)
                launches += 1
                planes.append(([s for s, _ in members], dists))
            self._pool_scores_dev[pool_i] = planes
        self._step += 1
        self._staged = False
        self._last_poll_launches = launches
        self._last_save_pause_s = 0.0
        every = self._config.save_every_ticks
        if every is not None and self._step % every == 0:
            t0 = time.perf_counter()
            self.save()
            self._last_save_pause_s = time.perf_counter() - t0
        return self._step

    @property
    def last_poll_launches(self) -> int:
        """Tick launches the latest `poll()` made — one per pool layout
        group when stacked, one per shard otherwise."""
        return self._last_poll_launches

    @property
    def last_save_pause_s(self) -> float:
        """Wall-clock seconds the latest `poll()` spent in its
        periodic whole-fleet save (0.0 when none was due)."""
        return self._last_save_pause_s

    # -- queries ----------------------------------------------------------
    def _host_score_row(self, pool_i: int,
                        shard_i: int) -> Optional[np.ndarray]:
        """One shard's (B,) host score row out of the tick's score
        plane — read lazily with ONE device→host transfer per pool per
        tick (its layout groups' (S, B) matrices joined on the device
        first), then indexed for free by every per-tenant read and
        top-k merge. None when the shard ticked outside the plane (shard
        by shard, the residency fallback, before the first tick)."""
        rows = self._pool_scores_host.get(pool_i)
        if rows is None:
            planes = self._pool_scores_dev.get(pool_i)
            if planes is None:
                return None
            if not planes:  # every group ticked shard by shard
                rows = {}
            else:
                mats = [mat for _, mat in planes]
                joined = mats[0] if len(mats) == 1 else torch.cat(mats)
                host = joined.cpu().numpy()  # the pool's one transfer
                ids = [s for shard_ids, _ in planes for s in shard_ids]
                rows = dict(zip(ids, host))
            self._pool_scores_host[pool_i] = rows
        return rows.get(shard_i)

    def scores(self, names: Optional[List[str]] = None
               ) -> Dict[str, float]:
        """Latest per-tenant JSdist scores. Stacked-tick pools read the
        host copy of the score plane (at most one device→host transfer
        per pool per tick, shared by every tenant); other
        shards read one slot each (`score_at`). Tenants stranded on a
        dead shard — or (re)installed since the shard last ticked —
        report their last known score."""
        self._check_open("scores")
        out: Dict[str, float] = {}
        for name in (self._directory.names() if names is None
                     else names):
            entry = self._directory.get(name)
            if (self._is_dead(entry.pool, entry.shard)
                    or entry.installed_step >= self._step):
                # dead shard, or row (re)installed since the shard
                # last ticked: the slot's device score is stale
                out[name] = entry.last_score
                continue
            row = self._host_score_row(entry.pool, entry.shard)
            if row is not None:
                entry.last_score = float(row[entry.slot])
            else:
                svc = self.shard_service(entry.pool, entry.shard)
                v = svc.score_at(entry.slot)
                if v is not None:
                    entry.last_score = float(v)
            out[name] = entry.last_score
        return out

    def top_anomalies(self, k: int = 8) -> List[Tuple[str, float]]:
        """The k highest-scoring tenants of the latest tick: per-shard
        candidate rows (k capped at each shard's stream count), mapped
        slot→tenant, merged and cut to k. Shards on the score plane
        take their candidates from its host copy; others run the
        service's `top_anomalies` — full score vectors never leave
        their shard either way. Ties go to the lower slot, as in the
        service's top-k."""
        self._check_open("top_anomalies")
        cands: List[Tuple[float, str]] = []
        for pool_i, shard_i in self.live_shard_ids():
            pool = self._config.pools[pool_i]
            kk = min(k, pool.streams_per_shard)
            row = self._host_score_row(pool_i, shard_i)
            if row is not None:
                # A stable sort on the negated row keeps the lowest
                # slot first among equal scores.
                slots = np.argsort(-row, kind="stable")[:kk]
                vals = row[slots]
            else:
                svc = self.shard_service(pool_i, shard_i)
                try:
                    vals, slots = svc.top_anomalies(k=kk)
                except ServiceLifecycleError:
                    continue  # shard has not ticked yet
            for v, s in zip(np.ravel(vals), np.ravel(slots)):
                entry = self._directory.tenant_at(pool_i, shard_i,
                                                  int(s))
                if entry is not None:
                    cands.append((float(v), entry.name))
        cands.sort(key=lambda t: -t[0])
        return [(name, v) for v, name in cands[:k]]

    # -- rebalancing ------------------------------------------------------
    def promote(self, name: str,
                to_pool: Optional[str] = None) -> dict:
        """Move a tenant to a bigger bucket, live (checkpoint-through
        row migration; see `Rebalancer.promote`)."""
        self._check_open("promote")
        self._require_unstaged("promote")
        return self._rebalancer.promote(name, to_pool=to_pool)

    def rebalance(self) -> List[dict]:
        """One occupancy-driven upkeep sweep (auto-compaction). Legal
        with a staged tick: queued deltas are remapped through the
        serving grace machinery."""
        self._check_open("rebalance")
        return self._rebalancer.auto_rebalance()

    def warm(self, background: bool = False
             ) -> Union[list, WarmupHandle]:
        """Warm the whole steady-state rebalance surface (see
        `Rebalancer.warm`)."""
        self._check_open("warm")
        return self._rebalancer.warm(background=background)

    # -- failure + recovery -----------------------------------------------
    def kill_shard(self, pool_name: str, shard_i: int) -> DeadShard:
        """Take one shard out of service (simulated failure: its
        device state is dropped). Its tenants keep accumulating WAL
        until `recover` rebuilds them on survivors."""
        self._check_open("kill_shard")
        self._require_unstaged("kill_shard")
        pool_i = self._config.pool_index(pool_name)
        svc = self.shard_service(pool_i, shard_i)
        dead = DeadShard(
            pool=pool_i, shard=shard_i, layout=svc.layout,
            step=self._step,
            ckpt_dir=svc.config.checkpoint.directory,
            method=svc.config.method)
        svc.close()
        self._shards[pool_i][shard_i] = None
        self._dead[(pool_i, shard_i)] = dead
        return dead

    def recover(self) -> List[dict]:
        """Rebuild every dead shard's tenants on surviving shards (see
        `repro_torch.fleet.recovery`). The dead slots stay out of
        rotation; returns one report per recovered tenant."""
        self._check_open("recover")
        self._require_unstaged("recover")
        reports = []
        for key in sorted(self._dead):
            reports.extend(recover_shard(self, self._dead[key]))
        self._dead.clear()
        return reports

    # -- persistence ------------------------------------------------------
    def save(self) -> str:
        """Checkpoint the whole fleet: every shard's serving
        checkpoint plus the ``fleet.json`` manifest (step, per-shard
        layouts, tenant directory). After a save, tenants' in-memory
        recovery bases are truncated — recovery past this point goes
        through the on-disk checkpoints. Returns the manifest path."""
        self._check_open("save")
        self._require_unstaged("save")
        if self._config.directory is None:
            raise FleetConfigError(
                "save: FleetConfig.directory is None — declare a "
                "fleet directory to persist")
        if self._dead:
            raise FleetLifecycleError(
                f"save with dead shard(s) {sorted(self._dead)}; "
                "recover() first so the manifest captures a "
                "fully-live fleet")
        pools_manifest: Dict[str, list] = {}
        for pool_i, pool in enumerate(self._config.pools):
            recs = []
            for shard_i in range(pool.shards):
                svc = self.shard_service(pool_i, shard_i)
                svc.save()
                rec = {"n_pad": svc.layout.n_pad,
                       "generation": svc.layout.generation}
                if svc.capacity is not None:
                    # Sparse shards: live slot capacities can outgrow
                    # the PoolSpec values (grow_capacity), so the
                    # manifest records them per shard.
                    rec["n_slots"] = int(svc.capacity.n_slots)
                    rec["m_pad"] = int(svc.capacity.m_pad)
                recs.append(rec)
            pools_manifest[pool.name] = recs
        # Truncate recovery material first so the manifest records the
        # post-save base steps.
        for entry in self._directory:
            entry.base_step = self._step
            entry.base_state = None
            entry.wal = [w for w in entry.wal if w[0] > self._step]
            # Everything at/under the new durable base is covered by
            # the on-disk checkpoints — pruning it never gaps recovery.
            entry.wal_floor = max(entry.wal_floor, self._step)
        manifest = {"step": self._step, "pools": pools_manifest,
                    "tenants": self._directory.to_json()}
        os.makedirs(self._config.directory, exist_ok=True)
        path = os.path.join(self._config.directory, _MANIFEST)
        fd, tmp = tempfile.mkstemp(dir=self._config.directory,
                                   suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f, indent=1)
        os.replace(tmp, path)
        return path

    @classmethod
    def restore(cls, config: FleetConfig,
                device: Device = None) -> "FingerFleet":
        """Resume a whole fleet from its directory (written by either
        package) on ``device`` (``None`` is CUDA): each shard through
        `FingerService.restore` (layout-journal aware), the tenant
        directory from the manifest."""
        config.validate()
        device = resolve_device(device)
        if config.directory is None:
            raise FleetConfigError(
                "restore: FleetConfig.directory is None")
        path = os.path.join(config.directory, _MANIFEST)
        if not os.path.exists(path):
            raise FleetConfigError(
                f"restore: no fleet manifest at {path!r}")
        with open(path) as f:
            manifest = json.load(f)
        step = int(manifest["step"])
        shards: List[List[Optional[FingerService]]] = []
        for pool in config.pools:
            recs = manifest["pools"].get(pool.name)
            if recs is None or len(recs) != pool.shards:
                raise FleetConfigError(
                    f"restore: manifest pool {pool.name!r} has "
                    f"{None if recs is None else len(recs)} shard "
                    f"record(s), config declares {pool.shards}")
            row: List[Optional[FingerService]] = []
            for shard_i, rec in enumerate(recs):
                scfg = pool.service_config(
                    config.directory, shard_i,
                    compilation_cache_dir=config.compilation_cache_dir
                ).with_(n_pad=int(rec["n_pad"]))
                if "n_slots" in rec:
                    scfg = scfg.with_(n_slots=int(rec["n_slots"]),
                                      m_pad=int(rec["m_pad"]))
                row.append(FingerService.restore(scfg, device=device))
            shards.append(row)
        directory = TenantDirectory.from_json(manifest["tenants"])
        return cls(config, shards, directory, device, step=step)

    # -- teardown ---------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        for pool_i, shard_i in self.live_shard_ids():
            self._shards[pool_i][shard_i].close()
        self._closed = True

    def __enter__(self) -> "FingerFleet":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
