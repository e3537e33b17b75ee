"""The warm-path sentinel scenarios: migration chains at zero first uses.

The port's counterpart of `repro.analysis.sentinel`, with the same
configs, graphs, seeds and report keys. Where the reference proves that
a warmed serving path compiles nothing (``compile_budget(0)``), the port
proves that it pays no first-use cost (`sanitize.first_use_budget(0)`):
no cold `build_plan`, no kernel-library load and, on the card, no new
segment of the caching allocator — everything `warm_next_layouts` and
`FingerFleet.warm` pay ahead of time in serving idle time.

- `run_migration_chain` drives a small local `FingerService` through
  mixed-n ticks, a warm `repad` grow, more ticks, a warm `compact`
  shrink and more ticks (two migration generations), and returns the
  final scores beside the per-phase counts.
- `run_sparse_chain` is the slot-space counterpart: a
  ``method="sparse_tick"`` service over a 2²⁰-id virtual space runs
  ingest (SlotMap translation) → a free virtual `repad` → a warm
  `grow_capacity` with a tick queued across it → more ticks.
- `run_fleet_chain` lifts the proof to the fleet: 4 pools × 2 shards
  covering every tick method serve tenant ticks, a cross-pool promotion
  and an occupancy-driven compaction under a staged tick. Each budgeted
  tick also pins the hot-path contract: `poll()` makes one stacked
  launch a pool layout group (``fleet.last_poll_launches``), `ingest()`
  and the poll dispatch pull nothing to the host, and `scores()` pulls
  at most one score plane a pool (`sanitize.transfer_budget`).
- `run_scaled_chain` is the migration chain on the card at
  ``chip_smoke.py``'s phase-3 shape (B = 32768, ``fused_tick``, k_pad
  128, j_pad 8) with n_pad 1024 → 2048 → 1024, where the allocator check
  bears load.

Run them with ``python -m repro_torch.analysis sentinel``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.analysis.sanitize import first_use_budget, transfer_budget
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.types import EdgeList, GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

_B, _N_PAD, _K_PAD = 4, 16, 3
_GROW_N_PAD = 32
# sparse chain: a deliberately huge virtual space over tiny capacities
_S_VIRTUAL, _S_SLOTS, _S_MPAD = 1 << 20, 16, 32
# the scaled chain: chip_smoke.py's phase-3 shape
SCALED = dict(batch_size=32768, n_pad=1024, grow_n_pad=2048, k_pad=128,
              j_pad=8, active_lanes=4, templates=16)


def _graphs():
    # mixed logical sizes in one padded batch
    return [erdos_renyi(8 + 2 * (s % 3), 0.3, seed=s, weighted=True)
            for s in range(_B)]


def _tick_deltas(graphs, n_pad: int, seed: int) -> List[GraphDelta]:
    rng = np.random.default_rng(seed)
    out = []
    for g in graphs:
        n = g.n_nodes
        # a numpy draw: nothing on the device
        i, j = sorted(rng.choice(n, 2, replace=False).tolist())  # lint: disable=per-item-host-sync
        # test-fixture setup, not a serving hot path
        w_old = float(np.asarray(g.weights)[i, j])  # lint: disable=per-item-host-sync
        out.append(GraphDelta.from_arrays(
            [i], [j], [0.5 if w_old == 0 else -w_old], [w_old],
            n_nodes=n, n_pad=n_pad, k_pad=_K_PAD))
    return out


def _run_ticks(svc: FingerService, graphs, n_pad: int, seeds) -> None:
    for seed in seeds:
        svc.ingest(_tick_deltas(graphs, n_pad, seed))
        report = svc.poll()
        assert report is not None


def run_migration_chain(ticks_per_phase: int = 3,
                        device: dispatch.Device = None) -> Dict[str, Any]:
    """Run the chain; raises `FirstUseBudgetExceeded` on any first use in
    a serving phase. Returns a report of per-phase counts and the final
    (B,) scores."""
    dev = dispatch.resolve_device(device)
    config = ServiceConfig(batch_size=_B, n_pad=_N_PAD, k_pad=_K_PAD,
                           placement="local", ingestion="sync",
                           topk=TopKSpec(k=2))
    graphs = _graphs()
    phases: Dict[str, int] = {}

    with FingerService.open(config, graphs, device=dev) as svc:
        # Warm-up: the first tick loads the kernels and gives the
        # allocator its blocks; then the generation-1 plan and the grow.
        _run_ticks(svc, graphs, _N_PAD, seeds=[0])
        svc.warm_next_layouts([_GROW_N_PAD])

        with first_use_budget(0, "mixed-n ticks + warm repad "
                                 "(gen 0 -> 1)", device=dev) as c1:
            _run_ticks(svc, graphs, _N_PAD,
                       seeds=range(1, 1 + ticks_per_phase))
            svc.repad(_GROW_N_PAD)
            _run_ticks(svc, graphs, _GROW_N_PAD,
                       seeds=range(10, 10 + ticks_per_phase))
        phases["ticks_repad_gen0_to_1"] = c1.count

        # Idle-time warming again: the default call warms the growth
        # prediction and the live-count compaction target, the explicit
        # call the actual compact target's plan and transform.
        svc.warm_next_layouts()
        svc.warm_next_layouts([_N_PAD])

        with first_use_budget(0, "mixed-n ticks + warm compact "
                                 "(gen 1 -> 2)", device=dev) as c2:
            _run_ticks(svc, graphs, _GROW_N_PAD,
                       seeds=range(20, 20 + ticks_per_phase))
            svc.compact(_N_PAD)
            _run_ticks(svc, graphs, _N_PAD,
                       seeds=range(30, 30 + ticks_per_phase))
        phases["ticks_compact_gen1_to_2"] = c2.count

        scores = svc.scores()
        assert scores is not None and scores.shape == (_B,)

    return {
        "ok": True,
        "budget_per_phase": 0,
        "phases": phases,
        "ticks_per_phase": ticks_per_phase,
        "generations": 2,
        "scores": [float(s) for s in scores],
    }


def run_sparse_chain(ticks_per_phase: int = 3,
                     device: dispatch.Device = None) -> Dict[str, Any]:
    """The sparse ingest → virtual repad → warm grow_capacity → tick
    chain at zero first uses. Returns a report of per-phase counts;
    raises `FirstUseBudgetExceeded` on any serving-path first use."""
    dev = dispatch.resolve_device(device)
    config = ServiceConfig(batch_size=_B, n_pad=_S_VIRTUAL,
                           k_pad=_K_PAD, method="sparse_tick",
                           n_slots=_S_SLOTS, m_pad=_S_MPAD,
                           placement="local", ingestion="sync",
                           topk=TopKSpec(k=2))
    graphs = _graphs()
    phases: Dict[str, int] = {}

    with FingerService.open(config, graphs, device=dev) as svc:
        # Warm-up tick + idle-time warming of the predicted doubled
        # capacity (plan + grow transform).
        _run_ticks(svc, graphs, _S_VIRTUAL, seeds=[0])
        svc.warm_next_layouts([(2 * _S_SLOTS, 2 * _S_MPAD)])

        with first_use_budget(0, "sparse ingest -> virtual repad -> "
                                 "warm grow_capacity -> ticks",
                              device=dev) as c1:
            _run_ticks(svc, graphs, _S_VIRTUAL,
                       seeds=range(1, 1 + ticks_per_phase))
            # A virtual repad is a host-side bound bump: no device
            # tensor or plan depends on n_pad, so it uses nothing new.
            svc.repad(2 * _S_VIRTUAL)
            _run_ticks(svc, graphs, 2 * _S_VIRTUAL,
                       seeds=range(10, 10 + ticks_per_phase))
            # One tick queued ACROSS the capacity migration: re-embedded
            # by a size change, then served by the pre-warmed plan.
            svc.ingest(_tick_deltas(graphs, 2 * _S_VIRTUAL, seed=99))
            svc.grow_capacity(n_slots=2 * _S_SLOTS, m_pad=2 * _S_MPAD)
            assert svc.poll() is not None
            _run_ticks(svc, graphs, 2 * _S_VIRTUAL,
                       seeds=range(20, 20 + ticks_per_phase))
        phases["sparse_ingest_repad_grow"] = c1.count

        scores = svc.scores()
        assert scores is not None and scores.shape == (_B,)

    return {
        "ok": True,
        "budget_per_phase": 0,
        "phases": phases,
        "ticks_per_phase": ticks_per_phase,
        "capacity": [svc.capacity.n_slots, svc.capacity.m_pad],
        "virtual_n_pad": svc.layout.n_pad,
    }


def _fleet_tick(fleet, sizes, seed: int, budget: bool = False,
                expected_launches: int = None) -> None:
    rng = np.random.default_rng(seed)
    ds = {}
    for name, n in sizes.items():
        # a numpy draw: nothing on the device
        i, j = sorted(rng.choice(n, 2, replace=False).tolist())  # lint: disable=per-item-host-sync
        # host tensors: the fixtures spend none of the serving path's
        # transfer budget themselves
        ds[name] = GraphDelta.from_arrays(
            [i], [j], [rng.uniform(0.5, 2.0)], [0.0],
            n_nodes=n, k_pad=_K_PAD, j_pad=2)
    if not budget:
        fleet.ingest(ds)
        fleet.poll()
        scores = fleet.scores()
    else:
        with transfer_budget(0, "fleet.ingest"):
            fleet.ingest(ds)
        with transfer_budget(0, "fleet.poll dispatch"):
            fleet.poll()
        if expected_launches is not None:
            assert fleet.last_poll_launches == expected_launches, (
                f"poll dispatched {fleet.last_poll_launches} launches,"
                f" expected {expected_launches} (one per pool "
                "layout-group)")
        with transfer_budget(len(fleet.config.pools),
                             "fleet.scores score plane"):
            scores = fleet.scores()
    assert set(scores) == set(sizes)


def _expected_launches(fleet) -> int:
    """One launch per pool layout-group (stacked pools), one per shard
    otherwise — the dispatch count `poll()` must hit."""
    from repro_torch.fleet import pooltick

    total = 0
    live = fleet.live_shards()
    for pool_i, shard_ids in live.items():
        pool = fleet.config.pools[pool_i]
        if fleet.config.stacked_ticks and pooltick.stackable(pool.method):
            total += len({
                (fleet.shard_service(pool_i, s).layout.n_pad,
                 fleet.shard_service(pool_i, s).layout.generation)
                for s in shard_ids})
        else:
            total += len(shard_ids)
    return total


def run_fleet_chain(ticks_per_phase: int = 3,
                    device: dispatch.Device = None) -> Dict[str, Any]:
    """The fleet rebalance chain at zero serving-path first uses.

    4 pools × 2 shards covering every tick method — two dense pools, a
    ``fused_tick`` pool and a ``sparse_tick`` slot-space pool — each
    holding a live tenant, so the stacked-dispatch contract (`poll()`
    makes exactly ``len(pools)`` launches in steady state) is asserted
    against the real mixed-method fleet. After `FingerFleet.warm`, a
    phase of tenant ticks and a cross-pool promotion (into the fused
    pool) runs at zero first uses, and (after warming the now-current
    occupancies again) so does a phase with an occupancy-driven
    compaction under a staged tick. Raises `FirstUseBudgetExceeded` on
    any first use; returns per-phase counts.
    """
    from repro_torch.fleet import FingerFleet, FleetConfig, PoolSpec

    dev = dispatch.resolve_device(device)
    config = FleetConfig(pools=(
        PoolSpec(name="small", n_pad=8, shards=2, streams_per_shard=2,
                 k_pad=_K_PAD, j_pad=2),
        PoolSpec(name="mega", n_pad=16, shards=2, streams_per_shard=2,
                 k_pad=_K_PAD, j_pad=2, method="fused_tick"),
        PoolSpec(name="large", n_pad=24, shards=2,
                 streams_per_shard=2, k_pad=_K_PAD, j_pad=2),
        PoolSpec(name="slots", n_pad=1024, shards=2,
                 streams_per_shard=2, k_pad=_K_PAD, j_pad=2,
                 method="sparse_tick", n_slots=32, m_pad=256),
    ), compact_occupancy=0.95)
    sizes = {"a": 5, "b": 6, "m": 12, "c": 20, "s": 28}
    graphs = {n: erdos_renyi(sz, 0.4, seed=i, weighted=True)
              for i, (n, sz) in enumerate(sizes.items())}
    phases: Dict[str, int] = {}

    with FingerFleet.open(config, device=dev) as fleet:
        for name in sizes:
            fleet.admit(name, graphs[name])
        # Warm-up: the first tick uses every pool's plan and the query
        # readbacks; warm() then readies the whole rebalance surface.
        _fleet_tick(fleet, sizes, seed=0)
        top = fleet.top_anomalies(k=len(sizes))
        assert len(top) == len(sizes)
        fleet.warm()

        # Steady state: every pool is one layout group — the stacked
        # dispatch contract is exactly one launch per pool.
        assert _expected_launches(fleet) == len(config.pools)
        with first_use_budget(0, "fleet ticks + cross-bucket promotion",
                              device=dev) as c1:
            for seed in range(1, 1 + ticks_per_phase):
                _fleet_tick(fleet, sizes, seed, budget=True,
                            expected_launches=len(config.pools))
            fleet.promote("a")  # small -> mega, live row migration
            for seed in range(10, 10 + ticks_per_phase):
                _fleet_tick(fleet, sizes, seed, budget=True,
                            expected_launches=len(config.pools))
        phases["ticks_promotion"] = c1.count
        assert fleet.directory.get("a").pool == 1

        # Warm again for the *current* occupancies (the promotion changed
        # every shard's live count), then compact under a staged tick.
        fleet.warm()
        with first_use_budget(0, "fleet ticks + auto-compaction under a "
                                 "staged tick", device=dev) as c2:
            for seed in range(20, 20 + ticks_per_phase):
                _fleet_tick(fleet, sizes, seed, budget=True,
                            expected_launches=len(config.pools))
            fleet.ingest({})  # stage, then rebalance, then poll
            actions = fleet.rebalance()
            assert any(a["action"] == "compact" for a in actions)
            fleet.poll()
            # The compaction peeled shard(s) into layout groups of their
            # own: the dispatch count grows by exactly the new group
            # count, still below one a shard.
            post = _expected_launches(fleet)
            assert post > len(config.pools)
            assert fleet.last_poll_launches == post
            for seed in range(30, 30 + ticks_per_phase):
                _fleet_tick(fleet, sizes, seed, budget=True,
                            expected_launches=post)
        phases["ticks_staged_compaction"] = c2.count

    return {
        "ok": True,
        "budget_per_phase": 0,
        "phases": phases,
        "ticks_per_phase": ticks_per_phase,
        "pools": [p.name for p in config.pools],
        "methods": [p.method for p in config.pools],
        "compactions": len(actions),
        "launches_steady": len(config.pools),
        "launches_post_compaction": post,
        "transfer_budget_scores_per_tick": len(config.pools),
    }


def _scaled_service(config: ServiceConfig, device: torch.device,
                    templates: int, seed: int):
    """A service of ``config.batch_size`` streams over ``templates``
    edge-list graphs (n_pad/4 to n_pad nodes — 256 to 1024 at phase 3's
    n_pad, as there —, about 4n edges) repeated, and each
    stream's node count: the stacked state of the templates is made once
    and its rows repeated, which is what `FingerService.open` would
    build for the repeated graphs, without B graph embeddings on the
    host."""
    from repro_torch.engine.stream import StreamEngine
    from repro_torch.serving.plans import build_plan

    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(templates):
        n = int(rng.integers(config.n_pad // 4, config.n_pad + 1))
        lo = rng.integers(0, n, 4 * n)
        hi = (lo + rng.integers(1, n, 4 * n)) % n
        graphs.append(EdgeList.from_arrays(lo, hi,
                                           rng.uniform(0.5, 1.5, 4 * n),
                                           n_nodes=n))
    small = StreamEngine.init_states(graphs, n_pad=config.n_pad,
                                     device="cpu")
    rows = torch.arange(config.batch_size) % templates
    states = small.map_tensors(lambda t: t[rows].contiguous())
    plan = build_plan(config, device)
    nodes = np.array([g.n_nodes for g in graphs])[rows.numpy()]
    return FingerService(config, plan, plan.place(states)), nodes


def _scaled_tick(svc: FingerService, nodes: np.ndarray, n_pad: int,
                 lanes: int, seed: int) -> None:
    """One stacked tick: ``lanes`` new edges a stream among its
    ``nodes``."""
    c = svc.config
    rng = np.random.default_rng(seed)
    n = nodes[:, None]
    i = rng.integers(0, 1 << 30, (c.batch_size, c.k_pad)) % n
    j = (i + 1 + rng.integers(0, 1 << 30, (c.batch_size, c.k_pad))
         % (n - 1)) % n
    mask = np.zeros((c.batch_size, c.k_pad), np.float32)
    mask[:, :lanes] = 1.0

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype))

    zeros = np.zeros((c.batch_size, c.j_pad))
    svc.ingest(GraphDelta(
        senders=t(np.minimum(i, j), np.int32),
        receivers=t(np.maximum(i, j), np.int32),
        dw=t(0.5 * mask, np.float32), w_old=t(0.0 * mask, np.float32),
        mask=t(mask, np.float32), n_nodes=n_pad,
        node_ids=t(zeros, np.int32), node_flag=t(zeros, np.float32)))
    assert svc.poll() is not None


def run_scaled_chain(ticks_per_phase: int = 3,
                     device: dispatch.Device = None,
                     seed: int = 0, **shape) -> Dict[str, Any]:
    """The migration chain at ``SCALED`` (override any of its keys):
    ``fused_tick``, exact s_max, n_pad 1024 → repad 2048 → compact 1024,
    each phase at zero first uses after the warms."""
    s = dict(SCALED, **shape)
    dev = dispatch.resolve_device(device)
    config = ServiceConfig(batch_size=s["batch_size"], n_pad=s["n_pad"],
                           k_pad=s["k_pad"], j_pad=s["j_pad"],
                           method="fused_tick", exact_smax=True,
                           placement="local", ingestion="sync",
                           topk=TopKSpec(k=4))
    n0, n1, lanes = s["n_pad"], s["grow_n_pad"], s["active_lanes"]
    phases: Dict[str, int] = {}
    svc, nodes = _scaled_service(config, dev, s["templates"], seed)
    with svc:
        _scaled_tick(svc, nodes, n0, lanes, seed)
        svc.warm_next_layouts([n1])
        with first_use_budget(0, f"B={config.batch_size} ticks + warm "
                                 f"repad {n0} -> {n1}", device=dev) as c1:
            for t in range(ticks_per_phase):
                _scaled_tick(svc, nodes, n0, lanes, seed + 1 + t)
            svc.repad(n1)
            for t in range(ticks_per_phase):
                _scaled_tick(svc, nodes, n1, lanes, seed + 10 + t)
        phases["ticks_repad"] = c1.count
        svc.warm_next_layouts()
        svc.warm_next_layouts([n0])
        with first_use_budget(0, f"B={config.batch_size} ticks + warm "
                                 f"compact {n1} -> {n0}", device=dev) as c2:
            for t in range(ticks_per_phase):
                _scaled_tick(svc, nodes, n1, lanes, seed + 20 + t)
            svc.compact(n0)
            for t in range(ticks_per_phase):
                _scaled_tick(svc, nodes, n0, lanes, seed + 30 + t)
        phases["ticks_compact"] = c2.count
        scores = svc.scores()
        assert scores.shape == (config.batch_size,) \
            and np.isfinite(scores).all()
    return {"ok": True, "budget_per_phase": 0, "phases": phases,
            "ticks_per_phase": ticks_per_phase,
            "batch_size": config.batch_size, "n_pad": [n0, n1, n0]}
