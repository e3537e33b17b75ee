"""The port's fleet (`repro_torch.fleet`) against the JAX fleet, on the
CPU: config and its error texts, the exports, placements, the
randomized lifecycle of the reference's `TestFleetProperty`, the pool
tick's grouping and residency fallback, WAL retention and the launch
budget of a fleet tick.

The same numpy graphs and deltas go through `repro.fleet.FingerFleet`
(the reference) and `repro_torch.fleet.FingerFleet.open(config,
device="cpu")`. Scores: atol 1e-5 with rtol 1e-5, as divergences where
those are below 1e-3 (`_torch_fleet.assert_scores`). Placements,
layouts, WAL steps and launch counts: exactly.

`tests/test_fleet.py::TestFleetHotPathBudgets` is red in the reference
(jax 0.9.0 lost its sanitizer's monitoring API), so the launch budget
here is held to the port's own `last_poll_launches` and the reference
fleet's, not to that test.
"""
import pathlib
import re

import numpy as np
import pytest

import repro.fleet as jfleet
import repro.kernels.dispatch as jdispatch
import repro.kernels.sparse_tick.ops as jsp_ops
import repro.kernels.stream_tick.ops as jst_ops
import repro_torch.fleet as tfleet
from _torch_fleet import (J_PAD, K_PAD, Pair, assert_scores, delta, edge,
                          graph, grow, two_buckets, weights)
from repro.fleet import pooltick as jpooltick
from repro_torch.fleet import pooltick
from repro_torch.fleet import (AdmissionError, FingerFleet, FleetConfig,
                               FleetConfigError, FleetError,
                               FleetIngestError, FleetLifecycleError,
                               PoolGroupError, PoolSpec, RecoveryError,
                               ShardUnavailableError, UnknownTenantError)
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.serving import FingerService, ServiceConfig, TopKSpec
from repro_torch.serving.migrate import embed_delta


def _raised(fn):
    try:
        fn()
    except Exception as e:  # the test compares type and text
        return e
    raise AssertionError("no exception raised")


# -- config ----------------------------------------------------------------

BAD_CONFIGS = {
    "no pools": lambda m: m.FleetConfig(pools=()),
    "names": lambda m: m.FleetConfig(pools=(
        m.PoolSpec(name="s", n_pad=8, k_pad=2),) * 2),
    "ladder": lambda m: m.FleetConfig(pools=(
        m.PoolSpec(name="a", n_pad=8, k_pad=2),
        m.PoolSpec(name="b", n_pad=8, k_pad=2))),
    "shards": lambda m: m.FleetConfig(pools=(
        m.PoolSpec(name="a", n_pad=8, shards=0, k_pad=2),)),
    "empty name": lambda m: m.FleetConfig(pools=(
        m.PoolSpec(name=" ", n_pad=8, k_pad=2),)),
    "occupancy": lambda m: m.FleetConfig(
        pools=(m.PoolSpec(name="s", n_pad=8, k_pad=2),),
        compact_occupancy=0.0),
    "save every": lambda m: m.FleetConfig(
        pools=(m.PoolSpec(name="s", n_pad=8, k_pad=2),),
        save_every_ticks=5),
    "save every 0": lambda m: m.FleetConfig(
        pools=(m.PoolSpec(name="s", n_pad=8, k_pad=2),),
        save_every_ticks=0, directory="/never"),
    "retention": lambda m: m.FleetConfig(
        pools=(m.PoolSpec(name="s", n_pad=8, k_pad=2),),
        wal_retention_ticks=0),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_config_errors_match_the_reference_by_type_and_text(case):
    je = _raised(lambda: BAD_CONFIGS[case](jfleet).validate())
    te = _raised(lambda: BAD_CONFIGS[case](tfleet).validate())
    assert isinstance(je, jfleet.FleetConfigError)
    assert isinstance(te, FleetConfigError)
    assert str(te) == str(je)


def test_config_validation_named_errors():
    # a bad shard-level field fails through the serving layer's own
    # diagnostics, renamed to the fleet's config error and its pool
    with pytest.raises(FleetConfigError, match="'a'.*k_pad"):
        FleetConfig(pools=(PoolSpec(name="a", n_pad=8, k_pad=0),)).validate()
    with pytest.raises(FleetConfigError, match="n_slots"):
        FleetConfig(pools=(PoolSpec(name="sp", n_pad=64, k_pad=2,
                                    method="sparse_tick"),)).validate()
    # sparse pools persist too: a sparse + directory config is legal
    FleetConfig(pools=(
        PoolSpec(name="sp", n_pad=64, k_pad=2, j_pad=2,
                 method="sparse_tick", n_slots=8, m_pad=16),),
        directory="/tmp/never").validate()
    with pytest.raises(FleetConfigError, match="no pool named"):
        FleetConfig(pools=(PoolSpec(name="s", n_pad=8, k_pad=2),)
                    ).pool_index("nope")
    assert two_buckets(tfleet).pool_index("large") == 1
    spec = PoolSpec(name="p", n_pad=8, shards=3, streams_per_shard=4,
                    k_pad=2)
    assert spec.capacity == 12
    scfg = spec.service_config("/srv/fleet", 2)
    assert scfg.checkpoint.directory.endswith("/srv/fleet/p/shard2")
    assert (scfg.batch_size, scfg.placement, scfg.topk.k) == \
        (4, "local", 4)


def test_compilation_cache_dir_is_refused_by_name():
    cfg = FleetConfig(pools=(PoolSpec(name="s", n_pad=8, k_pad=2),),
                      compilation_cache_dir="/tmp/cache")
    with pytest.raises(FleetConfigError,
                       match="compilation_cache_dir.*not yet ported"):
        cfg.validate()
    with pytest.raises(FleetConfigError, match="compilation_cache_dir"):
        FingerFleet.open(cfg, device="cpu")
    # the reference accepts it (JAX's persistent compilation cache)
    jfleet.FleetConfig(pools=(jfleet.PoolSpec(name="s", n_pad=8, k_pad=2),),
                       compilation_cache_dir="/tmp/cache").validate()


# -- exports -----------------------------------------------------------------

def test_exports_and_error_tree_match_the_reference():
    assert tfleet.__all__ == jfleet.__all__
    root = pathlib.Path(list(tfleet.__path__)[0])
    modules = sorted(p.stem for p in root.glob("*.py"))
    jroot = pathlib.Path(list(jfleet.__path__)[0])
    assert modules == sorted(p.stem for p in jroot.glob("*.py"))
    found = set()
    for py in root.glob("*.py"):
        found |= set(re.findall(r"^class (\w*Error)\b", py.read_text(),
                                re.M))
    assert found
    for name in sorted(found):
        assert name in tfleet.__all__, f"{name} missing from __all__"
        exc = getattr(tfleet, name)
        assert issubclass(exc, FleetError), name
        assert [b.__name__ for b in exc.__mro__] == \
            [b.__name__ for b in getattr(jfleet, name).__mro__], name
    for name in ("stackable", "group_fits", "pool_tick_fn", "tick_pool",
                 "warm_pool_tick", "group_by_layout"):
        assert callable(getattr(pooltick, name)), name


# -- placement ---------------------------------------------------------------

def test_placements_equal_tenant_for_tenant():
    sizes = [5, 7, 20, 3, 8, 30, 6, 12, 2, 32]
    pair = Pair(lambda m: two_buckets(m))
    try:
        for i, n in enumerate(sizes[:8]):
            pair.admit(f"t{i}", weights(n, i + 1))
        # both buckets full: admission control by name in both packages
        je = _raised(lambda: pair.j.admit("x", graph(jfleet, weights(3, 9))))
        te = _raised(lambda: pair.t.admit("x", graph(tfleet, weights(3, 9))))
        assert isinstance(je, jfleet.AdmissionError)
        assert isinstance(te, AdmissionError) and str(te) == str(je)
        # evicting frees the smallest slot, and the next admission takes
        # it on the least-loaded shard
        pair.both(lambda f, m: f.evict("t1"))
        pair.both(lambda f, m: f.evict("t5"))
        pair.admit("t8", weights(sizes[8], 9))
        pair.admit("t9", weights(sizes[9], 10))
        pair.check_placements("after evictions")
        for p in range(2):
            for s in range(2):
                assert pair.t.directory.slots_in_use(p, s) == \
                    pair.j.directory.slots_in_use(p, s)
                assert [e.name for e in pair.t.directory.tenants_on(p, s)] \
                    == [e.name for e in pair.j.directory.tenants_on(p, s)]
    finally:
        pair.close()


def test_named_admission_and_lifecycle_errors():
    cfg = FleetConfig(pools=(
        PoolSpec(name="tiny", n_pad=8, shards=1, streams_per_shard=2,
                 k_pad=K_PAD, j_pad=J_PAD),))
    with FingerFleet.open(cfg, device="cpu") as fleet:
        fleet.admit("a", graph(tfleet, weights(4, 1)))
        with pytest.raises(AdmissionError, match="already"):
            fleet.admit("a", graph(tfleet, weights(4, 1)))
        with pytest.raises(AdmissionError, match="node slot"):
            fleet.admit("big", graph(tfleet, weights(9, 2)))
        fleet.admit("b", graph(tfleet, weights(4, 3)))
        with pytest.raises(AdmissionError):
            fleet.admit("c", graph(tfleet, weights(4, 4)))
        with pytest.raises(UnknownTenantError, match="ghost"):
            fleet.ingest({"ghost": delta(tfleet, edge(4, 5))})
        with pytest.raises(FleetIngestError, match="never joined"):
            fleet.ingest({"a": GraphDelta.from_arrays(
                [0], [6], [1.0], [0.0], n_nodes=7, k_pad=K_PAD,
                j_pad=J_PAD)})
        with pytest.raises(ShardUnavailableError):
            fleet.shard_service(0, 5)
        fleet.ingest({"a": delta(tfleet, edge(4, 6))})
        with pytest.raises(FleetLifecycleError, match="staged"):
            fleet.ingest({"a": delta(tfleet, edge(4, 7))})
        with pytest.raises(FleetLifecycleError, match="staged"):
            fleet.promote("a")
        fleet.poll()
        with pytest.raises(AdmissionError):
            fleet.promote("a")  # no bigger bucket exists
    with pytest.raises(FleetLifecycleError, match="closed"):
        fleet.scores()


# -- the randomized lifecycle ------------------------------------------------

class PortOracle:
    """A single port `FingerService` fed every tenant's deltas, embedded
    into one shared layout — the port's fleet must match it whatever it
    does with tenants underneath (the reference's `Oracle`)."""

    def __init__(self, names, ws, n_pad=32):
        self.names, self.n_pad = list(names), n_pad
        self.svc = FingerService.open(
            ServiceConfig(batch_size=len(self.names), n_pad=n_pad,
                          k_pad=K_PAD, j_pad=J_PAD,
                          topk=TopKSpec(k=len(self.names))),
            [graph(tfleet, ws[n]) for n in self.names], device="cpu")
        z = np.zeros((0,), np.float32)
        self.empty = GraphDelta.from_arrays(z, z, z, z, n_nodes=0,
                                            n_pad=n_pad, k_pad=K_PAD,
                                            j_pad=J_PAD)

    def tick(self, spec):
        self.svc.ingest([embed_delta(delta(tfleet, spec[n]), self.n_pad)
                         if n in spec else self.empty for n in self.names])
        self.svc.poll()
        vals = self.svc.scores()
        return {n: float(vals[i]) for i, n in enumerate(self.names)}


def _dead_holds(fleet, name):
    e = fleet.directory.get(name)
    return fleet._is_dead(e.pool, e.shard)


def test_randomized_lifecycle_matches_jax_fleet_and_oracle():
    """The reference's `TestFleetProperty`: 12 random ticks over 2
    buckets × 2 shards in which a tenant is promoted across buckets by
    its own growth, a shard compacts under a staged tick, a shard is
    killed, ticks WAL-only and is recovered onto a survivor."""
    names = ["a", "b", "c"]
    sizes = {"a": 5, "b": 6, "c": 18}
    ws = {n: weights(sizes[n], i + 61) for i, n in enumerate(names)}
    pair = Pair(lambda m: two_buckets(m, compact_occupancy=0.95))
    oracle = PortOracle(names, ws)
    rng = np.random.default_rng(7)
    try:
        for n in names:
            pair.admit(n, ws[n])
        jw, tw = pair.both(lambda f, m: f.warm(background=True))
        assert tw.wait(timeout=600) == jw.wait(timeout=600)
        for step in range(12):
            spec = {}
            for n in names:
                if n == "a" and step in (2, 4, 6):
                    new = sizes[n] + 2
                    spec[n] = grow(sizes[n], new,
                                   float(rng.uniform(0.5, 2.0)))
                    sizes[n] = new
                else:
                    spec[n] = edge(sizes[n], int(rng.integers(1e6)))
            pair.ingest(spec)
            if step == 5:
                ja, ta = pair.both(lambda f, m: f.rebalance())
                assert ta == ja and {a["action"] for a in ta} == {"compact"}
            pair.poll()
            live = [n for n in names
                    if not (step >= 8 and _dead_holds(pair.t, n))]
            got, _ = pair.check(f"step {step}", live)
            assert_scores(got, oracle.tick(spec), f"oracle step {step}",
                          live)
            assert pair.t.last_poll_launches == pair.j.last_poll_launches
            for p, s in pair.t.live_shard_ids():
                tl = pair.t.shard_service(p, s).layout
                jl = pair.j.shard_service(p, s).layout
                assert (tl.n_pad, tl.generation) == \
                    (jl.n_pad, jl.generation), (step, p, s)
            if step == 7:
                shard = pair.t.directory.get("b").shard
                pair.both(lambda f, m: f.kill_shard("small", shard))
            if step == 9:
                jr, tr = pair.both(lambda f, m: f.recover())
                assert tr == jr
                got, ref = pair.check("recovered")
                assert_scores({"b": got["b"]}, {"b": oracle.svc.scores()[1]},
                              "recovered b against the oracle")
        assert pair.t.directory.get("a").pool == 1
        jt, tt = pair.both(lambda f, m: f.top_anomalies(k=3))
        assert [n for n, _ in tt] == [n for n, _ in jt]
    finally:
        pair.close()


# -- the pool tick -----------------------------------------------------------

def _budget(monkeypatch, port_bytes, jax_bytes):
    monkeypatch.setattr(dispatch, "_BASE_STACKED_BUDGET_BYTES", port_bytes)
    monkeypatch.setattr(jdispatch, "_BASE_STACKED_BUDGET_BYTES", jax_bytes)


@pytest.mark.parametrize("method", ["fused_tick", "sparse_tick"])
def test_residency_fallback_groups_match_the_reference(method, monkeypatch):
    """With each package's budget set to its own bytes of a one-shard
    group of the larger pool, both tick that pool's two-shard group
    shard by shard and the smaller pool's lone shard as one stacked
    launch: the same launches, the same scores."""
    sparse = method == "sparse_tick"

    def cfg(m):
        extra = dict(n_slots=12, m_pad=24) if sparse else {}
        return m.FleetConfig(pools=(
            m.PoolSpec(name="p", n_pad=16, shards=1, streams_per_shard=2,
                       k_pad=4, j_pad=2, method=method, **extra),
            m.PoolSpec(name="q", n_pad=64, shards=2, streams_per_shard=2,
                       k_pad=4, j_pad=2, method=method, **extra)))

    if sparse:
        one = [m.sparse_tick_stacked_bytes(1, 2, 12, 24, 4, 2)
               for m in (sp_ops, jsp_ops)]
    else:
        one = [m.fused_tick_stacked_bytes(1, 2, 64, 4, 2)
               for m in (st_ops, jst_ops)]
    _budget(monkeypatch, *one)
    tcfg = cfg(tfleet).pools[1].service_config()
    assert not pooltick.group_fits([tcfg, tcfg], device="cpu")
    assert pooltick.group_fits([tcfg], device="cpu")
    assert pooltick.group_fits([cfg(tfleet).pools[0].service_config()],
                               device="cpu")
    pair = Pair(cfg)
    rng = np.random.default_rng(3)
    try:
        names = ["u", "v", "w", "x"]
        for i, n in enumerate(names):
            pair.admit(n, weights(10, i + 5))
        for t in range(3):
            spec = {}
            for n in names:
                i, j = sorted(rng.choice(10, 2, replace=False).tolist())
                spec[n] = dict(senders=[i], receivers=[j],
                               dw=[float(rng.uniform(0.5, 2.0))],
                               w_old=[0.0], n_nodes=16 if sparse else 10,
                               k_pad=4, j_pad=2)
            pair.tick(spec, f"tick {t}")
            assert pair.t.last_poll_launches == \
                pair.j.last_poll_launches == 3
    finally:
        pair.close()


def test_group_by_layout_and_one_launch_per_group():
    """A compaction peels a shard into a group of its own in both
    packages; `group_by_layout` orders groups by first appearance, and
    a stacked poll makes one launch per group (the reference fleet's
    count, and the kernel wrapper's on the CPU: none, plain versions)."""
    cfg = lambda m: m.FleetConfig(pools=(  # noqa: E731
        m.PoolSpec(name="only", n_pad=16, shards=3, streams_per_shard=2,
                   k_pad=K_PAD, j_pad=J_PAD, method="fused_tick"),),
        compact_occupancy=0.95)
    pair = Pair(cfg)
    try:
        for i, n in enumerate(["x", "y", "z"]):
            pair.admit(n, weights(4 + i, i + 11))
        pair.tick({n: edge(4, 300 + k) for k, n in
                   enumerate(["x", "y", "z"])}, "warm")
        assert pair.t.last_poll_launches == pair.j.last_poll_launches == 1

        def groups(f):
            svcs = [f.shard_service(0, s) for s in range(3)]
            return [[svcs.index(s) for s in g]
                    for g in (jpooltick if f is pair.j
                              else pooltick).group_by_layout(svcs)]

        assert groups(pair.t) == groups(pair.j) == [[0, 1, 2]]
        pair.ingest({n: edge(4, 400 + k) for k, n in
                     enumerate(["x", "y", "z"])})
        ja, ta = pair.both(lambda f, m: f.rebalance())
        assert ta == ja and len(ta) == 3
        pair.poll()
        pair.check("across the compaction")
        assert groups(pair.t) == groups(pair.j)
        assert pair.t.last_poll_launches == pair.j.last_poll_launches \
            == len(groups(pair.t)) > 1
        assert st_ops.LAUNCHES["stream_tick_stacked"] == 0  # CPU: plain
    finally:
        pair.close()


def test_warm_pool_tick_rejects_mixed_methods_and_mixed_layouts():
    dense = ServiceConfig(batch_size=2, n_pad=8, k_pad=3, j_pad=2)
    fused = dense.with_(method="fused_tick")
    lay = NodeLayout(8)
    with pytest.raises(PoolGroupError, match="mixed"):
        pooltick.warm_pool_tick([(dense, lay), (fused, lay)], device="cpu")
    pooltick.warm_pool_tick([(fused, lay), (fused, lay)], device="cpu")
    with pytest.raises(PoolGroupError, match="layout"):
        pooltick.warm_pool_tick(
            [(fused, lay), (fused.with_(n_pad=8), NodeLayout(8, 1))],
            device="cpu")
    assert all(pooltick.stackable(m) for m in
               ("dense", "compact", "fused_tick", "sparse_tick"))
    assert not pooltick.stackable("other")
    with pytest.raises(ValueError, match="not stackable"):
        pooltick.pool_tick_fn(False, "other")


def test_stacked_bytes_and_smem_fit_on_the_cpu():
    """The port counts the operands it keeps resident, unpadded; the
    reference pads to TPU lanes. On the CPU the plain version has no
    shared-memory limit, so only the budget decides."""
    assert st_ops.fused_tick_stacked_bytes(2, 2048, 1024, 128, 8) == \
        2 * 2048 * 4 * (4 + 2048 + 640 + 16)
    assert sp_ops.sparse_tick_stacked_bytes(2, 512, 1024, 8192, 128, 8) \
        == 2 * 512 * 4 * (4 + 2048 + 8192 + 768 + 16)
    assert dispatch.stacked_budget_bytes() == \
        jdispatch.stacked_budget_bytes() == 256 * 1024 * 1024
    assert dispatch.smem_fits("stream_tick", 1 << 20, 8, "cpu")
    assert st_ops.fits_fused_tick_stacked(2, 2048, 1024, 128, 8, "cpu")
    assert not st_ops.fits_fused_tick_stacked(64, 2048, 1024, 128, 8, "cpu")
    assert sp_ops.fits_sparse_tick_stacked(2, 512, 1024, 8192, 128, 8,
                                           "cpu")


def test_chain_budget_launches_per_poll():
    """A CPU counterpart of the reference's chain budget: one launch
    per pool in steady state, more after a compaction splits a pool's
    group, one per shard with ``stacked_ticks=False``."""
    for stacked in (True, False):
        fleet = FingerFleet.open(two_buckets(tfleet, compact_occupancy=0.95,
                                             stacked_ticks=stacked),
                                 device="cpu")
        try:
            for i, (n, size) in enumerate([("a", 5), ("b", 6), ("c", 18),
                                           ("d", 20)]):
                fleet.admit(n, graph(tfleet, weights(size, i + 1)))
            sizes = {"a": 5, "b": 6, "c": 18, "d": 20}
            for t in range(2):
                fleet.ingest({n: delta(tfleet, edge(s, 10 * t + k))
                              for k, (n, s) in enumerate(sizes.items())})
                fleet.poll()
                assert fleet.last_poll_launches == (2 if stacked else 4)
            fleet.ingest({n: delta(tfleet, edge(s, 90 + k))
                          for k, (n, s) in enumerate(sizes.items())})
            assert fleet.rebalance()
            fleet.poll()
            assert fleet.last_poll_launches > 2 if stacked \
                else fleet.last_poll_launches == 4
        finally:
            fleet.close()


# -- WAL retention -----------------------------------------------------------

def _tiny(m, **kw):
    return m.FleetConfig(pools=(
        m.PoolSpec(name="tiny", n_pad=8, shards=2, streams_per_shard=2,
                   k_pad=K_PAD, j_pad=J_PAD),), wal_retention_ticks=2, **kw)


def test_wal_retention_prunes_as_the_reference_and_refuses_a_gap():
    pair = Pair(_tiny)
    try:
        pair.admit("a", weights(4, 1))
        for t in range(5):
            pair.tick({"a": edge(4, 100 + t)}, f"tick {t}")
        je, te = (f.directory.get("a") for f in (pair.j, pair.t))
        assert [s for s, _ in te.wal] == [s for s, _ in je.wal] == [4, 5]
        assert te.wal_floor == je.wal_floor == 3
        pair.both(lambda f, m: f.kill_shard("tiny", te.shard))
        je = _raised(pair.j.recover)
        te = _raised(pair.t.recover)
        assert isinstance(je, jfleet.RecoveryError)
        assert isinstance(te, RecoveryError) and str(te) == str(je)
        assert "wal_retention_ticks" in str(te)
    finally:
        pair.close()


def test_save_keeps_recovery_within_the_window(tmp_path):
    pair = Pair(lambda m: _tiny(m, directory=str(
        tmp_path / ("jax" if m is jfleet else "port"))))
    try:
        pair.admit("a", weights(4, 1))
        for t in range(3):
            pair.tick({"a": edge(4, 200 + t)}, f"tick {t}")
        pair.both(lambda f, m: f.save())
        for t in range(2):
            pair.tick({"a": edge(4, 300 + t)}, f"after save {t}")
        e = pair.t.directory.get("a")
        assert e.base_step == 3 and e.wal_floor == 3
        before = pair.t.scores()["a"]
        pair.both(lambda f, m: f.kill_shard("tiny", e.shard))
        pair.both(lambda f, m: f.recover())  # disk base + intact WAL
        assert_scores({"a": pair.t.scores()["a"]}, {"a": before},
                      "recovered from disk")
        pair.check("recovered")
    finally:
        pair.close()


def test_streams_bench_twin_fleet_quick_runs_on_the_cpu(tmp_path):
    import json
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / "fleet.json"
    run = subprocess.run(
        [sys.executable, str(root / "tools" / "streams_bench_torch.py"),
         "--fleet", "--quick", "--device", "cpu", "--json", str(out)],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(out.read_text())
    assert got["device"]["platform"] == "cpu"
    assert {"admission_ms", "cold_promotion_ms", "warm_promotion_ms",
            "recovery_ms", "recovered_tenants"} <= set(got["fleet"])
    assert set(got["fleet"]["admission_ms"]) == {"small", "large",
                                                 "virtual"}
    assert [r["method"] for r in got["fleet_hotpath"]] == \
        ["fused_tick", "sparse_tick"]
    for row in got["fleet_hotpath"]:
        assert row["stacked"]["launches_per_tick"] == 1
        assert row["sequential"]["launches_per_tick"] == row["shards"]
        assert {"ingest_ms", "poll_ms", "scores_ms", "stream_ticks_per_s"} \
            <= set(row["stacked"])
        assert row["save_pause_ms"] > 0
