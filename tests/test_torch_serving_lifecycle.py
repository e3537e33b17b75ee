"""The port's serving lifecycle against the JAX reference, on the CPU:
double-buffered ingestion, the dense `repad`, `compact`, the grace
remaps of older-layout deltas, the plan cache and the pool-tick hooks.

The classes mirror the reference's `tests/test_serving.py`. The oracle
is the JAX `FingerService` with the local placement (``method="dense"``,
or ``"fused_tick"`` with its Pallas tick in interpret mode) fed the same
seeded numpy deltas: scores and state at atol 1e-5 with rtol 1e-5 (the
reference's kernel parity tolerance; a score as its divergence where
that is below 1e-3, see `assert_scores`), masks exactly, top-k ids
identical, and the named errors with the reference's types and texts.
The reference's red `test_serving_smoke.py` double-buffered cases are
sharded and multipod only, so they are no oracle here: the JAX service
always runs the local placement, and the port's two ingestions are held
to it and bit-equal to each other.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.graphs.types as jtypes
import repro.serving as jserving
import repro_torch.serving as tserving
from repro.graphs.layout import NodeLayout as JNodeLayout
from repro.serving import migrate as jmigrate
from repro_torch.core.state import FingerState
from repro_torch.engine import StreamEngine, stack_deltas
from repro_torch.graphs import types as ttypes
from repro_torch.graphs.layout import (NodeLayout, compose_index_maps,
                                       identity_index_map, plan_compaction,
                                       truncation_plan)
from repro_torch.serving import (CheckpointPolicy, FingerService,
                                 GraceLapseError, IngestError,
                                 LayoutMigrationError, PlanCachePolicy,
                                 ServiceConfig, ServiceConfigError,
                                 ServiceLifecycleError, TopKSpec)
from repro_torch.serving import migrate
from _torch_parity import assert_close, assert_state_close
from test_torch_sparse import raised

ROOT = Path(__file__).resolve().parents[1]
INGESTIONS = ("sync", "double_buffered")


def weights(b, n, seed, p=0.3):
    """B seeded symmetric (n, n) float32 weight matrices."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        w = np.triu(rng.random((n, n)) < p, 1) * rng.uniform(0.5, 1.5,
                                                            (n, n))
        out.append((w + w.T).astype(np.float32))
    return out


def open_pair(ws, jax_kw=None, **kw):
    """The JAX service (local placement, sync) and the port's on the CPU,
    over the same graphs; ``jax_kw`` overrides the reference's fields."""
    base = dict(batch_size=len(ws), topk_k=2)
    base.update(kw)
    k = base.pop("topk_k")
    # the reference's service is ephemeral unless jax_kw gives it a
    # directory of its own, and runs the reference's own policy objects
    jfields = dict(base, ingestion="sync",
                   checkpoint=jserving.CheckpointPolicy())
    if "plan_cache" in base:
        pc = base["plan_cache"]
        jfields["plan_cache"] = jserving.PlanCachePolicy(
            pc.enabled, pc.growth_factor, pc.warm_compact)
    jfields.update(jax_kw or {})
    jsvc = jserving.FingerService.open(
        jserving.ServiceConfig(topk=jserving.TopKSpec(k=k), **jfields),
        [jtypes.DenseGraph.from_weights(jnp.asarray(w)) for w in ws])
    tsvc = FingerService.open(
        ServiceConfig(topk=TopKSpec(k=k), **base),
        [ttypes.DenseGraph.from_weights(w) for w in ws], device="cpu")
    return jsvc, tsvc


def deltas(cls, arrays, **kw):
    """Per-stream deltas of ``cls`` from ((i, j, dw, w_old), join,
    leave) tuples; ``kw`` goes to every `from_arrays` (n_nodes, n_pad,
    k_pad, j_pad, layout)."""
    if "layout" in kw and cls is jtypes.GraphDelta:
        lay = kw["layout"]
        kw = dict(kw, layout=JNodeLayout(lay.n_pad, lay.generation))
    return [cls.from_arrays(*arrs, join=join, leave=leave, **kw)
            for arrs, join, leave in arrays]


def edge_tick(ws, rng, nodes, k=1):
    """One tick of k random lane changes a stream among ``nodes`` (an
    id list, or n for [0, n)), kept in the host mirrors ``ws``."""
    out = []
    for w in ws:
        pairs = set()
        while len(pairs) < k:
            i, j = sorted(rng.choice(nodes, 2, replace=False).tolist())
            pairs.add((i, j))
        ii = np.array([p[0] for p in pairs], np.int32)
        jj = np.array([p[1] for p in pairs], np.int32)
        wo = w[ii, jj].astype(np.float32)
        dw = np.where(wo > 0, -wo, 0.5).astype(np.float32)
        w[ii, jj] += dw
        w[jj, ii] += dw
        out.append(((ii, jj, dw, wo), [], []))
    return out


def leave_tick(ws, node):
    """Every stream deletes all edges at ``node``, and the node leaves."""
    out = []
    for w in ws:
        nb = np.nonzero(w[node])[0].astype(np.int32)
        wo = w[node, nb].astype(np.float32)
        w[node, :] = 0.0
        w[:, node] = 0.0
        out.append(((np.full(len(nb), node, np.int32), nb, -wo, wo), [],
                    [node]))
    return out


def ingest_both(jsvc, tsvc, arrays, **kw):
    jsvc.ingest(deltas(jtypes.GraphDelta, arrays, **kw))
    tsvc.ingest(deltas(ttypes.GraphDelta, arrays, **kw))


def assert_scores(got, want, label):
    """Scores at atol 1e-5 with rtol 1e-5, held as divergences (score²)
    where the divergence is below 1e-3: the score is the square root of
    a difference of float32 entropies of order 1, so a rounding of
    2e-7 there (one ulp) becomes 1e-5 in the score of a barely changed
    stream."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert_close(got ** 2, want ** 2, f"{label}: divergences")
    big = want ** 2 > 1e-3
    assert_close(got[big], want[big], f"{label}: scores")


def check_pair(jsvc, tsvc, label):
    """Scores, state, layout and top-k of the port against the JAX
    service after a tick."""
    assert tsvc.step == jsvc.step, label
    assert_scores(tsvc.scores(), jsvc.scores(), label)
    assert_state_close(tsvc.states(), jsvc.states(), label)
    assert (tsvc.layout.n_pad, tsvc.layout.generation) == \
        (jsvc.layout.n_pad, jsvc.layout.generation), label
    jv, jids = jsvc.top_anomalies()
    tv, tids = tsvc.top_anomalies()
    np.testing.assert_array_equal(tids, jids, f"{label}: top-k")
    assert_scores(tv, jv, f"{label}: top-k values")


def poll_both(jsvc, tsvc, label):
    assert jsvc.poll() is not None
    assert tsvc.poll() is not None
    check_pair(jsvc, tsvc, label)


def state_bits(svc):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in svc.states().tensors().items()}


def assert_bits_equal(a, b, label=""):
    assert a.keys() == b.keys(), label
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], f"{label}: {k}")


# -- config ------------------------------------------------------------------

class TestConfig:
    def test_defaults_match_the_reference(self):
        mine = ServiceConfig(batch_size=4, n_pad=8, k_pad=2)
        theirs = jserving.ServiceConfig(batch_size=4, n_pad=8, k_pad=2)
        assert mine.ingestion == theirs.ingestion == "double_buffered"
        assert mine.grace_generations == theirs.grace_generations == 3
        assert mine.plan_cache == PlanCachePolicy()
        assert (theirs.plan_cache.enabled, theirs.plan_cache.growth_factor,
                theirs.plan_cache.warm_compact) == (True, 2.0, True)
        assert mine.with_(n_pad=16).n_pad == 16 and mine.n_pad == 8

    @pytest.mark.parametrize("kw", [
        dict(grace_generations=-1),
        dict(plan_cache="growth"),
        dict(ingestion="triple"),
    ])
    def test_invalid_configs_raise_like_the_reference(self, kw):
        def build(mod):
            fix = dict(kw)
            if fix.get("plan_cache") == "growth":
                fix["plan_cache"] = mod.PlanCachePolicy(growth_factor=0.5)
            return mod.ServiceConfig(batch_size=2, n_pad=8, k_pad=2, **fix)

        assert raised(lambda: build(tserving).validate()) == \
            raised(lambda: build(jserving).validate())

    def test_lifted_options_validate(self):
        ServiceConfig(batch_size=2, n_pad=8, k_pad=2,
                      ingestion="double_buffered",
                      checkpoint=CheckpointPolicy("ckpts", every_ticks=2),
                      grace_generations=None,
                      topk=TopKSpec(k=1)).validate()


# -- ingestion -------------------------------------------------------------

class TestBitExactRegression:
    @pytest.mark.parametrize("method", ["dense", "fused_tick"])
    def test_double_buffered_matches_sync(self, method):
        """Bit-equal scores and state under both ingestions, and both
        held to the JAX service."""
        b, n, k_pad, t = 8, 16, 4, 4
        ws = weights(b, n, seed=5)
        rng = np.random.default_rng(5)
        ticks = [edge_tick(ws, rng, n, k=3) for _ in range(t)]
        start = weights(b, n, seed=5)
        jsvc = jserving.FingerService.open(
            jserving.ServiceConfig(batch_size=b, n_pad=n, k_pad=k_pad,
                                   method=method, ingestion="sync",
                                   topk=jserving.TopKSpec(k=2)),
            [jtypes.DenseGraph.from_weights(jnp.asarray(w)) for w in start])
        outs = {}
        for mode in INGESTIONS:
            cfg = ServiceConfig(batch_size=b, n_pad=n, k_pad=k_pad,
                                method=method, ingestion=mode,
                                topk=TopKSpec(k=2))
            with FingerService.open(cfg, [ttypes.DenseGraph.from_weights(w)
                                          for w in start],
                                    device="cpu") as svc:
                outs[mode] = []
                for d in ticks:
                    svc.ingest(deltas(ttypes.GraphDelta, d, n_nodes=n,
                                      k_pad=k_pad))
                    svc.poll()
                    outs[mode].append((svc.scores(), state_bits(svc)))
                last = svc
                if mode == "sync":
                    for d in ticks:
                        jsvc.ingest(deltas(jtypes.GraphDelta, d, n_nodes=n,
                                           k_pad=k_pad))
                        jsvc.poll()
                    assert_scores(svc.scores(), jsvc.scores(), "vs JAX")
                    assert_state_close(svc.states(), jsvc.states(), "JAX")
        assert last.config.ingestion == "double_buffered"
        for (s0, b0), (s1, b1) in zip(outs["sync"],
                                      outs["double_buffered"]):
            np.testing.assert_array_equal(s0, s1)
            assert_bits_equal(b0, b1)

    def test_make_ingestor_picks_by_config(self):
        from repro_torch.serving.ingest import (DoubleBufferedIngestor,
                                                SyncIngestor, make_ingestor)
        from repro_torch.serving.plans import build_plan

        cfg = ServiceConfig(batch_size=2, n_pad=8, k_pad=2,
                            topk=TopKSpec(k=1))
        plan = build_plan(cfg, torch.device("cpu"))
        assert type(make_ingestor(cfg, plan)) is DoubleBufferedIngestor
        assert type(make_ingestor(cfg.with_(ingestion="sync"), plan)) \
            is SyncIngestor


class TestIngestionQueue:
    @pytest.mark.parametrize("ingestion", INGESTIONS)
    def test_pop_hands_over_the_queued_tick_as_held(self, ingestion):
        ws = weights(3, 8, seed=2)
        cfg = ServiceConfig(batch_size=3, n_pad=8, k_pad=2,
                            ingestion=ingestion, topk=TopKSpec(k=1))
        svc = FingerService.open(cfg, [ttypes.DenseGraph.from_weights(w)
                                       for w in ws], device="cpu")
        with pytest.raises(ServiceLifecycleError, match="empty ingestion"):
            svc.begin_pool_tick()
        d = stack_deltas(deltas(ttypes.GraphDelta,
                                edge_tick(ws, np.random.default_rng(2), 8),
                                n_nodes=8, k_pad=2))
        svc.ingest(d)
        got = svc.begin_pool_tick()
        assert svc.pending == 0
        for name, t in d.tensors().items():
            assert torch.equal(getattr(got, name), t), name


# -- migrations ------------------------------------------------------------

class TestRepad:
    def test_repad_grows_layout_and_matches_jax(self):
        ws = weights(3, 10, seed=4)
        jsvc, tsvc = open_pair(ws, n_pad=12, k_pad=3, j_pad=2)
        rng = np.random.default_rng(4)
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, 10), n_nodes=10,
                    n_pad=12, k_pad=3, j_pad=2)
        poll_both(jsvc, tsvc, "before")
        jsvc.repad(20)
        tsvc.repad(20)
        assert tsvc.config.n_pad == 20
        assert tsvc.layout == NodeLayout(20, generation=1)
        assert_state_close(tsvc.states(), jsvc.states(), "grown")
        # join a node beyond the old layout
        join = [((np.array([0], np.int32), np.array([15], np.int32),
                  np.array([0.9], np.float32), np.array([0.0], np.float32)),
                 [15], []) for _ in ws]
        ingest_both(jsvc, tsvc, join, n_nodes=10, n_pad=20, k_pad=3,
                    j_pad=2)
        poll_both(jsvc, tsvc, "after the join")
        arrays = edge_tick(ws, rng, 10)
        stale = deltas(ttypes.GraphDelta, arrays, n_nodes=12, k_pad=3,
                       j_pad=2)
        jstale = deltas(jtypes.GraphDelta, arrays, n_nodes=12, k_pad=3,
                        j_pad=2)
        err = raised(lambda: tsvc.ingest(stale))
        assert err[0] == "IngestError" and "repad" in err[1]
        assert err == raised(lambda: jsvc.ingest(jstale))

    def test_repad_rejects_noop_and_lossy_shrink(self):
        ws = weights(4, 12, seed=6, p=0.9)
        jsvc, tsvc = open_pair(ws, n_pad=12, k_pad=3)
        ingest_both(jsvc, tsvc, edge_tick(ws, np.random.default_rng(6), 12),
                    n_nodes=12, k_pad=3)
        for call in (lambda s: s.repad(12), lambda s: s.repad(8)):
            err = raised(lambda: call(tsvc))
            assert err == raised(lambda: call(jsvc))
        assert err[0] == "LayoutMigrationError" and "truncate" in err[1]
        assert tsvc.pending == 1  # the refused migration kept the tick
        poll_both(jsvc, tsvc, "after the refusals")

    @pytest.mark.parametrize("ingestion", INGESTIONS)
    def test_repad_relays_out_prefetched_queue(self, ingestion):
        ws = weights(3, 10, seed=8)
        jsvc, tsvc = open_pair(ws, n_pad=10, k_pad=3, ingestion=ingestion)
        ingest_both(jsvc, tsvc, edge_tick(ws, np.random.default_rng(8), 10),
                    n_nodes=10, k_pad=3)
        jsvc.repad(16)
        tsvc.repad(16)
        assert tsvc.pending == 1
        poll_both(jsvc, tsvc, "the prefetched tick")

    def test_repad_truncates_inactive_tail(self):
        ws = weights(3, 12, seed=9)
        jsvc, tsvc = open_pair(ws, n_pad=12, k_pad=3)
        rng = np.random.default_rng(9)
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, 12), n_nodes=12, k_pad=3)
        poll_both(jsvc, tsvc, "tick")
        before = state_bits(tsvc)
        for svc in (jsvc, tsvc):
            svc.repad(24)
            svc.repad(12)
        assert tsvc.layout == NodeLayout(12, generation=2)
        assert_bits_equal(before, state_bits(tsvc))
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, 12), n_nodes=12, k_pad=3)
        poll_both(jsvc, tsvc, "after grow and truncate")


def _compact_pair(seed, n0=12, n_pad=16, **kw):
    """Three n0-node streams in an n_pad layout (slots n0.. inactive)."""
    ws = weights(3, n0, seed=seed)
    kw.setdefault("exact_smax", True)
    jsvc, tsvc = open_pair(ws, n_pad=n_pad, k_pad=12, j_pad=2, **kw)
    return ws, jsvc, tsvc


class TestCompact:
    def test_compact_reclaims_and_matches_jax(self):
        ws, jsvc, tsvc = _compact_pair(11)
        ingest_both(jsvc, tsvc, leave_tick(ws, 3), n_nodes=16, k_pad=12,
                    j_pad=2)
        poll_both(jsvc, tsvc, "leave")
        want, got = jsvc.compact(), tsvc.compact()
        assert (got.old_n_pad, got.new_n_pad, got.n_live, got.generation,
                got.reclaimed) == (want.old_n_pad, want.new_n_pad,
                                   want.n_live, want.generation,
                                   want.reclaimed) == (16, 11, 11, 1, 5)
        np.testing.assert_array_equal(got.index_map, want.index_map)
        assert got.index_map.dtype == np.int32
        assert_state_close(tsvc.states(), jsvc.states(), "compacted")
        keep = got.index_map[:12] >= 0
        ingest_both(jsvc, tsvc, edge_tick([w[keep][:, keep] for w in ws],
                                          np.random.default_rng(1), 11),
                    n_nodes=11, k_pad=12, j_pad=2)
        poll_both(jsvc, tsvc, "after the compaction")

    def test_ingestion_remaps_old_layout_deltas(self):
        ws, jsvc, tsvc = _compact_pair(12)
        ingest_both(jsvc, tsvc, leave_tick(ws, 2), n_nodes=16, k_pad=12,
                    j_pad=2)
        poll_both(jsvc, tsvc, "leave")
        jsvc.compact()
        tsvc.compact()
        old = [((np.array([4], np.int32), np.array([7], np.int32),
                 np.array([0.7], np.float32),
                 np.array([w[4, 7]], np.float32)), [], []) for w in ws]
        ingest_both(jsvc, tsvc, old, n_nodes=16, k_pad=12, j_pad=2)
        poll_both(jsvc, tsvc, "an old-layout delta")
        stale = [((np.array([0], np.int32), np.array([1], np.int32),
                   np.array([0.1], np.float32), np.array([0.0], np.float32)),
                  [2], []) for _ in ws]
        kw = dict(n_nodes=16, k_pad=12, j_pad=2)
        err = raised(lambda: tsvc.ingest(deltas(ttypes.GraphDelta, stale,
                                                **kw)))
        assert err[0] == "LayoutMigrationError" and "dropped" in err[1]
        assert err == raised(lambda: jsvc.ingest(
            deltas(jtypes.GraphDelta, stale, **kw)))

    def test_compact_noop_and_lossy_named_errors(self):
        ws = weights(2, 16, seed=13, p=0.9)
        jsvc, tsvc = open_pair(ws, n_pad=16, k_pad=12, j_pad=2)
        assert tsvc.compact().reclaimed == 0 == jsvc.compact().reclaimed
        assert tsvc.layout.generation == 0
        for call in (lambda s: s.compact(new_n_pad=8),
                     lambda s: s.compact(new_n_pad=16)):
            err = raised(lambda: call(tsvc))
            assert err[0] == "LayoutMigrationError"
            assert err == raised(lambda: call(jsvc))

    @pytest.mark.parametrize("ingestion", INGESTIONS)
    def test_compact_aborts_cleanly_on_unmigratable_queued_tick(
            self, ingestion, tmp_path):
        ws, jsvc, tsvc = _compact_pair(
            15, ingestion=ingestion,
            checkpoint=CheckpointPolicy(str(tmp_path / "t")),
            jax_kw=dict(checkpoint=jserving.CheckpointPolicy(
                str(tmp_path / "j"))))
        ingest_both(jsvc, tsvc, leave_tick(ws, 4), n_nodes=16, k_pad=12,
                    j_pad=2)
        poll_both(jsvc, tsvc, "leave")
        join = [((np.array([0], np.int32), np.array([4], np.int32),
                  np.array([0.3], np.float32), np.array([0.0], np.float32)),
                 [4], []) for _ in ws]
        ingest_both(jsvc, tsvc, join, n_nodes=16, k_pad=12, j_pad=2)
        before = state_bits(tsvc)
        err = raised(tsvc.compact)
        assert err[0] == "LayoutMigrationError" and "dropped" in err[1]
        assert err == raised(jsvc.compact)
        assert tsvc.layout.generation == 0 and tsvc.config.n_pad == 16
        assert tsvc.pending == 1
        assert migrate.load_layout_log(str(tmp_path / "t")) == []
        assert_bits_equal(before, state_bits(tsvc))
        poll_both(jsvc, tsvc, "the queued join on the unmigrated layout")

    def test_migrating_a_forked_journal_is_rejected(self, tmp_path):
        ws, jsvc, tsvc = _compact_pair(
            16, checkpoint=CheckpointPolicy(str(tmp_path)))
        tsvc.ingest(deltas(ttypes.GraphDelta, leave_tick(ws, 4),
                           n_nodes=16, k_pad=12, j_pad=2))
        tsvc.poll()
        tsvc.save()
        tsvc.compact()  # journals generation 0 -> 1
        cfg = tsvc.config.with_(n_pad=16)
        tsvc.close()
        forked = FingerService.restore(cfg, device="cpu")
        assert forked.layout.generation == 0
        with pytest.raises(LayoutMigrationError, match="fork"):
            forked.compact()
        with pytest.raises(LayoutMigrationError, match="fork"):
            forked.repad(32)
        assert forked.layout.generation == 0

    @pytest.mark.parametrize("ingestion", INGESTIONS)
    def test_compact_relays_out_prefetched_queue(self, ingestion):
        ws, jsvc, tsvc = _compact_pair(14, ingestion=ingestion)
        ingest_both(jsvc, tsvc, leave_tick(ws, 5), n_nodes=16, k_pad=12,
                    j_pad=2)
        poll_both(jsvc, tsvc, "leave")
        ingest_both(jsvc, tsvc, edge_tick(ws, np.random.default_rng(14), 5),
                    n_nodes=16, k_pad=12, j_pad=2)
        assert tsvc.compact().reclaimed == jsvc.compact().reclaimed > 0
        assert tsvc.pending == 1
        poll_both(jsvc, tsvc, "the remapped prefetched tick")


@pytest.mark.parametrize("ingestion", INGESTIONS)
@pytest.mark.parametrize("method", ["dense", "fused_tick"])
def test_migration_chain_matches_jax_service(method, ingestion):
    """One delta stream through one migration chain: a grow with a tick
    queued, a compaction of the grown tail and of a left node, and a
    grace remap of a generation-0-stamped delta."""
    b, n0 = 8, 12
    ws = weights(b, n0, seed=21)
    jsvc, tsvc = open_pair(ws, n_pad=16, k_pad=8, j_pad=2, method=method,
                           exact_smax=True, ingestion=ingestion,
                           topk_k=3)
    gen0 = tsvc.layout
    rng = np.random.default_rng(21)
    kw = dict(n_nodes=16, k_pad=8, j_pad=2)
    for t in range(2):
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, n0, k=4), **kw)
        poll_both(jsvc, tsvc, f"tick {t}")
    ingest_both(jsvc, tsvc, edge_tick(ws, rng, n0, k=4), **kw)
    jsvc.repad(32)
    tsvc.repad(32)
    poll_both(jsvc, tsvc, "the tick queued across the grow")
    ingest_both(jsvc, tsvc, leave_tick(ws, 1), n_nodes=32, k_pad=8, j_pad=2)
    poll_both(jsvc, tsvc, "leave")
    want, got = jsvc.compact(), tsvc.compact()
    np.testing.assert_array_equal(got.index_map, want.index_map)
    assert got.new_n_pad == n0 - 1 and tsvc.layout.generation == 2
    # a producer still on the generation-0 layout of 16 slots
    live = [v for v in range(n0) if v != 1]
    ingest_both(jsvc, tsvc, edge_tick(ws, rng, live, k=4), n_nodes=16,
                k_pad=8, j_pad=2, layout=gen0)
    poll_both(jsvc, tsvc, "the grace remap")
    ws = [w[live][:, live] for w in ws]
    ingest_both(jsvc, tsvc, edge_tick(ws, rng, n0 - 1, k=4),
                n_nodes=n0 - 1, k_pad=8, j_pad=2)
    poll_both(jsvc, tsvc, "after the chain")


class TestDeviceCompaction:
    """`migrate.compact_stacked_auto`: occupancy, renumbering and
    gather on the state's device."""

    def _left_states(self):
        ws = weights(3, 12, seed=21)
        states = StreamEngine.init_states(
            [ttypes.DenseGraph.from_weights(w) for w in ws], n_pad=16,
            device="cpu")
        mask = states.node_mask.clone()
        strengths = states.strengths.clone()
        mask[:, [3, 7]] = 0.0
        strengths[:, [3, 7]] = 0.0
        return FingerState(q=states.q, s_total=states.s_total,
                           s_max=states.s_max, strengths=strengths,
                           node_mask=mask, layout=states.layout)

    def test_device_renumbering_matches_host_plan(self):
        states = self._left_states()
        occ = migrate.occupancy(states)
        plan = plan_compaction(occ, states.layout, new_n_pad=10)
        out, imap = migrate.compact_stacked_auto(states,
                                                 NodeLayout(10, 1))
        np.testing.assert_array_equal(imap.numpy(), plan.index_map)
        keep = plan.keep
        np.testing.assert_array_equal(out.strengths.numpy(),
                                      states.strengths.numpy()[:, keep])
        np.testing.assert_array_equal(out.node_mask.numpy(),
                                      states.node_mask.numpy()[:, keep])
        assert plan.n_live == 10 and plan.reclaimed == 6
        assert plan.new == NodeLayout(10, generation=1)
        # the reference's device transform and host plan agree
        from repro.core.state import FingerState as JFingerState
        from repro.graphs.layout import plan_compaction as jplan

        jstates = JFingerState(
            **{k: jnp.asarray(v.numpy())
               for k, v in states.tensors().items()},
            layout=JNodeLayout(16))
        jout, jimap = jmigrate.compact_stacked_auto(jstates,
                                                    JNodeLayout(10, 1))
        np.testing.assert_array_equal(np.asarray(jimap), plan.index_map)
        np.testing.assert_array_equal(
            jplan(occ, JNodeLayout(16)).index_map, plan.index_map)
        np.testing.assert_array_equal(np.asarray(jout.strengths),
                                      out.strengths.numpy())

    def test_truncate_and_grow_stacked(self):
        states = self._left_states()
        out = migrate.truncate_stacked(states, NodeLayout(12, 1))
        assert out.strengths.is_contiguous()
        np.testing.assert_array_equal(out.strengths.numpy(),
                                      states.strengths.numpy()[:, :12])
        grown = migrate.grow_stacked(out, NodeLayout(20, 2))
        np.testing.assert_array_equal(grown.strengths.numpy()[:, :12],
                                      out.strengths.numpy())
        assert float(grown.node_mask[:, 12:].abs().sum()) == 0.0
        for fn, layout in ((migrate.truncate_stacked, NodeLayout(16, 1)),
                           (migrate.grow_stacked, NodeLayout(16, 1)),
                           (migrate.compact_stacked_auto,
                            NodeLayout(17, 1))):
            with pytest.raises(LayoutMigrationError):
                fn(states, layout)

    def test_host_plans_match_the_reference(self):
        from repro.graphs import layout as jlayout

        occ = np.zeros(16, bool)
        occ[[0, 2, 3, 9]] = True
        with pytest.raises(ValueError, match="still active"):
            truncation_plan(occ, NodeLayout(16), 8)
        got = truncation_plan(occ, NodeLayout(16), 10)
        want = jlayout.truncation_plan(occ, JNodeLayout(16), 10)
        np.testing.assert_array_equal(got.index_map, want.index_map)
        a = plan_compaction(occ, NodeLayout(16)).index_map
        chained = compose_index_maps(a, identity_index_map(4))
        np.testing.assert_array_equal(
            chained, jlayout.compose_index_maps(a, jlayout.identity_index_map(
                4)))
        for fn in (lambda L: L(16).grown(16), lambda L: L(16).compacted(17)):
            assert raised(lambda: fn(NodeLayout)) == \
                raised(lambda: fn(JNodeLayout))

    def test_live_slot_count_reads_a_scalar(self):
        states = self._left_states()
        assert migrate.live_slot_count(states) == 10
        assert migrate.occupancy(states).dtype == bool


class TestPlanCache:
    def _open(self, **kw):
        ws = weights(3, 10, seed=31)
        kw.setdefault("k_pad", 3)
        cfg = ServiceConfig(batch_size=3, n_pad=12, topk=TopKSpec(k=2),
                            **kw)
        return ws, FingerService.open(
            cfg, [ttypes.DenseGraph.from_weights(w) for w in ws],
            device="cpu")

    def test_warm_then_repad_installs_the_warmed_plan(self):
        ws, svc = self._open()
        rng = np.random.default_rng(31)
        svc.ingest(deltas(ttypes.GraphDelta, edge_tick(ws, rng, 10),
                          n_nodes=10, n_pad=12, k_pad=3))
        svc.poll()
        assert 24 in svc.warm_next_layouts()
        assert NodeLayout(24, generation=1) in svc.plan_cache.warmed_layouts
        warm = {id(p) for p, _ in svc.plan_cache._plans.values()}
        svc.repad(24)
        assert id(svc.plan) in warm
        svc.ingest(deltas(ttypes.GraphDelta, edge_tick(ws, rng, 10),
                          n_nodes=10, n_pad=24, k_pad=3))
        assert svc.poll() is not None
        assert np.isfinite(svc.scores()).all()

    def test_background_warm_then_repad(self):
        ws, svc = self._open()
        handle = svc.warm_next_layouts([24], background=True)
        assert handle.wait(timeout=60) == [24] and handle.done()
        warm = {id(p) for p, _ in svc.plan_cache._plans.values()}
        svc.repad(24)
        assert id(svc.plan) in warm

    def test_warm_compact_prediction(self):
        ws, svc = self._open(j_pad=2, exact_smax=True, k_pad=12)
        svc.ingest(deltas(ttypes.GraphDelta, leave_tick(ws, 4), n_nodes=12,
                          k_pad=12, j_pad=2))
        svc.poll()
        assert 9 in svc.warm_next_layouts()
        warm = {id(p) for p, _ in svc.plan_cache._plans.values()}
        assert svc.compact().new_n_pad == 9
        assert id(svc.plan) in warm

    def test_explicit_targets_and_mispredict_falls_back_cold(self):
        ws, svc = self._open()
        assert svc.warm_next_layouts([20]) == [20]
        svc.repad(18)
        assert svc.config.n_pad == 18 and svc.plan.config.n_pad == 18
        svc.ingest(deltas(ttypes.GraphDelta,
                          edge_tick(ws, np.random.default_rng(5), 10),
                          n_nodes=10, n_pad=18, k_pad=3))
        assert svc.poll() is not None

    def test_disabled_policy_warms_nothing(self):
        _, svc = self._open(plan_cache=PlanCachePolicy(enabled=False))
        assert svc.warm_next_layouts() == []
        assert len(svc.plan_cache) == 0

    def test_a_failing_background_warm_raises_at_wait(self):
        _, svc = self._open()
        handle = svc.warm_next_layouts([("not", "an", "n_pad")],
                                       background=True)
        with pytest.raises(TypeError):
            handle.wait(timeout=60)


class TestGenerationGrace:
    def _chain(self, tmp_path=None, grace=3):
        """16 → compact(11) → repad(16), a size-reusing chain, in both
        packages."""
        kw = {} if tmp_path is None else dict(
            checkpoint=CheckpointPolicy(str(tmp_path)))
        ws, jsvc, tsvc = _compact_pair(41, grace_generations=grace, **kw)
        ingest_both(jsvc, tsvc, leave_tick(ws, 3), n_nodes=16, k_pad=12,
                    j_pad=2)
        poll_both(jsvc, tsvc, "leave")
        report = tsvc.compact()
        jsvc.compact()
        for svc in (jsvc, tsvc):
            svc.repad(16)
        assert tsvc.layout == NodeLayout(16, generation=2)
        return ws, jsvc, tsvc, report.index_map

    @staticmethod
    def _stamped(ws, layout, n_nodes=12):
        return [((np.array([4], np.int32), np.array([7], np.int32),
                  np.array([0.7], np.float32),
                  np.array([w[4, 7]], np.float32)), [], []) for w in ws], \
            dict(n_nodes=n_nodes, k_pad=12, j_pad=2, layout=layout)

    def test_gen0_delta_remaps_exactly_through_size_reuse(self):
        ws, jsvc, tsvc, _ = self._chain()
        arrays, kw = self._stamped(ws, NodeLayout(16, generation=0))
        assert deltas(ttypes.GraphDelta, arrays, **kw)[0] \
            .layout_generation == 0
        ingest_both(jsvc, tsvc, arrays, **kw)
        poll_both(jsvc, tsvc, "generation-0 delta")

    def test_current_generation_passes_and_mis_stamp_raises(self):
        ws, jsvc, tsvc, _ = self._chain()
        arrays, kw = self._stamped(ws, tsvc.layout, n_nodes=16)
        ingest_both(jsvc, tsvc, arrays, **kw)
        poll_both(jsvc, tsvc, "current generation")
        for lay, n in ((NodeLayout(12, generation=2), 12),
                       (NodeLayout(32, generation=0), 32)):
            arrays, kw = self._stamped(ws, lay, n_nodes=n)
            err = raised(lambda: tsvc.ingest(deltas(ttypes.GraphDelta,
                                                    arrays, **kw)))
            assert err[0] == "IngestError" and "mis-stamped" in err[1]
            assert err == raised(lambda: jsvc.ingest(
                deltas(jtypes.GraphDelta, arrays, **kw)))

    def test_unknown_generation_rejected_by_name(self):
        ws, jsvc, tsvc, _ = self._chain()
        arrays, kw = self._stamped(ws, NodeLayout(16, generation=9),
                                   n_nodes=16)
        err = raised(lambda: tsvc.ingest(deltas(ttypes.GraphDelta, arrays,
                                                **kw)))
        assert err[0] == "IngestError" and "generation 9" in err[1]
        assert err == raised(lambda: jsvc.ingest(
            deltas(jtypes.GraphDelta, arrays, **kw)))

    def test_grace_lapse_error(self):
        """With grace_generations=1 only the last migration's source
        generation keeps a remap: generation 0 has lapsed."""
        ws, jsvc, tsvc, _ = self._chain(grace=1)
        arrays, kw = self._stamped(ws, NodeLayout(16, generation=0))
        err = raised(lambda: tsvc.ingest(deltas(ttypes.GraphDelta, arrays,
                                                **kw)))
        assert err[0] == "GraceLapseError" and "grace window" in err[1]
        assert err == raised(lambda: jsvc.ingest(
            deltas(jtypes.GraphDelta, arrays, **kw)))
        with pytest.raises(GraceLapseError):
            tsvc.ingest(deltas(ttypes.GraphDelta, arrays, **kw))
        assert issubclass(GraceLapseError, IngestError)
        arrays, kw = self._stamped(ws, NodeLayout(11, generation=1),
                                   n_nodes=11)
        ingest_both(jsvc, tsvc, arrays, **kw)
        poll_both(jsvc, tsvc, "generation 1 is within the window")

    def test_gen_stamped_delta_survives_a_pure_grow(self):
        ws = weights(3, 10, seed=43)
        jsvc, tsvc = open_pair(ws, n_pad=10, k_pad=3)
        for svc in (jsvc, tsvc):
            svc.repad(20)
        arrays = edge_tick(ws, np.random.default_rng(43), 10)
        ingest_both(jsvc, tsvc, arrays, n_nodes=10, k_pad=3,
                    layout=NodeLayout(10, generation=0))
        poll_both(jsvc, tsvc, "stamped across a grow")
        raw = edge_tick(ws, np.random.default_rng(44), 10)
        err = raised(lambda: tsvc.ingest(deltas(ttypes.GraphDelta, raw,
                                                n_nodes=10, k_pad=3)))
        assert err[0] == "IngestError" and "repad" in err[1]

    def test_restore_rebuilds_generation_table(self, tmp_path):
        ws, jsvc, tsvc, _ = self._chain(tmp_path)
        tsvc.save()
        cfg = tsvc.config
        tsvc.close()
        svc2 = FingerService.restore(cfg, device="cpu")
        assert svc2.layout.generation == 2
        arrays, kw = self._stamped(ws, NodeLayout(16, generation=0))
        svc2.ingest(deltas(ttypes.GraphDelta, arrays, **kw))
        jsvc.ingest(deltas(jtypes.GraphDelta, arrays, **kw))
        jsvc.poll()
        svc2.poll()
        assert_scores(svc2.scores(), jsvc.scores(), "restored grace remap")

    def test_stack_deltas_validates_generation_consistency(self):
        d1 = ttypes.GraphDelta.from_arrays([0], [1], [1.0], [0.0],
                                           n_nodes=8, k_pad=4,
                                           layout=NodeLayout(8, 1))
        d2 = ttypes.GraphDelta.from_arrays([0], [1], [1.0], [0.0],
                                           n_nodes=8, k_pad=4)
        with pytest.raises(ValueError, match="layout_generation"):
            stack_deltas([d1, d1, d2])


class TestLifecycle:
    def test_closed_service_raises_everywhere(self):
        ws = weights(2, 8, seed=0)
        svc = FingerService.open(
            ServiceConfig(batch_size=2, n_pad=8, k_pad=2,
                          topk=TopKSpec(k=1)),
            [ttypes.DenseGraph.from_weights(w) for w in ws], device="cpu")
        svc.close()
        svc.close()
        for call in (svc.poll, svc.scores, lambda: svc.ingest([]),
                     svc.save, lambda: svc.repad(16), svc.compact,
                     svc.warm_next_layouts, svc.begin_pool_tick,
                     lambda: svc.extract_stream(0),
                     lambda: svc.clear_stream(0)):
            with pytest.raises(ServiceLifecycleError, match="closed"):
                call()

    def test_save_without_directory_is_named_error(self):
        ws = weights(2, 8, seed=0)
        jsvc, tsvc = open_pair(ws, n_pad=8, k_pad=2, topk_k=1)
        err = raised(tsvc.save)
        assert err[0] == "ServiceConfigError" and "directory" in err[1]
        assert err == raised(jsvc.save)

    def test_restore_validates_layout_against_config(self, tmp_path):
        ws = weights(4, 8, seed=7)
        cfg = ServiceConfig(batch_size=4, n_pad=8, k_pad=2,
                            topk=TopKSpec(k=1),
                            checkpoint=CheckpointPolicy(str(tmp_path)))
        with FingerService.open(cfg, [ttypes.DenseGraph.from_weights(w)
                                      for w in ws], device="cpu") as svc:
            svc.save()
        with pytest.raises(ServiceConfigError, match="batch_size"):
            FingerService.restore(cfg.with_(batch_size=8), device="cpu")
        with pytest.raises(ServiceConfigError, match="repad"):
            FingerService.restore(cfg.with_(n_pad=16), device="cpu")
        with pytest.raises(ServiceConfigError, match="no checkpoint "
                                                     "directory"):
            FingerService.restore(cfg.with_(checkpoint=CheckpointPolicy()),
                                  device="cpu")
        with pytest.raises(ValueError, match="method"):
            FingerService.restore(cfg.with_(method="fused_tick"),
                                  device="cpu")
        assert FingerService.restore(cfg, device="cpu").step == 0


@pytest.mark.parametrize("ingestion", INGESTIONS)
def test_pool_tick_hooks_match_poll(ingestion):
    """begin_pool_tick → the plan's tick → finish_pool_tick gives poll's
    scores, state and step (and its periodic checkpoint)."""
    ws = weights(4, 10, seed=3)
    ticks = [edge_tick(ws, np.random.default_rng(3), 10, k=2)
             for _ in range(2)]
    start = weights(4, 10, seed=3)
    outs = []
    for pooled in (False, True):
        svc = FingerService.open(
            ServiceConfig(batch_size=4, n_pad=10, k_pad=2,
                          ingestion=ingestion, method="fused_tick",
                          topk=TopKSpec(k=2)),
            [ttypes.DenseGraph.from_weights(w) for w in start],
            device="cpu")
        for t in ticks:
            svc.ingest(deltas(ttypes.GraphDelta, t, n_nodes=10, k_pad=2))
            if pooled:
                d = svc.begin_pool_tick()
                scores, states = svc.plan.tick(svc.states(), d)
                report = svc.finish_pool_tick(scores, states)
            else:
                report = svc.poll()
        assert report.step == 2 == svc.step
        outs.append((svc.scores(), state_bits(svc)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    assert_bits_equal(outs[0][1], outs[1][1])


def test_streams_bench_twin_quick_runs_on_the_cpu(tmp_path):
    out = tmp_path / "bench.json"
    run = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "streams_bench_torch.py"),
         "--quick", "--device", "cpu", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(out.read_text())
    assert {"device", "config", "sweep", "ingest_overlap",
            "migration_pause"} <= set(got)
    assert got["device"]["platform"] == "cpu"
    assert {"sync", "double_buffered"} == set(got["ingest_overlap"]) - {
        "overlap_fraction", "bytes_per_tick"}
    for mode in INGESTIONS:
        row = got["ingest_overlap"][mode]
        assert {"ingest_ms", "poll_ms", "loop_s",
                "stream_ticks_per_s"} <= set(row)
    assert {"grow_ms", "compact_ms", "swap_cold_ms",
            "swap_warm_ms"} <= set(got["migration_pause"])
    assert got["sweep"] and {"batch", "n_pad", "tick_ms",
                             "stream_ticks_per_s"} <= set(got["sweep"][0])
