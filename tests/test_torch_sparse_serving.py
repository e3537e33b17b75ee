"""The port's sparse serving path (`FingerService(method="sparse_tick")`)
against the JAX reference, on the CPU.

Both services — the reference's with the local placement and sync
ingestion, its tick in Pallas interpret mode — are fed the same
per-stream virtual deltas of six tenants living in a 512-id virtual
space: re-weights, new edges, deletions, joins of fresh ids and leaves,
a tick queued across a `grow_capacity`, a virtual `repad`, and joins
past the old virtual bound. Scores and carried state (edge store
included) are compared at atol 1e-5 with rtol 1e-5, masks and top-k
stream ids exactly, and the `SlotMap`s' JSON exactly. The config checks
and the sparse-only refusals are held to the reference's error types and
texts.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import repro.graphs.types as jtypes
import repro.serving as jserving
import repro_torch.serving as tserving
from repro_torch.core.sparse import SparseCapacityError, SparseLayout
from repro_torch.engine import stack_deltas
from repro_torch.graphs import types as ttypes
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.serving import FingerService
from _torch_parity import assert_close, assert_state_close
from test_torch_sparse import (VirtualStreams, assert_sparse_state_close,
                               raised)

B, N_VIRTUAL, K_PAD, J_PAD = 6, 512, 24, 4


def _config(mod, **kw):
    base = dict(batch_size=B, n_pad=N_VIRTUAL, k_pad=K_PAD, j_pad=J_PAD,
                method="sparse_tick", n_slots=24, m_pad=96,
                exact_smax=True, placement="local", ingestion="sync",
                topk=mod.TopKSpec(k=3))
    base.update(kw)
    return mod.ServiceConfig(**base)


def _open_pair(streams, **kw):
    jsvc = jserving.FingerService.open(
        _config(jserving, **kw),
        [streams.edge_list(jtypes.EdgeList, s) for s in range(B)])
    tsvc = FingerService.open(
        _config(tserving, **kw),
        (streams.edge_list(ttypes.EdgeList, s) for s in range(B)),
        device="cpu")
    return jsvc, tsvc


def _check_tick(jsvc, tsvc, label):
    assert tsvc.step == jsvc.step
    assert_close(tsvc.scores(), jsvc.scores(), f"{label}: scores")
    assert_sparse_state_close(tsvc.states(), jsvc.states(), label)
    jv, jids = jsvc.top_anomalies()
    tv, tids = tsvc.top_anomalies()
    np.testing.assert_array_equal(tids, jids, f"{label}: top-k")
    assert_close(tv, jv, f"{label}: top-k values")
    assert [m.to_json() for m in tsvc.slot_maps] == \
        [m.to_json() for m in jsvc.slot_maps], label


def test_service_matches_jax_service_across_migrations():
    streams = VirtualStreams(B, N_VIRTUAL, seed=3)
    jsvc, tsvc = _open_pair(streams)
    assert_sparse_state_close(tsvc.states(), jsvc.states(), "open")
    n_virtual = N_VIRTUAL
    for t in range(7):
        if t == 5:  # repad the virtual space, then join past its old bound
            jsvc.repad(2 * N_VIRTUAL)
            tsvc.repad(2 * N_VIRTUAL)
            n_virtual = 2 * N_VIRTUAL
            assert tsvc.config.n_pad == n_virtual == tsvc.layout.n_pad
            tick = []
            for s in range(B):
                v, u = N_VIRTUAL + 40 + s, streams.active[s][0]
                tick.append((np.array([u], np.int32),
                             np.array([v], np.int32),
                             np.array([0.7], np.float32),
                             np.array([0.0], np.float32), [v], []))
                streams.active[s].append(v)
                streams.w[s][(u, v)] = np.float32(0.7)
        else:
            tick = streams.tick()
        jsvc.ingest(streams.deltas(jtypes.GraphDelta, tick, K_PAD, J_PAD,
                                   n_nodes=n_virtual))
        tsvc.ingest(streams.deltas(ttypes.GraphDelta, tick, K_PAD, J_PAD,
                                   n_nodes=n_virtual))
        if t == 3:  # grow with this tick still queued
            want = jsvc.grow_capacity(n_slots=32, m_pad=128)
            got = tsvc.grow_capacity(n_slots=32, m_pad=128)
            assert (got.n_slots, got.m_pad, got.generation) == \
                (want.n_slots, want.m_pad, want.generation) == (32, 128, 1)
            assert tsvc.capacity == got and tsvc.pending == 1
            assert tsvc.config.n_slots == 32
        jsvc.poll()
        report = tsvc.poll()
        assert report.step == t + 1
        _check_tick(jsvc, tsvc, f"tick {t}")
        assert tsvc.score_at(2) == pytest.approx(float(tsvc.scores()[2]))
    assert float(np.max(tsvc.scores())) > 0.0
    jsvc.close()
    tsvc.close()


def test_open_consumes_graphs_one_at_a_time_and_checks_them():
    streams = VirtualStreams(B, N_VIRTUAL, seed=4)
    cfg = _config(tserving)
    seen = []

    def gen(n):
        for s in range(n):
            seen.append(s)
            yield streams.edge_list(ttypes.EdgeList, s % B)

    svc = FingerService.open(cfg, gen(B), device="cpu")
    assert seen == list(range(B)) and svc.capacity == SparseLayout(24, 96)
    for bad, kind in ((gen(B - 1), "generator"),
                      ([streams.edge_list(ttypes.EdgeList, 0)] * (B + 1),
                       "list")):
        with pytest.raises(tserving.ServiceConfigError,
                           match=f"{B - 1 if kind == 'generator' else B + 1}"
                                 r" graph\(s\) != config.batch_size"):
            FingerService.open(cfg, bad, device="cpu")
    big = erdos_renyi(8, 0.5, seed=0, weighted=True)
    small = _config(tserving, n_pad=4)
    jsmall = _config(jserving, n_pad=4)
    jbig = jtypes.DenseGraph.from_weights(jnp.asarray(big.weights.numpy()))
    for err in (raised(lambda: FingerService.open(small, iter([big] * B),
                                                   device="cpu")),
                raised(lambda: jserving.FingerService.open(jsmall,
                                                            [jbig] * B))):
        assert err[0] == "ServiceConfigError"
        assert err[1].startswith("open: graph node count(s) [8] exceed "
                                 "config.n_pad=4; open with a larger n_pad")


@pytest.mark.parametrize("kw", [
    dict(), dict(m_pad=8), dict(n_slots=0, m_pad=8), dict(n_slots=-3,
                                                          m_pad=8),
    dict(n_slots=8), dict(n_slots=8, m_pad=0),
    dict(method="fused_tick", n_slots=8, m_pad=8),
    dict(method="dense", m_pad=8), dict(method="compact", n_slots=8),
])
def test_sparse_config_checks_match_the_reference(kw):
    """The sparse capacities: missing or non-positive under
    ``sparse_tick``, present under a dense method."""
    fields = dict(method="sparse_tick", n_slots=None, m_pad=None)
    fields.update(kw)
    jerr = raised(lambda: _config(jserving, **fields).validate())
    terr = raised(lambda: _config(tserving, **fields).validate())
    assert jerr[0] == "ServiceConfigError" and terr == jerr


def test_sparse_config_validates_in_both_packages():
    for mod in (jserving, tserving):
        _config(mod).validate(num_shards=1)
        dataclasses.replace(_config(mod), n_slots=32,
                            m_pad=128).validate(num_shards=1)


def _svc_pair(**kw):
    streams = VirtualStreams(B, N_VIRTUAL, seed=6)
    return streams, _open_pair(streams, **kw)


def test_sparse_refusals_match_the_reference():
    streams, (jsvc, tsvc) = _svc_pair()
    tick = streams.tick()
    jds = streams.deltas(jtypes.GraphDelta, tick, K_PAD, J_PAD)
    tds = streams.deltas(ttypes.GraphDelta, tick, K_PAD, J_PAD)
    from repro.engine import stack_deltas as j_stack_deltas

    pairs = [
        # a pre-stacked delta bypasses the SlotMaps
        (lambda: jsvc.ingest(j_stack_deltas(jds)),
         lambda: tsvc.ingest(stack_deltas(tds))),
        (lambda: jsvc.ingest(jds[:-1]), lambda: tsvc.ingest(tds[:-1])),
        (lambda: jsvc.repad(N_VIRTUAL // 2),
         lambda: tsvc.repad(N_VIRTUAL // 2)),
        (lambda: jsvc.repad(N_VIRTUAL), lambda: tsvc.repad(N_VIRTUAL)),
        (lambda: jsvc.grow_capacity(n_slots=8),
         lambda: tsvc.grow_capacity(n_slots=8)),
        (lambda: jsvc.grow_capacity(), lambda: tsvc.grow_capacity()),
    ]
    for jfn, tfn in pairs:
        assert raised(tfn) == raised(jfn)
    assert tsvc.pending == 0
    # a slot-space delta on a dense service
    jdense = jserving.FingerService.open(
        _config(jserving, method="fused_tick", n_slots=None, m_pad=None),
        [jtypes.DenseGraph.from_weights(jnp.zeros((4, 4)))] * B)
    tdense = FingerService.open(
        _config(tserving, method="fused_tick", n_slots=None, m_pad=None),
        [ttypes.DenseGraph.from_weights(np.zeros((4, 4), np.float32))] * B,
        device="cpu")
    jslot = j_stack_deltas([m.translate(d) for m, d in
                            zip(jsvc.slot_maps, jds)])
    tslot = stack_deltas([m.translate(d) for m, d in
                          zip(tsvc.slot_maps, tds)])
    jerr = raised(lambda: jdense.ingest(jslot))
    assert jerr[0] == "IngestError"
    assert raised(lambda: tdense.ingest(tslot)) == jerr
    assert raised(lambda: tdense.grow_capacity(n_slots=64)) == \
        raised(lambda: jdense.grow_capacity(n_slots=64))
    # the dense repad grows both services' layouts alike
    jdense.repad(2 * N_VIRTUAL)
    tdense.repad(2 * N_VIRTUAL)
    assert (tdense.layout.n_pad, tdense.layout.generation) == \
        (2 * N_VIRTUAL, 1)
    assert_state_close(tdense.states(), jdense.states(), "dense repad")


def test_sparse_ingest_is_atomic_over_the_batch():
    """A stream out of node slots rejects the whole tick and leaves
    every SlotMap as it was; a full queue rejects before translating."""
    streams, (jsvc, tsvc) = _svc_pair(max_queue=1)
    before = [m.to_json() for m in tsvc.slot_maps]
    fresh = [v for v in range(N_VIRTUAL)
             if v not in tsvc.slot_maps[2].node_slot][:40]
    tick = [(np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.float32), np.zeros(0, np.float32), [], [])] * B
    tick[2] = tick[2][:4] + (fresh, [])
    for mod_svc, ty in ((jsvc, jtypes), (tsvc, ttypes)):
        ds = streams.deltas(ty.GraphDelta, tick, K_PAD, j_pad=40)
        assert "node slots exhausted" in raised(
            lambda: mod_svc.ingest(ds))[1]
    assert raised(lambda: tsvc.ingest(streams.deltas(
        ttypes.GraphDelta, tick, K_PAD, j_pad=40)))[0] == \
        SparseCapacityError.__name__
    assert [m.to_json() for m in tsvc.slot_maps] == before
    ok = streams.deltas(ttypes.GraphDelta, streams.tick(), K_PAD, J_PAD)
    tsvc.ingest(ok)
    after = [m.to_json() for m in tsvc.slot_maps]
    with pytest.raises(tserving.IngestError, match="queue full"):
        tsvc.ingest(ok)
    assert [m.to_json() for m in tsvc.slot_maps] == after


def _bad_tick(streams, tick, case):
    """One tick's per-stream deltas that every SlotMap stages but that
    the service must refuse once they are stacked."""
    if case == "k_pad":
        return streams.deltas(ttypes.GraphDelta, tick, 2 * K_PAD, J_PAD)
    if case == "j_pad":
        return streams.deltas(ttypes.GraphDelta, tick, K_PAD, J_PAD + 1)
    # node slots in every stream but the last
    ds = streams.deltas(ttypes.GraphDelta, tick, K_PAD, J_PAD)
    ds[-1] = ttypes.GraphDelta.from_arrays(*tick[-1][:4], n_nodes=N_VIRTUAL,
                                          k_pad=K_PAD)
    return ds


@pytest.mark.parametrize("case", ["k_pad", "j_pad", "node-slot presence"])
def test_sparse_ingest_refused_after_staging_commits_no_map(case):
    """A tick refused only once it is stacked and checked against the
    config leaves every SlotMap as it was, and the same tick ingested
    well afterwards keeps the port in step with the reference."""
    streams, (jsvc, tsvc) = _svc_pair()
    tick = streams.tick()
    before = [m.to_json() for m in tsvc.slot_maps]
    with pytest.raises((tserving.IngestError, ValueError),
                       match=case.split()[0]):
        tsvc.ingest(_bad_tick(streams, tick, case))
    assert [m.to_json() for m in tsvc.slot_maps] == before
    assert tsvc.pending == 0
    jsvc.ingest(streams.deltas(jtypes.GraphDelta, tick, K_PAD, J_PAD))
    tsvc.ingest(streams.deltas(ttypes.GraphDelta, tick, K_PAD, J_PAD))
    assert [m.to_json() for m in tsvc.slot_maps] != before
    jsvc.poll()
    tsvc.poll()
    _check_tick(jsvc, tsvc, case)


def test_service_constructor_checks_match_the_reference():
    streams, (jsvc, tsvc) = _svc_pair()
    cases = [
        (lambda mod, svc: mod.FingerService(svc.config, svc.plan,
                                            svc.states())),
        (lambda mod, svc: mod.FingerService(svc.config, svc.plan,
                                            svc.states(),
                                            slot_maps=svc.slot_maps[:2])),
        (lambda mod, svc: mod.FingerService(dataclasses.replace(svc.config,
                                                                n_slots=32),
                                            svc.plan, svc.states(),
                                            slot_maps=svc.slot_maps)),
    ]
    for case in cases:
        assert raised(lambda: case(tserving, tsvc)) == \
            raised(lambda: case(jserving, jsvc))
