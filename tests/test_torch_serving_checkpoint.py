"""Serving checkpoints, the layout journal and the stream hand-off,
across the two packages, on the CPU.

A checkpoint written by either package's `FingerService.save` (or
`StreamEngine.save`) restores in the other, dense and sparse; a layout
journal written by one package's migrations is walked by the other's
`restore`; `extract_stream` / `install_stream` / `clear_stream` move a
stream between two services as the reference's do; and
``CheckpointPolicy.every_ticks`` saves from `poll`. The oracle is the
JAX service with the local placement (its red `test_serving_smoke.py`
double-buffered cases are sharded and multipod only). Scores and state
at atol 1e-5 with rtol 1e-5 (scores as divergences where those are
below 1e-3, as `test_torch_serving_lifecycle.assert_scores` says),
masks, `SlotMap` JSON and top-k ids exactly; a round trip within the
port is bit-equal.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import repro.engine as jengine
import repro.graphs.types as jtypes
import repro.serving as jserving
import repro_torch.serving as tserving
from repro.core.sparse import SlotMap as JSlotMap
from repro_torch.core.sparse import SlotMap
from repro_torch.engine import StreamEngine
from repro_torch.graphs import types as ttypes
from repro_torch.graphs.layout import NodeLayout
from repro_torch.serving import CheckpointPolicy, FingerService, migrate
from _torch_parity import assert_state_close, state_to_port
from test_torch_serving_lifecycle import (INGESTIONS, assert_bits_equal,
                                          edge_tick, ingest_both, leave_tick,
                                          open_pair, poll_both, state_bits,
                                          weights)
from test_torch_sparse import VirtualStreams
from test_torch_sparse_serving import (B as SP_B, J_PAD as SP_J,
                                       K_PAD as SP_K, N_VIRTUAL,
                                       _check_tick, _config, _open_pair)

B, N0, N_PAD, K_PAD, J_PAD = 4, 10, 12, 4, 2
KW = dict(n_nodes=N_PAD, k_pad=K_PAD, j_pad=J_PAD)


def _dense_pair(tmp_path, ingestion="double_buffered", seed=0, **kw):
    ws = weights(B, N0, seed=seed)
    jsvc, tsvc = open_pair(
        ws, n_pad=N_PAD, k_pad=K_PAD, j_pad=J_PAD, method="fused_tick",
        exact_smax=True, ingestion=ingestion,
        checkpoint=CheckpointPolicy(str(tmp_path / "port"), **kw),
        jax_kw=dict(checkpoint=jserving.CheckpointPolicy(
            str(tmp_path / "jax"), **kw)))
    return ws, jsvc, tsvc


def _npz_names(path):
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return sorted(data.files)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_checkpoint_names_and_metadata_match_the_reference(kind, tmp_path):
    """The npz array names, read from a checkpoint the JAX service
    wrote, and the manifest's metadata are the port's."""
    if kind == "dense":
        _, jsvc, tsvc = _dense_pair(tmp_path, ingestion="sync")
    else:
        streams = VirtualStreams(SP_B, N_VIRTUAL, seed=9)
        jsvc, tsvc = _open_pair(streams)
    jpath = jsvc.save(str(tmp_path / "j"))
    tpath = tsvc.save(str(tmp_path / "t"))
    assert _npz_names(tpath) == _npz_names(jpath)
    jmeta, tmeta = _manifest(jpath)["metadata"], _manifest(tpath)["metadata"]
    assert tmeta == jmeta
    assert {"kind", "b", "n_pad", "has_node_mask", "layout_generation",
            "exact_smax", "method"} <= set(tmeta)
    if kind == "sparse":
        assert {"sparse", "slot_maps"} <= set(tmeta)


@pytest.mark.parametrize("ingestion", INGESTIONS)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dense_checkpoint_crosses_packages(writer, ingestion, tmp_path):
    ws, jsvc, tsvc = _dense_pair(tmp_path, ingestion=ingestion, seed=1)
    rng = np.random.default_rng(1)
    for t in range(2):
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, N0, k=3), **KW)
        poll_both(jsvc, tsvc, f"tick {t}")
    if writer == "jax":
        jsvc.save()
        tsvc.close()
        tsvc = FingerService.restore(tsvc.config.with_(
            checkpoint=CheckpointPolicy(str(tmp_path / "jax"))),
            device="cpu")
    else:
        tsvc.save()
        jsvc.close()
        jsvc = jserving.FingerService.restore(
            jsvc.config.with_(checkpoint=jserving.CheckpointPolicy(
                str(tmp_path / "port"))))
    assert tsvc.step == jsvc.step == 2
    assert_state_close(tsvc.states(), jsvc.states(), "restored")
    for t in range(2):
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, N0, k=3), **KW)
        poll_both(jsvc, tsvc, f"after the restore, tick {t}")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sparse_checkpoint_crosses_packages(writer, tmp_path):
    streams = VirtualStreams(SP_B, N_VIRTUAL, seed=10)
    jsvc, tsvc = _open_pair(streams, ingestion="double_buffered")
    for t in range(2):
        tick = streams.tick()
        jsvc.ingest(streams.deltas(jtypes.GraphDelta, tick, SP_K, SP_J))
        tsvc.ingest(streams.deltas(ttypes.GraphDelta, tick, SP_K, SP_J))
        if t == 0:
            jsvc.grow_capacity(n_slots=32)
            tsvc.grow_capacity(n_slots=32)
        jsvc.poll()
        tsvc.poll()
        _check_tick(jsvc, tsvc, f"tick {t}")
    d = str(tmp_path / "ck")
    if writer == "jax":
        jsvc.save(d)
        tsvc = FingerService.restore(tsvc.config, directory=d, device="cpu")
    else:
        tsvc.save(d)
        jsvc = jserving.FingerService.restore(jsvc.config, directory=d)
    assert tsvc.capacity == type(tsvc.capacity)(32, 96, 1)
    tick = streams.tick()
    jsvc.ingest(streams.deltas(jtypes.GraphDelta, tick, SP_K, SP_J))
    tsvc.ingest(streams.deltas(ttypes.GraphDelta, tick, SP_K, SP_J))
    jsvc.poll()
    tsvc.poll()
    _check_tick(jsvc, tsvc, "after the restore")


@pytest.mark.parametrize("ingestion", INGESTIONS)
def test_sparse_round_trip_in_the_port_is_bit_equal(ingestion, tmp_path):
    streams = VirtualStreams(SP_B, N_VIRTUAL, seed=11)
    svc = FingerService.open(
        _config(tserving, ingestion=ingestion,
                checkpoint=CheckpointPolicy(str(tmp_path))),
        (streams.edge_list(ttypes.EdgeList, s) for s in range(SP_B)),
        device="cpu")
    tick = streams.tick()
    svc.ingest(streams.deltas(ttypes.GraphDelta, tick, SP_K, SP_J))
    svc.poll()
    svc.save()
    back = FingerService.restore(svc.config, device="cpu")
    assert [m.to_json() for m in back.slot_maps] == \
        [m.to_json() for m in svc.slot_maps]
    assert_bits_equal(state_bits(back), state_bits(svc))
    tick = streams.tick()
    for s in (svc, back):
        s.ingest(streams.deltas(ttypes.GraphDelta, tick, SP_K, SP_J))
        s.poll()
    np.testing.assert_array_equal(back.scores(), svc.scores())
    assert_bits_equal(state_bits(back), state_bits(svc))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_crosses_packages(writer, tmp_path):
    """One package saves at generation 0, then compacts and grows (the
    journal); the other restores at the final layout by walking the
    generation-0 checkpoint forward, and accepts a generation-0-stamped
    delta through the rebuilt grace table."""
    ws = weights(B, N0, seed=3)
    jsvc, tsvc = open_pair(
        ws, n_pad=16, k_pad=K_PAD, j_pad=J_PAD, exact_smax=True,
        checkpoint=CheckpointPolicy(str(tmp_path / "port")),
        jax_kw=dict(checkpoint=jserving.CheckpointPolicy(
            str(tmp_path / "jax"))))
    gen0 = tsvc.layout
    kw = dict(n_nodes=16, k_pad=K_PAD, j_pad=J_PAD)
    ingest_both(jsvc, tsvc, leave_tick(ws, 2), **kw)
    poll_both(jsvc, tsvc, "leave")
    live = jsvc if writer == "jax" else tsvc
    live.save()
    live.compact()
    live.repad(20)
    log_dir = str(tmp_path / writer)
    log = migrate.load_layout_log(log_dir)
    assert [(r["kind"], r["from_generation"], r["old_n_pad"],
             r["new_n_pad"]) for r in log] == \
        [("compact", 0, 16, N0 - 1), ("grow", 1, N0 - 1, 20)]
    if writer == "jax":
        other = FingerService.restore(
            tsvc.config.with_(n_pad=20), directory=log_dir, device="cpu")
        jref, tgot = jsvc, other
    else:
        other = jserving.FingerService.restore(
            jsvc.config.with_(n_pad=20), directory=log_dir)
        jref, tgot = other, tsvc
    assert tgot.layout.generation == jref.layout.generation == 2
    assert_state_close(tgot.states(), jref.states(), "walked forward")
    stamped = edge_tick(ws, np.random.default_rng(3),
                        [v for v in range(N0) if v != 2], k=2)
    ingest_both(jref, tgot, stamped, n_nodes=16, k_pad=K_PAD, j_pad=J_PAD,
                layout=gen0)
    poll_both(jref, tgot, "a generation-0 delta after the walk")


def test_stream_engine_checkpoints_cross_packages(tmp_path):
    ws = weights(B, N0, seed=4)
    jst = jengine.StreamEngine.init_states(
        [jtypes.DenseGraph.from_weights(jnp.asarray(w)) for w in ws],
        n_pad=N_PAD)
    tst = state_to_port(jst)
    jeng = jengine.StreamEngine(method="fused_tick")
    teng = StreamEngine(method="fused_tick", device="cpu")
    jeng.save(str(tmp_path / "j"), jst, step=3)
    got, step = teng.restore(str(tmp_path / "j"))
    assert step == 3
    assert_state_close(got, jst, "JAX → port")
    teng.save(str(tmp_path / "t"), tst, step=5)
    back, step = jeng.restore(str(tmp_path / "t"))
    assert step == 5
    assert_state_close(tst, back, "port → JAX")
    with pytest.raises(ValueError, match="method"):
        StreamEngine(method="dense", device="cpu").restore(
            str(tmp_path / "j"))


def _hand_off(slot_map_cls, src, dst, slot_from, slot_to, sparse):
    """Move stream ``slot_from`` of ``src`` into ``slot_to`` of ``dst``
    (a sparse stream with a rebuilt `SlotMap`) and free its slot."""
    row = src.extract_stream(slot_from)
    if sparse:
        sm = slot_map_cls.from_json(src.slot_maps[slot_from].to_json())
        dst.install_stream(slot_to, row, slot_map=sm)
    else:
        dst.install_stream(slot_to, row)
    src.clear_stream(slot_from)
    return row


def test_dense_stream_hand_off_matches_the_reference():
    """extract_stream → install_stream → clear_stream between two
    services in each package, then a tick on both."""
    ws_a, ws_b = weights(B, N0, seed=5), weights(B, N0, seed=6)
    cfg = dict(n_pad=N_PAD, k_pad=K_PAD, j_pad=J_PAD, exact_smax=True,
               method="fused_tick")
    ja, ta = open_pair(ws_a, **cfg)
    jb, tb = open_pair(ws_b, **cfg)
    rng = np.random.default_rng(5)
    ingest_both(ja, ta, edge_tick(ws_a, rng, N0, k=2), **KW)
    with pytest.raises(tserving.ServiceLifecycleError, match="pending"):
        ta.extract_stream(1)
    poll_both(ja, ta, "a")
    row = _hand_off(SlotMap, ta, tb, 1, 2, sparse=False)
    _hand_off(JSlotMap, ja, jb, 1, 2, sparse=False)
    kept = {k: v.clone() for k, v in row.tensors().items()}
    assert_state_close(tb.states(), jb.states(), "installed")
    assert_state_close(ta.states(), ja.states(), "cleared")
    assert float(ta.states().node_mask[1].sum()) == 0.0
    ws_b[2] = ws_a[1].copy()
    ws_a[1][:] = 0.0
    ingest_both(jb, tb, edge_tick(ws_b, rng, N0, k=2), **KW)
    poll_both(jb, tb, "b after the hand-off")
    for k, v in row.tensors().items():  # a copy: the tick left it alone
        assert (v == kept[k]).all(), k
    with pytest.raises(migrate.LayoutMigrationError, match="layout"):
        tb.install_stream(0, dataclasses.replace(row,
                                                 layout=NodeLayout(32)))


def test_sparse_stream_hand_off_matches_the_reference():
    sa = VirtualStreams(SP_B, N_VIRTUAL, seed=7)
    sb = VirtualStreams(SP_B, N_VIRTUAL, seed=8)
    ja, ta = _open_pair(sa)
    jb, tb = _open_pair(sb)
    _hand_off(SlotMap, ta, tb, 0, 3, sparse=True)
    _hand_off(JSlotMap, ja, jb, 0, 3, sparse=True)
    for j, t in ((ja, ta), (jb, tb)):
        assert [m.to_json() for m in t.slot_maps] == \
            [m.to_json() for m in j.slot_maps]
    with pytest.raises(tserving.ServiceConfigError, match="SlotMap"):
        tb.install_stream(1, ta.extract_stream(1))


@pytest.mark.parametrize("ingestion", INGESTIONS)
def test_every_ticks_saves_from_poll(ingestion, tmp_path):
    ws, jsvc, tsvc = _dense_pair(tmp_path, ingestion=ingestion, seed=12,
                                 every_ticks=2, prune=2)
    rng = np.random.default_rng(12)
    snaps = {}
    for t in range(5):
        ingest_both(jsvc, tsvc, edge_tick(ws, rng, N0, k=2), **KW)
        poll_both(jsvc, tsvc, f"tick {t}")
        snaps[tsvc.step] = state_bits(tsvc)
    for d in ("port", "jax"):
        assert sorted(os.listdir(tmp_path / d)) == \
            ["step_00000002", "step_00000004"]
    back = FingerService.restore(tsvc.config, device="cpu")
    assert back.step == 4
    assert_bits_equal(state_bits(back), snaps[4])
    jback = jserving.FingerService.restore(
        jsvc.config.with_(checkpoint=jserving.CheckpointPolicy(
            str(tmp_path / "port"))))
    assert_state_close(back.states(), jback.states(), "the JAX restore")
