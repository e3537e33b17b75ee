"""The port's sharded and multipod serving placements on CPU grids.

`FingerService` with ``placement="sharded"`` over grids of 2 and 4 CPU
shards and ``placement="multipod"`` over 2 × 2 is held two ways:

- **bit-equal to the port's local placement** (`LocalPlan`) fed the
  same graphs and deltas: scores, the gathered state, top-k values and
  ids, `SlotMap` JSON, checkpoints. Streams are independent and each
  shard runs the same per-stream tick, so nothing may differ.
- **within 1e-5 of the JAX service with the local placement** fed the
  same numpy graphs, deltas or checkpoint (scores as divergences where
  those are below 1e-3, as `test_torch_serving_lifecycle.assert_scores`
  says; masks, top-k ids and `SlotMap` JSON exactly). The reference's
  own sharded double-buffered service is red on the CPU
  (`tests/test_serving_smoke.py`; ROADMAP Queue 3), so it is no oracle
  here.

This holds for all four methods under both ingestions, through the
migrations (repad, compact, the warm swap, a queued tick across each),
the stream hand-off between two sharded services, and checkpoints
crossing both ways between a sharded port service and a local JAX one.
Top-k and per-pod top-k are checked on planted ties, and the named
errors against the reference's texts. The engine's `shard_states` /
`make_sharded_tick` / `restore(grid=)` and the `DeviceGrid` shard order
are checked on their own.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.graphs.types as jtypes
import repro.serving as jserving
import repro_torch.serving as tserving
from repro_torch.distributed import (DeviceGrid, Sharded, concat_rows,
                                     make_grid, shard_index)
from repro_torch.engine import StreamEngine, stack_deltas
from repro_torch.graphs import types as ttypes
from repro_torch.graphs.layout import NodeLayout
from repro_torch.serving import (FingerService, ServiceConfig,
                                 ServiceConfigError, TopKSpec)
from _torch_parity import assert_state_close
from test_torch_serving_lifecycle import (INGESTIONS, assert_bits_equal,
                                          assert_scores, deltas, edge_tick,
                                          leave_tick, weights)
from test_torch_sparse import VirtualStreams, assert_sparse_state_close

B, N0, N_PAD, K_PAD, J_PAD, K_TOP = 8, 10, 12, 10, 2, 2
KW = dict(n_nodes=N_PAD, k_pad=K_PAD, j_pad=J_PAD)
SP_VIRTUAL, SP_K, SP_J = 512, 24, 4
GRIDS = {
    "sharded2": ("sharded", (2,), ("data",)),
    "sharded4": ("sharded", (4,), ("data",)),
    "multipod2x2": ("multipod", (2, 2), ("pod", "data")),
}
METHODS = ("dense", "compact", "fused_tick")


def _grid(name):
    _, shape, names = GRIDS[name]
    return make_grid(shape, names, "cpu")


def _bits(svc, scores=True):
    """The service's whole state (gathered from its shards) and scores
    as numpy arrays."""
    st = svc.plan.gather(svc.states())
    out = {k: v.numpy().copy() for k, v in st.tensors().items()}
    if scores:
        out["scores"] = svc.scores()
    return out


class Group:
    """The JAX service (local placement, the oracle), the port's local
    service and its sharded ones over every grid of `GRIDS`, driven
    together."""

    def __init__(self, jsvc, cfg, open_fn):
        self.jsvc = jsvc
        self.svcs = {"local": open_fn(cfg, device="cpu")}
        for name, (placement, _, _) in GRIDS.items():
            self.svcs[name] = open_fn(cfg.with_(placement=placement),
                                      grid=_grid(name))

    @classmethod
    def dense(cls, ws, method, ingestion, **kw):
        base = dict(batch_size=len(ws), n_pad=N_PAD, k_pad=K_PAD,
                    j_pad=J_PAD, method=method, exact_smax=True)
        base.update(kw)
        jsvc = jserving.FingerService.open(
            jserving.ServiceConfig(ingestion="sync",
                                   topk=jserving.TopKSpec(k=K_TOP), **base),
            [jtypes.DenseGraph.from_weights(jnp.asarray(w)) for w in ws])
        cfg = ServiceConfig(ingestion=ingestion, topk=TopKSpec(k=K_TOP),
                            **base)
        return cls(jsvc, cfg, lambda c, **where: FingerService.open(
            c, [ttypes.DenseGraph.from_weights(w) for w in ws], **where))

    @classmethod
    def sparse(cls, streams, ingestion):
        base = dict(batch_size=streams.b, n_pad=SP_VIRTUAL, k_pad=SP_K,
                    j_pad=SP_J, method="sparse_tick", n_slots=24,
                    m_pad=96, exact_smax=True)
        jsvc = jserving.FingerService.open(
            jserving.ServiceConfig(ingestion="sync",
                                   topk=jserving.TopKSpec(k=K_TOP), **base),
            [streams.edge_list(jtypes.EdgeList, s)
             for s in range(streams.b)])
        cfg = ServiceConfig(ingestion=ingestion, topk=TopKSpec(k=K_TOP),
                            **base)
        return cls(jsvc, cfg, lambda c, **where: FingerService.open(
            c, (streams.edge_list(ttypes.EdgeList, s)
                for s in range(streams.b)), **where))

    @property
    def ports(self):
        return list(self.svcs.values())

    def each(self, fn):
        return [fn(s) for s in self.ports]

    def ingest(self, jdeltas, tdeltas):
        self.jsvc.ingest(jdeltas)
        self.each(lambda s: s.ingest(tdeltas))

    def poll(self, label):
        assert self.jsvc.poll() is not None
        assert all(r is not None for r in self.each(lambda s: s.poll()))
        self.check(label)

    def check(self, label):
        """Every port service bit-equal to the local one (state, and
        after a tick scores, top-k and `score_at`); the local one close
        to the JAX service."""
        local = self.svcs["local"]
        ticked = local.step > 0
        want = _bits(local, scores=ticked)
        for name, svc in self.svcs.items():
            assert svc.step == local.step and svc.layout == local.layout
            assert_bits_equal(_bits(svc, scores=ticked), want,
                              f"{label}: {name}")
            if svc.slot_maps is not None:
                assert [m.to_json() for m in svc.slot_maps] == \
                    [m.to_json() for m in local.slot_maps], label
        j = self.jsvc
        if local.slot_maps is None:
            assert_state_close(local.states(), j.states(), label)
        else:
            assert_sparse_state_close(local.states(), j.states(), label)
            assert [m.to_json() for m in local.slot_maps] == \
                [m.to_json() for m in j.slot_maps], label
        if not ticked:
            return
        assert_scores(want["scores"], j.scores(), f"{label}: vs JAX")
        vals, ids = local.top_anomalies()
        for name, svc in self.svcs.items():
            v, i = svc.top_anomalies()
            np.testing.assert_array_equal(v, vals, f"{label}: {name}")
            np.testing.assert_array_equal(i, ids, f"{label}: {name}")
            assert svc.score_at(5) == float(want["scores"][5])
        jv, jids = j.top_anomalies()
        np.testing.assert_array_equal(ids, jids, f"{label}: top-k vs JAX")
        assert_scores(vals, jv, f"{label}: top-k values vs JAX")


def join_tick(ws, node):
    """Every stream joins ``node`` with an edge to node 0."""
    out = []
    for w in ws:
        w[0, node] = w[node, 0] = 0.75
        out.append(((np.array([0], np.int32), np.array([node], np.int32),
                     np.array([0.75], np.float32), np.zeros(1, np.float32)),
                    [node], []))
    return out


def feed(group, arrays, **kw):
    group.ingest(deltas(jtypes.GraphDelta, arrays, **dict(KW, **kw)),
                 deltas(ttypes.GraphDelta, arrays, **dict(KW, **kw)))


@pytest.mark.parametrize("method", METHODS)
def test_dense_placements_match_local_and_jax(method):
    """Each ingestion's local, sharded (2, 4) and multipod (2 × 2)
    services against one JAX local service: edge changes, a join, a
    leave, two ticks queued before their polls."""
    ws0 = weights(B, N0, seed=1)
    for ingestion in INGESTIONS:
        # the host mirrors span the layout: node N0 joins later
        ws = [np.pad(w, (0, N_PAD - N0)) for w in ws0]
        rng = np.random.default_rng(1)
        g = Group.dense(ws0, method, ingestion)
        g.check("open")
        feed(g, edge_tick(ws, rng, N0, k=3))
        g.poll(f"{ingestion} tick 0")
        feed(g, join_tick(ws, N0))
        feed(g, edge_tick(ws, rng, list(range(N0 + 1)), k=2))
        g.poll(f"{ingestion} tick 1 (queued two)")
        g.poll(f"{ingestion} tick 2")
        feed(g, leave_tick(ws, 3))
        g.poll(f"{ingestion} tick 3 (a leave)")


@pytest.mark.parametrize("ingestion", INGESTIONS)
def test_sparse_placements_match_local_and_jax(ingestion):
    """The sparse path: per-stream virtual deltas, a `grow_capacity`
    with a tick queued, a virtual repad."""
    streams = VirtualStreams(B, SP_VIRTUAL, seed=21)
    g = Group.sparse(streams, ingestion)
    g.check("open")
    for t in range(3):
        n_virtual = SP_VIRTUAL if t < 2 else 2 * SP_VIRTUAL
        tick = streams.tick()
        g.ingest(streams.deltas(jtypes.GraphDelta, tick, SP_K, SP_J,
                                n_nodes=n_virtual),
                 streams.deltas(ttypes.GraphDelta, tick, SP_K, SP_J,
                                n_nodes=n_virtual))
        if t == 0:
            g.jsvc.grow_capacity(n_slots=32)
            g.each(lambda s: s.grow_capacity(n_slots=32))
        g.poll(f"tick {t}")
        if t == 1:
            g.jsvc.repad(2 * SP_VIRTUAL)
            g.each(lambda s: s.repad(2 * SP_VIRTUAL))
    assert all(s.capacity.n_slots == 32 for s in g.ports)


def _planted_scores(placement, grid, k):
    """B streams of one graph; streams 1, 2, 5 and 6 get one same
    delta (four tied scores across shards and pods), the rest an empty
    one (tied zeros)."""
    w = weights(1, N0, seed=3)[0]
    cfg = dict(batch_size=B, n_pad=N_PAD, k_pad=K_PAD, j_pad=J_PAD,
               method="fused_tick")
    arrays = [((np.array([0, 1], np.int32), np.array([5, 7], np.int32),
                np.array([0.5, 0.25], np.float32),
                np.array([w[0, 5], w[1, 7]], np.float32)), [], [])
              if b in (1, 2, 5, 6) else
              ((np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),) * 2,
               [], []) for b in range(B)]
    if placement == "jax":
        svc = jserving.FingerService.open(
            jserving.ServiceConfig(ingestion="sync",
                                   topk=jserving.TopKSpec(k=k), **cfg),
            [jtypes.DenseGraph.from_weights(jnp.asarray(w))] * B)
        svc.ingest(deltas(jtypes.GraphDelta, arrays, **KW))
    else:
        where = dict(device="cpu") if grid is None else dict(grid=grid)
        svc = FingerService.open(
            ServiceConfig(placement=placement, topk=TopKSpec(k=k), **cfg),
            [ttypes.DenseGraph.from_weights(w)] * B, **where)
        svc.ingest(deltas(ttypes.GraphDelta, arrays, **KW))
    svc.poll()
    return svc


def test_topk_and_per_pod_topk_on_planted_ties():
    jsvc = _planted_scores("jax", None, K_TOP)
    local = _planted_scores("local", None, K_TOP)
    mp = _planted_scores("multipod", _grid("multipod2x2"), K_TOP)
    sh = _planted_scores("sharded", _grid("sharded4"), K_TOP)
    scores = local.scores()
    assert (scores[[1, 2, 5, 6]] == scores[1]).all() and scores[1] > 0
    assert not scores[[0, 3, 4, 7]].any()
    jv, jids = jsvc.top_anomalies()
    for svc in (local, mp, sh):
        for k in (1, 2):
            v, ids = svc.top_anomalies(k)
            np.testing.assert_array_equal(ids, [1, 2][:k])
            np.testing.assert_array_equal(v, scores[[1, 2][:k]])
        np.testing.assert_array_equal(svc.top_anomalies()[1], jids)
        assert_scores(svc.top_anomalies()[0], jv, "top-k values vs JAX")
    # per pod: each pod's own streams, lower id first on ties; the pods'
    # ranges are [0, 4) and [4, 8)
    for k in (1, 2):
        v, ids = mp.top_anomalies(k, per_pod=True)
        assert v.shape == ids.shape == (2, k) and ids.dtype == np.int32
        for pod in range(2):
            lo = 4 * pod
            order = lo + np.argsort(-scores[lo:lo + 4], kind="stable")[:k]
            np.testing.assert_array_equal(ids[pod], order)
            np.testing.assert_array_equal(v[pod], scores[order])
    # a pod of zeros: ties broken by stream id inside the pod
    zeros = _planted_scores("multipod", _grid("multipod2x2"), K_TOP)
    zeros.ingest([ttypes.GraphDelta.from_arrays([], [], [], [], **KW)] * B)
    zeros.poll()
    np.testing.assert_array_equal(zeros.top_anomalies(2, per_pod=True)[1],
                                  [[0, 1], [4, 5]])
    want = raised_text(lambda: jsvc.top_anomalies(per_pod=True))
    assert raised_text(lambda: local.top_anomalies(per_pod=True)) == want
    assert raised_text(lambda: sh.top_anomalies(per_pod=True)) == \
        want.replace("'local'", "'sharded'")


def raised_text(fn):
    try:
        fn()
    except ServiceConfigError as exc:
        return str(exc)
    except jserving.ServiceConfigError as exc:
        return str(exc)
    raise AssertionError("no ServiceConfigError")


@pytest.mark.parametrize("ingestion", INGESTIONS)
def test_migrations_under_sharded_plans(ingestion):
    """repad with a tick queued (warm on every placement), a tail
    truncation, a compaction with a tick queued, and a generation-0
    stamped tick through the grace remap; the JAX service follows."""
    ws = weights(B, N0, seed=4)
    rng = np.random.default_rng(4)
    g = Group.dense(ws, "fused_tick", ingestion)
    feed(g, edge_tick(ws, rng, N0, k=2))
    g.poll("tick 0")
    warmed = g.each(lambda s: s.warm_next_layouts([20]))
    assert all(w == [20] for w in warmed)
    warm_plans = g.each(lambda s: id(s.plan_cache._plans[
        next(iter(s.plan_cache._plans))][0]))
    feed(g, edge_tick(ws, rng, N0, k=2))
    g.jsvc.repad(20)
    g.each(lambda s: s.repad(20))
    assert g.each(lambda s: id(s.plan)) == warm_plans
    assert all(s.plan.grid == _grid(n) for n, s in g.svcs.items()
               if n != "local")
    g.poll("after the repad (a tick queued)")
    feed(g, edge_tick(ws, rng, N0, k=2), n_nodes=20)
    g.poll("at n_pad 20")
    g.jsvc.repad(16)
    g.each(lambda s: s.repad(16))
    feed(g, edge_tick(ws, rng, N0, k=2), n_nodes=16)
    g.poll("after the truncation")
    feed(g, leave_tick(ws, 2), n_nodes=16)
    g.poll("node 2 left every stream")
    feed(g, edge_tick(ws, rng, [n for n in range(N0) if n != 2], k=2),
         n_nodes=16)
    jrep = g.jsvc.compact()
    reps = g.each(lambda s: s.compact())
    for rep in reps:
        np.testing.assert_array_equal(rep.index_map, np.asarray(jrep.index_map))
        assert rep.new_n_pad == jrep.new_n_pad == N0 - 1
    g.poll("after the compaction (a tick queued)")
    # a producer still on the generation-0 layout of N_PAD slots
    stamped = edge_tick(ws, rng, [n for n in range(N0) if n != 2], k=2)
    feed(g, stamped, layout=NodeLayout(N_PAD, generation=0))
    g.poll("a generation-0 stamped tick")


def test_stream_hand_off_between_sharded_services():
    """extract_stream on a multipod service → install_stream on a
    sharded one → clear_stream, each slot in another shard; the local
    and JAX services do the same, then a tick on all."""
    ws_a, ws_b = weights(B, N0, seed=5), weights(B, N0, seed=6)
    a = Group.dense(ws_a, "fused_tick", "double_buffered")
    b = Group.dense(ws_b, "fused_tick", "double_buffered")
    src, dst = 5, 2   # shard 2 of 4 → shard 1 of 4
    with_jax = [(a.jsvc, b.jsvc)] + [(a.svcs[n], b.svcs[n])
                                     for n in a.svcs]
    for sa, sb in with_jax:
        row = sa.extract_stream(src)
        sb.install_stream(dst, row)
        sa.clear_stream(src)
    a.check("cleared")
    b.check("installed")
    rows = {n: a.svcs[n].extract_stream(src) for n in a.svcs}
    assert all(not r.node_mask.any() for r in rows.values())
    ws_b[dst] = ws_a[src].copy()
    ws_a[src][:] = 0.0
    rng = np.random.default_rng(5)
    feed(b, edge_tick(ws_b, rng, N0, k=2))
    b.poll("b after the hand-off")
    with pytest.raises(tserving.ServiceLifecycleError, match="pending"):
        feed(a, edge_tick(ws_a, rng, N0, k=1))
        a.svcs["sharded4"].extract_stream(0)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_sharded_port_and_local_jax(writer, kind,
                                                      tmp_path):
    """A sharded (multipod 2 × 2) port service's checkpoint restores in
    the JAX local service and the JAX service's restores sharded in the
    port: the arrays bit-equal, then a tick on both within 1e-5."""
    grid = _grid("multipod2x2")
    d = str(tmp_path / "ck")
    if kind == "dense":
        ws = weights(B, N0, seed=7)
        rng = np.random.default_rng(7)
        g = Group.dense(ws, "fused_tick", "double_buffered")

        def tick():
            arrays = edge_tick(ws, rng, N0, k=2)
            return (deltas(jtypes.GraphDelta, arrays, **KW),
                    deltas(ttypes.GraphDelta, arrays, **KW))
    else:
        streams = VirtualStreams(B, SP_VIRTUAL, seed=8)
        g = Group.sparse(streams, "double_buffered")

        def tick():
            t = streams.tick()
            return (streams.deltas(jtypes.GraphDelta, t, SP_K, SP_J),
                    streams.deltas(ttypes.GraphDelta, t, SP_K, SP_J))
    g.ingest(*tick())
    g.poll("tick 0")
    jsvc, port = g.jsvc, g.svcs["multipod2x2"]
    if writer == "port":
        port.save(d)
        jsvc = jserving.FingerService.restore(jsvc.config, directory=d)
    else:
        jsvc.save(d)
        port = FingerService.restore(port.config, directory=d, grid=grid)
        assert isinstance(port.states(), Sharded)
        assert port.states().num_shards == 4
    assert port.step == jsvc.step == 1
    got = _bits(port, scores=False)
    st = jsvc.states()
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(st, k)), k)
    jd, td = tick()
    jsvc.ingest(jd)
    port.ingest(td)
    jsvc.poll()
    port.poll()
    assert_scores(port.scores(), jsvc.scores(), "after the restore")
    if kind == "dense":
        assert_state_close(port.plan.gather(port.states()), jsvc.states())
    else:
        assert_sparse_state_close(port.plan.gather(port.states()),
                                  jsvc.states())
        assert [m.to_json() for m in port.slot_maps] == \
            [m.to_json() for m in jsvc.slot_maps]


@pytest.mark.parametrize("kw, shards", [
    (dict(batch_size=6), 4),
    (dict(topk=3), 4),
    (dict(topk=5), 2),
])
def test_error_texts_match_the_reference(kw, shards):
    """batch_size % shards and k > B/shards: the reference's texts."""
    fields = dict(batch_size=B, n_pad=N_PAD, k_pad=K_PAD, j_pad=J_PAD,
                  placement="sharded")
    fields.update({k: v for k, v in kw.items() if k != "topk"})
    k = kw.get("topk", K_TOP)
    jcfg = jserving.ServiceConfig(topk=jserving.TopKSpec(k=k), **fields)
    want = raised_text(lambda: jcfg.validate(num_shards=shards))
    cfg = ServiceConfig(topk=TopKSpec(k=k), **fields)
    graphs = [ttypes.DenseGraph.from_weights(w)
              for w in weights(fields["batch_size"], N0, seed=0)]
    got = raised_text(lambda: FingerService.open(
        cfg, graphs, grid=make_grid((shards,), ("data",), "cpu")))
    assert got == want


def test_config_and_grid_errors():
    fields = dict(batch_size=B, n_pad=N_PAD, k_pad=K_PAD)
    for mod in (jserving, tserving):
        with pytest.raises(mod.ServiceConfigError,
                           match="distinct pod/data axes"):
            mod.ServiceConfig(placement="multipod", pod_axis="data",
                              **fields).validate()
    cfg = ServiceConfig(**fields)
    graphs = [ttypes.DenseGraph.from_weights(w)
              for w in weights(B, N0, seed=0)]
    with pytest.raises(ServiceConfigError, match="takes no grid"):
        FingerService.open(cfg, graphs, grid=_grid("sharded2"))
    with pytest.raises(ServiceConfigError, match="carry no 'pod' axis"):
        FingerService.open(cfg.with_(placement="multipod"), graphs,
                           grid=_grid("sharded2"))
    with pytest.raises(ServiceConfigError, match="not both"):
        FingerService.open(cfg.with_(placement="sharded"), graphs,
                           device="cpu", grid=_grid("sharded2"))
    svc = FingerService.open(cfg.with_(placement="sharded"), graphs,
                             device="cpu")
    assert svc.plan.num_shards == 1 and svc.plan.grid.shape == {"data": 1}
    svc.ingest([ttypes.GraphDelta.from_arrays([], [], [], [],
                                              n_nodes=N_PAD, k_pad=K_PAD)]
               * B)
    svc.poll()
    with pytest.raises(ServiceConfigError, match="shrink k or re-open"):
        _planted_scores("sharded", _grid("sharded4"), 2).top_anomalies(3)


def test_device_grid_orders_shards_by_mixed_radix():
    devs = [torch.device("cpu")] * 6
    grid = DeviceGrid(np.array(devs, dtype=object).reshape(2, 3),
                      ("pod", "data"))
    assert grid.shape == {"pod": 2, "data": 3} and grid.size == 6
    assert len(grid.shard_devices(("pod", "data"))) == 6
    assert len(grid.shard_devices("data")) == 3
    assert len(grid.shard_devices("pod")) == 2
    assert [shard_index((p, d), (2, 3)) for p in range(2)
            for d in range(3)] == list(range(6))
    assert make_grid((2, 3), ("pod", "data"), "cpu") == grid
    assert hash(make_grid((2, 3), ("pod", "data"), "cpu")) == hash(grid)
    assert make_grid((3, 2), ("pod", "data"), "cpu") != grid
    with pytest.raises(ValueError, match="needs 4 device"):
        make_grid((2, 2), ("pod", "data"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="axis name"):
        make_grid((2,), ("a", "b"), "cpu")
    with pytest.raises(KeyError, match="carry no"):
        grid.shard_devices("model")


def test_engine_sharded_tick_and_restore(tmp_path):
    """`StreamEngine.shard_states` + `make_sharded_tick` over a 2 × 2
    grid (sharding both axes, and only "data") bit-equal to the local
    tick; `restore(grid=)` comes back sharded and bit-equal."""
    ws = weights(B, N0, seed=9)
    eng = StreamEngine(exact_smax=True, method="fused_tick", device="cpu")
    states = StreamEngine.init_states(
        [ttypes.DenseGraph.from_weights(w) for w in ws], n_pad=N_PAD,
        device="cpu")
    rng = np.random.default_rng(9)
    delta = stack_deltas(deltas(ttypes.GraphDelta,
                                edge_tick(ws, rng, N0, k=3), **KW))
    grid = _grid("multipod2x2")
    for axis, p in ((("pod", "data"), 4), ("data", 2)):
        sh = eng.shard_states(states.map_tensors(torch.clone), grid, axis)
        assert sh.num_shards == p and sh.rows == B // p
        d_sh, st_sh = eng.make_sharded_tick(grid, axis)(sh, delta)
        d_loc, st_loc = eng.tick(states.map_tensors(torch.clone), delta)
        assert torch.equal(concat_rows(d_sh), d_loc)
        for k, v in concat_rows(st_sh).tensors().items():
            assert torch.equal(v, st_loc.tensors()[k]), k
    eng.save(str(tmp_path), states, step=4)
    back, step = eng.restore(str(tmp_path), grid=grid, axis=("pod", "data"))
    assert step == 4 and isinstance(back, Sharded) and back.num_shards == 4
    for k, v in concat_rows(back).tensors().items():
        assert torch.equal(v, states.tensors()[k]), k
    with pytest.raises(ValueError, match="do not split"):
        eng.shard_states(states, make_grid((3,), ("data",), "cpu"))


def test_plan_cache_keys_on_the_grid():
    cfg = ServiceConfig(batch_size=B, n_pad=N_PAD, k_pad=K_PAD,
                        method="fused_tick", placement="sharded",
                        topk=TopKSpec(k=1))
    cache = tserving.PlanCache()
    layout = NodeLayout(N_PAD)
    warm = cache.warm(cfg, _grid("sharded4"), layout)
    assert isinstance(warm, tserving.ShardedPlan) and len(cache) == 1
    assert cache.get(cfg, _grid("sharded2")) is not warm  # another grid
    assert len(cache) == 1
    assert cache.get(cfg, _grid("sharded4")) is warm
    assert len(cache) == 0
    assert cache.get(cfg, _grid("sharded4")) is not warm  # popped
