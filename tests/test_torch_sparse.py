"""The port's sparse slot-space path against the JAX reference, on the
CPU: `SparseLayout`, `SparseStreamState`, construction from graphs,
`SlotMap` translation and persistence, the named errors, and the sparse
tick.

Inputs are made with numpy from fixed seeds and fed to both packages.
Scores and carried state are compared at atol 1e-5 with rtol 1e-5 (the
reference's kernel parity tolerance); masks, slot ids, translated
deltas and `SlotMap.to_json` exactly; error types and texts exactly. On
CPU tensors `sparse_tick_fused` runs its plain version. The reference's
`test_property_sparse_matches_dense_join_leave` draws random seeds and
fails on some (ROADMAP Queue 3); these tests use fixed seeds, hold the
port to the reference's plain `sparse_tick_ref` and `sparse_jsdist_tick`,
and run the Pallas kernel in interpret mode on one small case only.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.sparse as jsp
import repro.graphs.types as jtypes
from repro.engine import stack_deltas as j_stack_deltas
from repro.graphs.generators import erdos_renyi as j_erdos_renyi
from repro.kernels.sparse_tick import ops as jops
from repro.kernels.sparse_tick.parity import _shard_fixture
from repro.kernels.sparse_tick.ref import sparse_tick_ref as j_tick_ref
import repro_torch.core.sparse as tsp
from repro_torch import interop
from repro_torch.engine import stack_deltas
from repro_torch.graphs import types as ttypes
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.kernels.sparse_tick import ops as tops
from repro_torch.kernels.sparse_tick import parity
from repro_torch.kernels.stream_tick.ref import stream_tick_ref
from _torch_parity import ATOL, RTOL, assert_close, np_arrays


# -- helpers shared with test_torch_sparse_serving.py ---------------------

def raised(fn):
    """(exception type name, message) of what ``fn`` raises, so that the
    errors of the two packages can be compared."""
    try:
        fn()
    except Exception as exc:  # any error: the caller compares them
        return type(exc).__name__, str(exc)
    raise AssertionError("no exception raised")


SPARSE_FIELDS = ("q", "s_total", "s_max", "strengths", "node_mask",
                 "edge_weights")


def sparse_state_to_port(jst, device="cpu"):
    """A JAX SparseStreamState (single or stacked) → the port's."""
    lay = jst.layout
    return interop.sparse_state_from_numpy(
        np_arrays(jst, SPARSE_FIELDS),
        (lay.n_slots, lay.m_pad, lay.generation), device=device)


def sparse_state_to_jax(tst):
    """The port's SparseStreamState → a JAX one."""
    arrays, lay = interop.sparse_state_to_numpy(tst)
    return jsp.SparseStreamState(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        layout=jsp.SparseLayout(*lay))


def assert_sparse_state_close(port_state, jax_state, label=""):
    got, lay = interop.sparse_state_to_numpy(port_state)
    for f in SPARSE_FIELDS:
        want = np.asarray(getattr(jax_state, f))
        if f == "node_mask":
            np.testing.assert_array_equal(got[f], want,
                                          err_msg=f"{label}: {f}")
        else:
            np.testing.assert_allclose(got[f], want, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{label}: {f}")
    jl = jax_state.layout
    assert lay == (jl.n_slots, jl.m_pad, jl.generation), label


def sparse_delta_to_port(jd):
    """A JAX slot-space GraphDelta (single or stacked) → the port's, on
    the CPU, edge slots kept."""
    arrays = np_arrays(jd, ("senders", "receivers", "dw", "w_old", "mask",
                            "node_ids", "node_flag", "edge_slots"))
    return interop.delta_from_numpy(arrays, jd.n_nodes, device="cpu",
                                    layout_generation=jd.layout_generation)


def sparse_delta_to_jax(td):
    """The port's slot-space GraphDelta → a JAX one (edge slots kept)."""
    arrays = interop.delta_to_numpy(td)
    return jtypes.GraphDelta(
        **{k: jnp.asarray(v) for k, v in arrays.items()},
        n_nodes=td.n_nodes, layout_generation=td.layout_generation)


class VirtualStreams:
    """B tenants, each a small graph inside one large virtual id space,
    emitting the same deltas to both packages as numpy arrays.

    Stream s starts with ``n0`` active nodes at random virtual ids and a
    reserve of fresh ids. Each tick mixes re-weights, additions (a new
    edge slot), deletions to 0 (a freed slot), a join of a fresh id with
    its first edges, a leave of a joined node together with the deletion
    of its edges (the isolated-leave contract), a lane touching an
    inactive id (dropped), a re-join of an active node and a leave of an
    inactive one. ``w`` mirrors every live edge weight, so each w_old is
    exact.
    """

    def __init__(self, b, n_virtual, seed, n0=(6, 14), reserve=4,
                 k=6):
        self.rng = np.random.default_rng(seed)
        self.b, self.n_virtual, self.k = b, n_virtual, k
        self.active, self.reserve, self.joined, self.w = [], [], [], []
        for _ in range(b):
            n = int(self.rng.integers(*n0))
            ids = self.rng.choice(n_virtual, n + reserve, replace=False)
            act = sorted(int(i) for i in ids[:n])
            w = {}
            for a in range(n):
                for c in range(a + 1, n):
                    if self.rng.random() < 0.35:
                        w[(act[a], act[c])] = np.float32(
                            self.rng.uniform(0.5, 1.5))
            self.active.append(act)
            self.reserve.append([int(i) for i in ids[n:]])
            self.joined.append([])
            self.w.append(w)

    def graph_arrays(self, s):
        """(senders, receivers, weights, node_mask) of stream s now."""
        keys = sorted(self.w[s])
        mask = np.zeros(self.n_virtual, np.float32)
        mask[self.active[s]] = 1.0
        return (np.array([a for a, _ in keys], np.int32),
                np.array([c for _, c in keys], np.int32),
                np.array([self.w[s][key] for key in keys], np.float32),
                mask)

    def edge_list(self, cls, s, **kw):
        snd, rcv, wts, mask = self.graph_arrays(s)
        if cls.__module__.startswith("repro_torch"):
            import torch
            mask = torch.from_numpy(mask)
        else:
            mask = jnp.asarray(mask)
        return cls.from_arrays(snd, rcv, wts, n_nodes=self.n_virtual,
                               m_pad=max(len(snd), 1) + 2,
                               node_mask=mask, **kw)

    def tick(self):
        """Per stream (senders, receivers, dw, w_old, join, leave)."""
        out = []
        for s in range(self.b):
            rng, act, w = self.rng, self.active[s], self.w[s]
            join, leave, lanes = [], [], {}
            if self.reserve[s] and rng.random() < 0.5:
                v = self.reserve[s].pop()
                join.append(v)
                for u in rng.choice(act, 2, replace=False):
                    lanes[(min(v, int(u)), max(v, int(u)))] = None
            elif self.joined[s] and rng.random() < 0.6:
                v = self.joined[s].pop()
                leave.append(v)
                for key in w:
                    if v in key:
                        lanes[key] = None
            while len(lanes) < self.k:
                a, c = sorted(int(x) for x in rng.choice(act, 2,
                                                         replace=False))
                lanes[(a, c)] = None
            if self.reserve[s] and rng.random() < 0.5:
                # touches an inactive id: dropped / gated to zero
                lanes[(min(act[0], self.reserve[s][0]),
                       max(act[0], self.reserve[s][0]))] = None
            if rng.random() < 0.3:
                join.append(act[int(rng.integers(len(act)))])  # re-join
            if self.reserve[s] and rng.random() < 0.3:
                leave.append(self.reserve[s][-1])  # leave of an inactive
            live_after_join = set(act) | set(join)
            ii, jj, dw, wo = [], [], [], []
            for (a, c) in lanes:
                old = w.get((a, c), np.float32(0.0))
                if leave and (a in leave or c in leave) or \
                        (old > 0 and rng.random() < 0.3):
                    d = -old
                elif old > 0:
                    d = np.float32(old * rng.uniform(-0.2, 0.2))
                else:
                    d = np.float32(rng.uniform(0.3, 1.5))
                ii.append(a)
                jj.append(c)
                dw.append(d)
                wo.append(old)
                if a in live_after_join and c in live_after_join:
                    new = np.float32(old + np.float32(d))
                    if new > 0:
                        w[(a, c)] = new
                    else:
                        w.pop((a, c), None)
            for v in join:
                if v not in act:
                    act.append(v)
                    act.sort()
                    self.joined[s].append(v)
            for v in leave:
                if v in act:
                    act.remove(v)
            out.append((np.array(ii, np.int32), np.array(jj, np.int32),
                        np.array(dw, np.float32), np.array(wo, np.float32),
                        join, leave))
        return out

    def deltas(self, cls, tick, k_pad, j_pad, n_nodes=None):
        """One tick's per-stream deltas in package ``cls``'s types."""
        return [cls.from_arrays(
            ii, jj, dw, wo, n_nodes=n_nodes or self.n_virtual,
            k_pad=k_pad, join=join, leave=leave, j_pad=j_pad)
            for ii, jj, dw, wo, join, leave in tick]




def _same_error(jfn, tfn):
    jerr, terr = raised(jfn), raised(tfn)
    assert terr == jerr


# -- SparseLayout and SparseStreamState ----------------------------------

@pytest.mark.parametrize("args", [(0, 8), (8, 0), (8, 8, -1), (-1, 4)])
def test_layout_validation_matches_reference(args):
    _same_error(lambda: jsp.SparseLayout(*args),
                lambda: tsp.SparseLayout(*args))


@pytest.mark.parametrize("grow", [dict(n_slots=32), dict(m_pad=64),
                                  dict(n_slots=24, m_pad=40),
                                  dict(n_slots=8), dict(), dict(m_pad=16)])
def test_layout_grown_matches_reference(grow):
    jl, tl = jsp.SparseLayout(16, 32, 2), tsp.SparseLayout(16, 32, 2)
    try:
        want = jl.grown(**grow)
    except ValueError:
        _same_error(lambda: jl.grown(**grow), lambda: tl.grown(**grow))
        return
    got = tl.grown(**grow)
    assert (got.n_slots, got.m_pad, got.generation) == \
        (want.n_slots, want.m_pad, want.generation)


def test_stream_state_matches_reference():
    g = j_erdos_renyi(20, 0.3, seed=4, weighted=True)
    js, _ = jsp.sparse_state_from_graph(g, jsp.SparseLayout(24, 96),
                                        n_virtual=64)
    ts = sparse_state_to_port(js)
    assert (ts.n_slots, ts.m_pad) == (js.n_slots, js.m_pad) == (24, 96)
    assert int(ts.n_active()) == int(js.n_active())
    assert_close(ts.h_tilde(), js.h_tilde(), "h_tilde")
    view = ts.dense_view()
    assert view.layout is None and view.node_mask is ts.node_mask
    moved = ts.to("cpu")
    assert moved.layout == ts.layout
    assert_sparse_state_close(moved, js, "to")
    back = sparse_state_to_jax(ts)
    assert_sparse_state_close(sparse_state_to_port(back), js, "round trip")


# -- construction from graphs ----------------------------------------------

def _graph_pair(kind, seed):
    """The same host graph in both packages."""
    rng = np.random.default_rng(seed)
    n = 30
    mask = (rng.random(n) < 0.75).astype(np.float32)
    if kind in ("dense", "dense_masked"):
        w = rng.uniform(0.5, 1.5, (n, n)) * (rng.random((n, n)) < 0.3)
        w = np.triu(w, 1).astype(np.float32)
        w = w + w.T
        kw = ({} if kind == "dense" else dict(node_mask=mask))
        return (jtypes.DenseGraph.from_weights(
                    jnp.asarray(w), **{k: jnp.asarray(v)
                                       for k, v in kw.items()}),
                ttypes.DenseGraph.from_weights(
                    w, **{k: torch.from_numpy(v) for k, v in kw.items()}))
    s = rng.integers(0, n, 60).astype(np.int32)
    r = rng.integers(0, n, 60).astype(np.int32)
    w = rng.uniform(0.5, 1.5, 60).astype(np.float32)
    if kind == "edges":
        r = np.where(r == s, (s + 1) % n, r).astype(np.int32)
        return (jtypes.EdgeList.from_arrays(s, r, w, n_nodes=n, m_pad=64),
                ttypes.EdgeList.from_arrays(s, r, w, n_nodes=n, m_pad=64))
    # raw: both orientations, duplicate lanes, self-loops, a masked lane
    s2 = np.r_[r[:10], s].astype(np.int32)
    r2 = np.r_[s[:10], r].astype(np.int32)
    w2 = np.r_[w[:10], w].astype(np.float32)
    lane = np.ones(70, np.float32)
    lane[5] = 0.0
    return (jtypes.EdgeList(
                senders=jnp.asarray(s2), receivers=jnp.asarray(r2),
                weights=jnp.asarray(w2), mask=jnp.asarray(lane),
                n_nodes=n, node_mask=jnp.asarray(mask)),
            ttypes.EdgeList(
                senders=torch.from_numpy(s2), receivers=torch.from_numpy(r2),
                weights=torch.from_numpy(w2), mask=torch.from_numpy(lane),
                n_nodes=n, node_mask=torch.from_numpy(mask)))


@pytest.mark.parametrize("kind", ["dense", "dense_masked", "edges",
                                  "raw_edges_masked"])
def test_state_from_graph_matches_reference(kind):
    jg, tg = _graph_pair(kind, seed=len(kind))
    js, jm = jsp.sparse_state_from_graph(jg, jsp.SparseLayout(32, 400),
                                         n_virtual=50, stream=3)
    ts, tm = tsp.sparse_state_from_graph(tg, tsp.SparseLayout(32, 400),
                                         n_virtual=50, stream=3)
    assert_sparse_state_close(ts, js, kind)
    assert tm.to_json() == jm.to_json()
    assert json.dumps(tm.to_json()) == json.dumps(jm.to_json())


def test_states_from_graphs_matches_reference_and_takes_a_generator():
    """Mixed sizes, a dead graph (no active node) and graphs addressed
    in a virtual space far above their node counts; the port consumes a
    generator."""
    sizes = (5, 12, 9, 16)
    jgraphs = [jtypes.DenseGraph.from_weights(
        jnp.zeros((4, 4)), node_mask=jnp.zeros(4))] + [
        j_erdos_renyi(n, 0.4, seed=n, weighted=True) for n in sizes]
    tgraphs = (g for g in [ttypes.DenseGraph.from_weights(
        torch.zeros((4, 4)), node_mask=torch.zeros(4))] + [
        erdos_renyi(n, 0.4, seed=n, weighted=True) for n in sizes])
    js, jmaps = jsp.sparse_states_from_graphs(
        jgraphs, jsp.SparseLayout(20, 64), n_virtual=4096)
    ts, tmaps = tsp.sparse_states_from_graphs(
        tgraphs, tsp.SparseLayout(20, 64), n_virtual=4096)
    assert_sparse_state_close(ts, js, "stacked")
    assert [m.to_json() for m in tmaps] == [m.to_json() for m in jmaps]


# -- SlotMap translation -----------------------------------------------------

def _translated_equal(td, jd, label):
    arrays = interop.delta_to_numpy(td)
    for f in ("senders", "receivers", "dw", "w_old", "mask", "node_ids",
              "node_flag", "edge_slots"):
        want = getattr(jd, f)
        if want is None:
            assert f not in arrays, (label, f)
            continue
        np.testing.assert_array_equal(arrays[f], np.asarray(want),
                                      err_msg=f"{label}: {f}")
        assert arrays[f].dtype == np.asarray(want).dtype, (label, f)
    assert td.n_nodes == jd.n_nodes, label


def test_slot_map_sequence_matches_reference():
    """A randomized virtual delta sequence through both packages' maps:
    translated deltas equal, `to_json` equal after every tick. Tick 4
    also leaves a node that still has live edges, whose release order
    the free list records."""
    streams = VirtualStreams(4, 500, seed=11)
    layout = (24, 120)
    jmaps, tmaps = [], []
    for s in range(4):
        _, jm = jsp.sparse_state_from_graph(
            streams.edge_list(jtypes.EdgeList, s),
            jsp.SparseLayout(*layout), n_virtual=500, stream=s)
        _, tm = tsp.sparse_state_from_graph(
            streams.edge_list(ttypes.EdgeList, s),
            tsp.SparseLayout(*layout), n_virtual=500, stream=s)
        jmaps.append(jm)
        tmaps.append(tm)
    for t in range(8):
        tick = streams.tick()
        if t == 4:
            ii, jj, dw, wo, join, leave = tick[0]
            busy = max(streams.active[0],
                       key=lambda v: sum(v in key for key in jmaps[0]
                                         .edge_slot))
            tick[0] = (ii, jj, dw, wo, join, leave + [busy])
            streams.active[0].remove(busy)
            for key in [key for key in streams.w[0] if busy in key]:
                streams.w[0].pop(key)
        jds = streams.deltas(jtypes.GraphDelta, tick, k_pad=24, j_pad=4)
        tds = streams.deltas(ttypes.GraphDelta, tick, k_pad=24, j_pad=4)
        for s in range(4):
            jd = jmaps[s].translate(jds[s])
            td = tmaps[s].translate(tds[s])
            _translated_equal(td, jd, f"tick {t} stream {s}")
            assert tmaps[s].to_json() == jmaps[s].to_json(), (t, s)
            assert (tmaps[s].n_free_nodes, tmaps[s].n_free_edges) == \
                (jmaps[s].n_free_nodes, jmaps[s].n_free_edges)


def test_slot_map_json_crosses_both_ways():
    """A JSON written by one package, loaded by the other, takes the
    next join at the same slot."""
    streams = VirtualStreams(1, 300, seed=5)
    _, jm = jsp.sparse_state_from_graph(
        streams.edge_list(jtypes.EdgeList, 0), jsp.SparseLayout(24, 64),
        n_virtual=300)
    _, tm = tsp.sparse_state_from_graph(
        streams.edge_list(ttypes.EdgeList, 0), tsp.SparseLayout(24, 64),
        n_virtual=300)
    for _ in range(3):  # churn the free lists
        tick = streams.tick()
        jm.translate(streams.deltas(jtypes.GraphDelta, tick, 16, 4)[0])
        tm.translate(streams.deltas(ttypes.GraphDelta, tick, 16, 4)[0])
    j_from_t = jsp.SlotMap.from_json(json.loads(json.dumps(tm.to_json())))
    t_from_j = tsp.SlotMap.from_json(json.loads(json.dumps(jm.to_json())))
    assert t_from_j.to_json() == j_from_t.to_json() == jm.to_json()
    fresh = [v for v in range(300) if v not in jm.node_slot][:2]
    join = dict(join=fresh, j_pad=4, k_pad=4, n_nodes=300)
    edge = ([fresh[0]], [fresh[1]], [0.7], [0.0])
    jd = j_from_t.translate(jtypes.GraphDelta.from_arrays(*edge, **join))
    td = t_from_j.translate(ttypes.GraphDelta.from_arrays(*edge, **join))
    _translated_equal(td, jd, "after round trip")
    assert t_from_j.to_json() == j_from_t.to_json()


def test_slot_map_grow_matches_reference():
    jm = jsp.SlotMap(jsp.SparseLayout(4, 6), n_virtual=50)
    tm = tsp.SlotMap(tsp.SparseLayout(4, 6), n_virtual=50)
    d = dict(n_nodes=50, k_pad=4, join=[3, 9, 12], j_pad=4)
    arrs = ([3, 9], [9, 12], [1.0, 0.5], [0.0, 0.0])
    jm.translate(jtypes.GraphDelta.from_arrays(*arrs, **d))
    tm.translate(ttypes.GraphDelta.from_arrays(*arrs, **d))
    jm.grow(jsp.SparseLayout(8, 10, 1))
    tm.grow(tsp.SparseLayout(8, 10, 1))
    jm.grow_virtual(80)
    tm.grow_virtual(80)
    assert tm.to_json() == jm.to_json()
    _same_error(lambda: jm.grow(jsp.SparseLayout(4, 10)),
                lambda: tm.grow(tsp.SparseLayout(4, 10)))
    _same_error(lambda: jm.grow_virtual(10), lambda: tm.grow_virtual(10))


def _error_cases():
    """(name, fn(mod, types) → raises) pairs run against both packages."""
    def layout(mod, *a):
        return mod.SparseLayout(*a)

    def exhaust_nodes(mod, ty):
        sm = mod.SlotMap(layout(mod, 2, 1), n_virtual=100)
        sm.translate(ty.GraphDelta.from_arrays(
            [], [], [], [], n_nodes=100, k_pad=4, join=[0, 1, 2], j_pad=4))

    def exhaust_edges(mod, ty):
        sm = mod.SlotMap(layout(mod, 3, 1), n_virtual=100, stream=7)
        sm.translate(ty.GraphDelta.from_arrays(
            [0, 0], [1, 2], [0.5, 0.5], [0.0, 0.0], n_nodes=100,
            k_pad=4, join=[0, 1, 2], j_pad=4))

    def edge_outside(mod, ty):
        sm = mod.SlotMap(layout(mod, 8, 8), n_virtual=16)
        sm.translate(ty.GraphDelta.from_arrays(
            [0, 3], [99, -2], [0.5, 0.5], [0.0, 0.0], n_nodes=16, k_pad=4))

    def delta_space(mod, ty):
        sm = mod.SlotMap(layout(mod, 8, 8), n_virtual=16)
        sm.translate(ty.GraphDelta.from_arrays(
            [0], [99], [0.5], [0.0], n_nodes=100, k_pad=4))

    def join_outside(mod, ty):
        sm = mod.SlotMap(layout(mod, 8, 8), n_virtual=16)
        d = ty.GraphDelta.from_arrays([], [], [], [], n_nodes=16, k_pad=2,
                                      join=[3], j_pad=2)
        sm.translate(dataclasses.replace(
            d, node_ids=_int_array(ty, [20, 0])))

    def duplicate(mod, ty):
        sm = mod.SlotMap(layout(mod, 8, 8), n_virtual=16)
        sm.translate(ty.GraphDelta.from_arrays(
            [1, 2], [2, 1], [0.5, 0.5], [0.0, 0.0], n_nodes=16, k_pad=4,
            join=[1, 2], j_pad=2))

    def twice(mod, ty):
        sm = mod.SlotMap(layout(mod, 8, 8), n_virtual=16)
        d = sm.translate(ty.GraphDelta.from_arrays(
            [1], [2], [0.5], [0.0], n_nodes=16, k_pad=4, join=[1, 2],
            j_pad=2))
        sm.translate(d)

    def graph_nodes(mod, ty):
        mod.sparse_state_from_graph(_er(ty, 12), layout(mod, 8, 64))

    def graph_edges(mod, ty):
        mod.sparse_state_from_graph(_er(ty, 12), layout(mod, 16, 4))

    def graph_space(mod, ty):
        mod.sparse_state_from_graph(_er(ty, 12), layout(mod, 16, 64),
                                    n_virtual=8)

    def bad_map(mod, ty):
        mod.SlotMap(layout(mod, 4, 4), n_virtual=0)

    return [exhaust_nodes, exhaust_edges, edge_outside, delta_space,
            join_outside, duplicate, twice, graph_nodes, graph_edges,
            graph_space, bad_map]


def _int_array(ty, values):
    if ty is ttypes:
        return torch.tensor(values, dtype=torch.int32)
    return jnp.asarray(values, jnp.int32)


def _er(ty, n):
    if ty is ttypes:
        return erdos_renyi(n, 0.5, seed=1, weighted=True)
    return j_erdos_renyi(n, 0.5, seed=1, weighted=True)


@pytest.mark.parametrize("case", _error_cases(), ids=lambda f: f.__name__)
def test_named_errors_match_reference(case):
    _same_error(lambda: case(jsp, jtypes), lambda: case(tsp, ttypes))


def test_rejected_translation_leaves_the_map_unchanged():
    for mod, ty in ((jsp, jtypes), (tsp, ttypes)):
        sm = mod.SlotMap(mod.SparseLayout(n_slots=2, m_pad=1),
                         n_virtual=100)
        with pytest.raises(mod.SparseCapacityError):
            sm.translate(ty.GraphDelta.from_arrays(
                [0, 0], [1, 2], [0.5, 0.5], [0.0, 0.0], n_nodes=100,
                k_pad=4, join=[0, 1, 2], j_pad=4))
        assert (sm.n_free_nodes, sm.n_free_edges) == (2, 1)


@pytest.mark.parametrize("which", ["untranslated", "wrong_capacity"])
def test_tick_refuses_by_name_like_the_reference(which):
    js, jmaps = jsp.sparse_states_from_graphs(
        [j_erdos_renyi(8, 0.5, seed=s, weighted=True) for s in range(2)],
        jsp.SparseLayout(12, 32), n_virtual=64)
    ts = sparse_state_to_port(js)
    virt = dict(n_nodes=64, k_pad=4, join=[0, 1], j_pad=2)
    arrs = ([0], [1], [0.5], [0.0])
    if which == "untranslated":
        jd = jtypes.GraphDelta.from_arrays(*arrs, **virt)
        td = ttypes.GraphDelta.from_arrays(*arrs, **virt)
    else:
        jd = jsp.SlotMap(jsp.SparseLayout(32, 32), 64).translate(
            jtypes.GraphDelta.from_arrays(*arrs, **virt))
        td = tsp.SlotMap(tsp.SparseLayout(32, 32), 64).translate(
            ttypes.GraphDelta.from_arrays(*arrs, **virt))
    _same_error(
        lambda: jops.sparse_tick_fused(js, j_stack_deltas([jd, jd])),
        lambda: tops.sparse_tick_fused(ts, stack_deltas([td, td])))
    _same_error(
        lambda: jsp.sparse_jsdist_tick(
            jax.tree_util.tree_map(lambda x: x[0], js), jd),
        lambda: tsp.sparse_jsdist_tick(
            ts.map_tensors(lambda x: x[0]), td))


# -- the sparse tick ----------------------------------------------------------

@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("shape", [(12, 40, 100, 8, 3),
                                   (9, 70, 150, 13, 2)])
def test_sparse_tick_ref_matches_jax_ref(shape, exact):
    """The parity cases (emptying then reviving row 0, allocating and
    freeing lanes, the sentinel and slots at m_pad, all-masked rows)
    through both plain versions, two ticks."""
    states, d1, d2 = parity.make_case(*shape, seed=sum(shape),
                                      device="cpu", out_of_range=False)
    jstate = sparse_state_to_jax(states)
    for t, d in enumerate((d1, d2)):
        jdist, jstate_new = j_tick_ref(jstate, sparse_delta_to_jax(d),
                                       exact_smax=exact)
        tdist, tnew = tops.sparse_tick_fused(states, d, exact_smax=exact)
        assert_close(tdist, jdist, f"tick {t} dist")
        assert_sparse_state_close(tnew, jstate_new, f"tick {t}")
        states, jstate = tnew, jstate_new
    assert float(states.s_total[0]) > 0.0  # row 0 revived


def test_plain_version_drops_negative_slots():
    """A slot of −1 writes nothing in the port (the reference would wrap
    it to the last slot; SlotMap never emits one)."""
    states, d1, _ = parity.make_case(8, 40, 100, 8, 2, seed=2,
                                     device="cpu")
    assert int(d1.edge_slots[5, 2]) == -1
    _, new = tops.sparse_tick_fused(states, d1)
    assert torch.equal(new.edge_weights[5, -1], states.edge_weights[5, -1])


def test_in_place_on_cpu_matches_out_of_place():
    states, d1, _ = parity.make_case(10, 50, 120, 9, 3, seed=4,
                                     device="cpu")
    want = tops.sparse_tick_fused(states, d1, exact_smax=True)
    copy = states.map_tensors(torch.clone)
    got = tops.sparse_tick_fused(copy, d1, exact_smax=True, inplace=True)
    assert got[1].edge_weights.data_ptr() == copy.edge_weights.data_ptr()
    for f in SPARSE_FIELDS:
        assert torch.equal(getattr(got[1], f), getattr(want[1], f)), f


@pytest.mark.parametrize("exact", [False, True])
def test_matches_jax_fused_interpret_on_reference_fixture(exact):
    """The reference's own sparse parity fixture (B = 8, n_slots = 64,
    m_pad = 256, joins deep in a 4096-id virtual space) through the
    Pallas kernel in interpret mode."""
    states, stacked = _shard_fixture(11)
    jdist, jnew = jops.sparse_tick_fused(states, stacked, exact_smax=exact,
                                         interpret=True)
    tdist, tnew = tops.sparse_tick_fused(sparse_state_to_port(states),
                                         sparse_delta_to_port(stacked),
                                         exact_smax=exact)
    assert_close(tdist, jdist, "dist")
    assert_sparse_state_close(tnew, jnew)


def test_stacked_matches_jax_stacked_ref():
    shards = [_shard_fixture(s) for s in (11, 12, 13)]
    sstates = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[st for st, _ in shards])
    sdeltas = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[d for _, d in shards])
    jdist, jnew = jax.vmap(lambda s, d: j_tick_ref(s, d, exact_smax=True))(
        sstates, sdeltas)
    tdist, tnew = tops.sparse_tick_fused_stacked(
        sparse_state_to_port(sstates), sparse_delta_to_port(sdeltas),
        exact_smax=True)
    assert tdist.shape == (3, 8)
    assert_close(tdist, jdist, "dist")
    assert_sparse_state_close(tnew, jnew)


@pytest.mark.parametrize("exact", [False, True])
def test_relabelling_invariance_against_the_dense_tick(exact):
    """The same virtual deltas through the port's sparse path (SlotMap
    translation + sparse tick) and its dense `stream_tick_ref` in the
    virtual layout give the same scores and statistics."""
    from repro_torch.engine import StreamEngine

    streams = VirtualStreams(5, 96, seed=21)
    layout = tsp.SparseLayout(24, 80)
    sparse, maps = tsp.sparse_states_from_graphs(
        [streams.edge_list(ttypes.EdgeList, s) for s in range(5)],
        layout, n_virtual=96)
    dense = StreamEngine.init_states(
        [streams.edge_list(ttypes.EdgeList, s) for s in range(5)],
        n_pad=96, device="cpu")
    for t in range(6):
        tick = streams.tick()
        vds = streams.deltas(ttypes.GraphDelta, tick, k_pad=24, j_pad=4)
        slot = stack_deltas([m.translate(d) for m, d in zip(maps, vds)])
        d_sp, sparse = tops.sparse_tick_fused(sparse, slot, exact_smax=exact)
        d_dn, dense = stream_tick_ref(dense, stack_deltas(vds),
                                      exact_smax=exact)
        assert_close(d_sp, d_dn, f"tick {t}: sparse vs dense dist")
        for f in ("q", "s_total", "s_max"):
            assert_close(getattr(sparse, f), getattr(dense, f),
                         f"tick {t}: {f}")
        np.testing.assert_allclose(
            np.sort(sparse.strengths.numpy(), -1),
            np.sort(dense.strengths.numpy(), -1)[:, -layout.n_slots:],
            atol=1e-5, rtol=1e-5, err_msg=f"tick {t}: strength multiset")


# -- GraphDelta.edge_slots ---------------------------------------------------

def test_edge_slots_ride_through_delta_helpers():
    sm = tsp.SlotMap(tsp.SparseLayout(8, 8), n_virtual=32)
    d = sm.translate(ttypes.GraphDelta.from_arrays(
        [3, 4], [4, 9], [0.5, 1.0], [0.0, 0.0], n_nodes=32, k_pad=3,
        join=[3, 4, 9], j_pad=4))
    assert d.edge_slots.tolist() == [0, 1, int(tsp.EDGE_SLOT_SENTINEL)]
    assert torch.equal(d.tensors()["edge_slots"], d.edge_slots)
    for out in (d.to("cpu"), d.scaled(0.5),
                d.map_tensors(lambda x: x.clone()),
                ttypes.gate_delta_by_nodes(d, torch.ones(8))):
        assert torch.equal(out.edge_slots, d.edge_slots)
    stacked = stack_deltas([d, d])
    assert stacked.edge_slots.shape == (2, 3)
    plain = dataclasses.replace(d, edge_slots=None)
    with pytest.raises(ValueError, match="edge_slots presence"):
        stack_deltas([d, plain])
    back = interop.delta_from_numpy(interop.delta_to_numpy(stacked),
                                    stacked.n_nodes, device="cpu")
    assert back.edge_slots.dtype == torch.int32
    assert torch.equal(back.edge_slots, stacked.edge_slots)
