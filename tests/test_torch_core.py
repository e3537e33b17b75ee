"""The port's graph types, generators and core math against the JAX
reference, on the CPU.

Each case builds its inputs with numpy from a fixed seed and runs them
through `repro` and `repro_torch`; results are compared at atol 1e-5 with
rtol 1e-5 (the reference's kernel parity tolerance), masks exactly. The
cases are those of `tests/test_incremental.py` and
`tests/test_mixed_streams.py`: emptying, reviving and shrinking to one
edge, join/leave, mixed-n masks, and both `exact_smax` values.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graphs as jgraphs
from repro.graphs import generators as jgen
from repro_torch.core import incremental as tinc
from repro_torch.core import jsdist as tjs
from repro_torch.core import state as tstate
from repro_torch.core import vnge as tvnge
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import types as ttypes
from _torch_parity import (assert_close, assert_state_close,
                           delta_to_port, state_to_port)

METHODS = ("dense", "compact", "fused_tick")


def _port_graph(jg):
    """A JAX DenseGraph/EdgeList → the port's, through numpy."""
    mask = None if jg.node_mask is None else np.array(jg.node_mask)
    if isinstance(jg, jgraphs.DenseGraph):
        return ttypes.DenseGraph(
            weights=torch.from_numpy(np.array(jg.weights)),
            n_nodes=jg.n_nodes,
            node_mask=None if mask is None else torch.from_numpy(mask))
    return ttypes.EdgeList(
        senders=torch.from_numpy(np.array(jg.senders)),
        receivers=torch.from_numpy(np.array(jg.receivers)),
        weights=torch.from_numpy(np.array(jg.weights)),
        mask=torch.from_numpy(np.array(jg.mask)), n_nodes=jg.n_nodes,
        node_mask=None if mask is None else torch.from_numpy(mask))


def _random_delta_arrays(w, rng, k=20, delete_frac=0.4):
    """`tests/test_incremental.py::_random_delta` as plain arrays."""
    n = w.shape[0]
    pairs = {}
    for _ in range(k):
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        i, j = min(i, j), max(i, j)
        w_old = w[i, j]
        if w_old > 0 and rng.random() < delete_frac:
            dw = -w_old
        else:
            dw = float(rng.uniform(0.1, 2.0))
        pairs[(i, j)] = (dw, w_old)
    ii = np.array([p[0] for p in pairs], np.int32)
    jj = np.array([p[1] for p in pairs], np.int32)
    dw = np.array([v[0] for v in pairs.values()], np.float32)
    wo = np.array([v[1] for v in pairs.values()], np.float32)
    return ii, jj, dw, wo


def _both_deltas(*args, **kw):
    """One GraphDelta.from_arrays call in each package."""
    return (jgraphs.GraphDelta.from_arrays(*args, **kw),
            ttypes.GraphDelta.from_arrays(*args, **kw))


class TestGraphs:
    @pytest.mark.parametrize("name,args", [
        ("erdos_renyi", (40, 0.2, 3, True)),
        ("barabasi_albert", (30, 3, 4)),
        ("watts_strogatz", (30, 4, 0.3, 5)),
        ("random_geometric_community", (36, 3, 0.5, 0.05, 6)),
    ])
    def test_generators_bit_for_bit(self, name, args):
        jg = getattr(jgen, name)(*args)
        tg = getattr(tgen, name)(*args)
        np.testing.assert_array_equal(tg.weights.numpy(),
                                      np.asarray(jg.weights))
        assert tgen.average_degree(tg) == jgen.average_degree(jg)

    def test_from_arrays_matches_reference(self):
        args = ([0, 5, 3, 7], [4, 5, 1, 2], [0.5, 9.0, -0.2, 1.0],
                [0.0, 1.0, 0.7, 0.0])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jd, td = _both_deltas(*args, n_nodes=8, n_pad=12, k_pad=6,
                                  join=[9], leave=[2], j_pad=3)
        assert sum("self-loop" in str(w.message) for w in caught) == 2
        for f in ("senders", "receivers", "dw", "w_old", "mask",
                  "node_ids", "node_flag"):
            np.testing.assert_array_equal(getattr(td, f).numpy(),
                                          np.asarray(getattr(jd, f)), f)
            assert getattr(td, f).dtype == (
                torch.int32 if f in ("senders", "receivers", "node_ids")
                else torch.float32)
        assert td.n_nodes == jd.n_nodes == 12
        half = td.scaled(0.5)
        np.testing.assert_array_equal(half.node_flag.numpy(),
                                      [1.0, 0.0, 0.0])
        np.testing.assert_array_equal(half.dw.numpy(),
                                      np.asarray(jd.scaled(0.5).dw))

    @pytest.mark.parametrize("kw,match", [
        (dict(k_pad=1), "exceed k_pad"),
        (dict(join=[12]), "outside the n_pad=12"),
        (dict(leave=[-1]), "outside the n_pad=12"),
        (dict(join=[1, 2], leave=[3], j_pad=2), "exceed j_pad"),
    ])
    def test_from_arrays_errors(self, kw, match):
        for cls in (jgraphs.GraphDelta, ttypes.GraphDelta):
            with pytest.raises(ValueError, match=match):
                cls.from_arrays([0, 1], [2, 3], [1.0, 1.0], [0.0, 0.0],
                                n_nodes=10, n_pad=12, **kw)

    def test_mask_helpers_and_gate(self):
        mask = np.array([1, 1, 0, 0, 1, 0, 1, 1], np.float32)
        jd, td = _both_deltas([0, 1, 3, 4], [2, 6, 5, 7],
                              [1.0, 2.0, 3.0, 4.0], [0.0] * 4, n_nodes=8,
                              join=[2, 5], leave=[7], j_pad=4)
        jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
        j_join = jgraphs.node_mask_after_joins(jm, jd)
        t_join = ttypes.node_mask_after_joins(tm, td)
        np.testing.assert_array_equal(t_join.numpy(), np.asarray(j_join))
        np.testing.assert_array_equal(
            ttypes.node_mask_after_leaves(t_join, td).numpy(),
            np.asarray(jgraphs.node_mask_after_leaves(j_join, jd)))
        np.testing.assert_array_equal(
            ttypes.gate_delta_by_nodes(td, t_join).mask.numpy(),
            np.asarray(jgraphs.gate_delta_by_nodes(jd, j_join).mask))

    def test_out_of_range_ids_are_gated_not_indexed(self):
        td = ttypes.GraphDelta(
            senders=torch.tensor([0, -4, 3], dtype=torch.int32),
            receivers=torch.tensor([9, 1, 2], dtype=torch.int32),
            dw=torch.ones(3), w_old=torch.zeros(3), mask=torch.ones(3),
            n_nodes=4)
        gated = ttypes.gate_delta_by_nodes(td, torch.ones(4))
        np.testing.assert_array_equal(gated.mask.numpy(), [0, 0, 1])
        s = ttypes.scatter_nodes(torch.zeros(4), td.senders, td.dw)
        np.testing.assert_array_equal(s.numpy(), [1, 0, 0, 1])


class TestVnge:
    @pytest.mark.parametrize("kind", ["dense", "edges", "masked_dense",
                                      "masked_edges", "empty"])
    def test_stats_state_and_h_tilde(self, kind):
        jg = jgen.erdos_renyi(30, 0.25, seed=7, weighted=True)
        if kind == "empty":
            jg = jgraphs.DenseGraph.from_weights(jnp.zeros((12, 12)))
        elif kind.startswith("masked"):
            mask = (np.random.default_rng(1).random(30) < 0.7)
            jg = jgraphs.DenseGraph.from_weights(
                jg.weights, n_pad=40,
                node_mask=mask.astype(np.float32))
        if kind.endswith("edges"):
            jg = jgraphs.EdgeList.from_dense(jg, m_pad=500)
        tg = _port_graph(jg)
        for jv, tv in zip(jcore.strength_stats(jg),
                          tvnge.strength_stats(tg)):
            assert_close(tv, jv, kind)
        assert_close(tvnge.quadratic_q(tg), jcore.quadratic_q(jg), kind)
        assert_close(tvnge.vnge_tilde(tg), jcore.vnge_tilde(jg), kind)
        jst = jcore.finger_state(jg)
        tst = tstate.finger_state(tg)
        assert_state_close(tst, jst, kind)
        assert_close(tst.h_tilde(), jst.h_tilde(), kind)
        if kind == "empty":
            assert float(tst.h_tilde()) == 0.0

    def test_average_graph_and_jsdist_tilde(self):
        a = jgraphs.DenseGraph.from_weights(
            jgen.erdos_renyi(20, 0.3, seed=1, weighted=True).weights,
            n_pad=24, node_mask=np.r_[np.ones(18), np.zeros(2)]
            .astype(np.float32))
        b = jgraphs.DenseGraph.from_weights(
            jgen.erdos_renyi(20, 0.3, seed=2, weighted=True).weights,
            n_pad=24)
        for ja, jb in ((a, b), (jgraphs.EdgeList.from_dense(a, 200),
                                jgraphs.EdgeList.from_dense(b, 200))):
            ta, tb = _port_graph(ja), _port_graph(jb)
            avg_j, avg_t = (jcore.average_graph(ja, jb),
                            tjs.average_graph(ta, tb))
            assert_close(avg_t.weights, avg_j.weights)
            np.testing.assert_array_equal(avg_t.node_mask.numpy(),
                                          np.asarray(avg_j.node_mask))
            assert_close(tjs.jsdist_tilde(ta, tb),
                         jcore.jsdist_tilde(ja, jb))


class TestTheorem2:
    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("exact", [False, True])
    @pytest.mark.parametrize("seed", range(2))
    def test_update_state_matches(self, seed, exact, method):
        rng = np.random.default_rng(seed)
        jg = jgen.erdos_renyi(80, 0.1, seed=seed, weighted=True)
        args = _random_delta_arrays(np.asarray(jg.weights), rng)
        jd, td = _both_deltas(*args, n_nodes=80, k_pad=24)
        jst = jcore.finger_state(jg)
        want = jcore.update_state(jst, jd, exact_smax=exact,
                                  method=method)
        got = tinc.update_state(state_to_port(jst), td, exact_smax=exact,
                                method=method)
        assert_state_close(got, want, f"{method} exact={exact}")

    def test_delta_stats_paths_agree(self):
        rng = np.random.default_rng(4)
        jg = jgen.erdos_renyi(50, 0.2, seed=4, weighted=True)
        jd, td = _both_deltas(*_random_delta_arrays(
            np.asarray(jg.weights), rng), n_nodes=50, k_pad=32)
        jst = jcore.finger_state(jg)
        tst = state_to_port(jst)
        j_dense = jcore.delta_stats(jst, jd)
        t_dense = tinc.delta_stats(tst, td)
        for a, b in zip(t_dense, j_dense):
            assert_close(a, b)
        for a, b in zip(tinc.delta_stats_compact(tst, td),
                        jcore.delta_stats_compact(jst, jd)):
            assert_close(a, b)

    @pytest.mark.parametrize("method", METHODS)
    def test_delta_to_empty_graph(self, method):
        jg = jgen.erdos_renyi(30, 0.3, seed=3, weighted=True)
        w = np.asarray(jg.weights)
        iu, ju = np.triu_indices(30, k=1)
        nz = w[iu, ju] > 0
        jd, td = _both_deltas(iu[nz], ju[nz], -w[iu, ju][nz],
                              w[iu, ju][nz], n_nodes=30)
        jst = jcore.finger_state(jg)
        want = jcore.update_state(jst, jd, exact_smax=True, method=method)
        got = tinc.update_state(state_to_port(jst), td, exact_smax=True,
                                method=method)
        assert_state_close(got, want, method)
        assert float(got.s_total) == 0.0 and float(got.q) == 1.0
        assert float(got.h_tilde()) == 0.0

    @pytest.mark.parametrize("method", METHODS)
    def test_shrink_to_one_edge_is_not_empty(self, method):
        n = 40
        w = np.zeros((n, n), np.float32)
        iu, ju = np.triu_indices(n, k=1)
        w[iu, ju] = 100.0
        w = w + w.T
        jg = jgraphs.DenseGraph.from_weights(jnp.asarray(w))
        dw = np.full(len(iu), -100.0, np.float32)
        dw[np.where((iu == 0) & (ju == 1))[0][0]] = -99.5
        jd, td = _both_deltas(iu, ju, dw,
                              np.full(len(iu), 100.0, np.float32),
                              n_nodes=n)
        jst = jcore.finger_state(jg)
        want = jcore.update_state(jst, jd, exact_smax=True, method=method)
        got = tinc.update_state(state_to_port(jst), td, exact_smax=True,
                                method=method)
        assert float(got.s_total) > 0.5
        # S' is the difference of two sums near 1.56e5, so its float32
        # rounding is ~1e-2 in either package: the survivor's state is
        # held at the reference test's own bounds (0.5 on S', 1e-3 on H̃).
        assert abs(float(got.s_total) - float(want.s_total)) < 0.5
        assert abs(float(got.h_tilde()) - float(want.h_tilde())) < 1e-3

    @pytest.mark.parametrize("method", METHODS)
    def test_revive_from_empty_graph(self, method):
        jempty = jcore.finger_state(
            jgraphs.DenseGraph.from_weights(jnp.zeros((12, 12))))
        jd, td = _both_deltas([0, 1, 5], [1, 2, 9], [1.5, 0.5, 2.0],
                              [0.0, 0.0, 0.0], n_nodes=12)
        want = jcore.update_state(jempty, jd, exact_smax=True,
                                  method=method)
        got = tinc.update_state(state_to_port(jempty), td,
                                exact_smax=True, method=method)
        assert_state_close(got, want, method)
        assert_close(got.h_tilde(), want.h_tilde())


class TestMixedStreams:
    @staticmethod
    def _stream(seed, n0=14, n_pad=24, steps=5):
        """A masked stream with joins, leaves and edge churn: the initial
        (n0, n0) weights and per step (delta arrays, join, leave)."""
        rng = np.random.default_rng(seed)
        w = np.zeros((n_pad, n_pad), np.float32)
        up = np.triu(rng.random((n0, n0)) < 0.35, 1)
        w[:n0, :n0] = up * rng.uniform(0.5, 1.5, (n0, n0))
        w = w + w.T
        w0 = w[:n0, :n0].copy()
        active = list(range(n0))
        out = []
        for t in range(steps):
            join, leave, pairs = [], [], {}
            if t % 2 == 0:
                v = n0 + t
                join.append(v)
                for u in rng.choice(active, 2, replace=False):
                    pairs[(min(v, u), max(v, u))] = None
                active.append(v)
            else:
                v = active.pop()
                leave.append(v)
                for u in np.flatnonzero(w[v]):
                    pairs[(min(v, u), max(v, u))] = None
            while len(pairs) < 6:
                a, b = sorted(rng.choice(active, 2, replace=False))
                pairs[(a, b)] = None
            ii = np.array([p[0] for p in pairs], np.int32)
            jj = np.array([p[1] for p in pairs], np.int32)
            wo = w[ii, jj]
            gone = np.isin(ii, leave) | np.isin(jj, leave)
            dw = np.where(gone | (wo > 0), -wo,
                          rng.uniform(0.2, 1.5, len(ii))).astype(np.float32)
            w[ii, jj] += dw
            w[jj, ii] += dw
            out.append(((ii, jj, dw, wo), join, leave))
        return w0, out

    @pytest.mark.parametrize("method", METHODS)
    @pytest.mark.parametrize("exact", [False, True])
    def test_join_leave_chain_matches(self, method, exact):
        n0, n_pad = 14, 24
        w0, steps = self._stream(11, n0, n_pad)
        jst = jcore.finger_state(jgraphs.DenseGraph.from_weights(
            jnp.asarray(w0), n_pad=n_pad))
        tst = state_to_port(jst)
        for t, (arrs, join, leave) in enumerate(steps):
            jd, td = _both_deltas(*arrs, n_nodes=n_pad, k_pad=8,
                                  join=join, leave=leave, j_pad=2)
            jdist, jst = jcore.jsdist_incremental(
                jst, jd, exact_smax=exact, method=method)
            tdist, tst = tjs.jsdist_incremental(
                tst, td, exact_smax=exact, method=method)
            assert_close(tdist, jdist, f"step {t} dist")
            assert_state_close(tst, jst, f"step {t}")

    def test_node_slot_delta_on_maskless_state_raises(self):
        tst = tstate.finger_state(tgen.erdos_renyi(10, 0.3, seed=0))
        td = ttypes.GraphDelta.from_arrays([0], [1], [1.0], [0.0],
                                           n_nodes=10, join=[3])
        with pytest.raises(ValueError, match="without a node_mask"):
            tinc.update_state(tst, td)

    def test_larger_layout_delta_rejected(self):
        g = tgen.erdos_renyi(10, 0.3, seed=0).pad_to(16)
        tst = tstate.finger_state(g)
        td = ttypes.GraphDelta.from_arrays([0], [1], [1.0], [0.0],
                                           n_nodes=10, n_pad=32)
        with pytest.raises(ValueError, match="migrate the state"):
            tinc.update_state(tst, td)

    @pytest.mark.parametrize("method", ["dense", "fused_tick"])
    def test_jsdist_stream_matches(self, method):
        jg = jgen.erdos_renyi(30, 0.2, seed=9, weighted=True)
        rng = np.random.default_rng(9)
        w = np.asarray(jg.weights).copy()
        jds, tds = [], []
        for _ in range(4):
            arrs = _random_delta_arrays(w, rng, k=10)
            w[arrs[0], arrs[1]] += arrs[2]
            w[arrs[1], arrs[0]] += arrs[2]
            jd, td = _both_deltas(*arrs, n_nodes=30, k_pad=12)
            jds.append(jd)
            tds.append(td)
        from repro.engine import stack_deltas as jstack
        from repro_torch.engine import stack_deltas as tstack

        jst = jcore.finger_state(jg)
        jdists, jfin = jcore.jsdist_stream(jst, jstack(jds),
                                           exact_smax=True, method=method)
        tdists, tfin = tjs.jsdist_stream(state_to_port(jst), tstack(tds),
                                         exact_smax=True, method=method)
        assert_close(tdists, jdists)
        assert_state_close(tfin, jfin)
        assert_close(
            tjs.jsdist_incremental(state_to_port(jst), delta_to_port(
                jds[0]), exact_smax=True, method=method)[0], jdists[0])
