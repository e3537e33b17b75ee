"""Public names of finished modules, held against the reference.

Each name the reference exports and the port lacked gets the same numpy
input in both packages and is compared at the reference's kernel parity
tolerance (atol 1e-5, rtol 1e-5; counts, sizes and flags exactly):

- `core.h_tilde_after` (eq. 3), exported from `repro_torch.core`;
- `DenseGraph.n`, `n_pad`, `n_active`;
- `EdgeList.n`, `n_pad`, `m_pad`, `n_active`, `n_edges`, `pad_to`,
  `from_dense`;
- `GraphDelta.n`, `n_pad`, `layout`, `has_node_slots`,
  `delta_strengths`, `delta_s_total`;
- `FingerState.n_pad`, `n_active`;
- `kernels.vnge_q.ref.q_from_stats`;
- `strength_stats` importable from `core.higher_order`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core.higher_order import strength_stats as j_hostats
from repro.graphs import types as jtypes
from repro.kernels.vnge_q.ref import q_from_stats as j_q_from_stats
from repro.kernels.vnge_q.ref import vnge_q_stats_ref as j_stats_ref
import repro_torch.core as pcore
from repro_torch.graphs import types as ptypes
from repro_torch.graphs.layout import NodeLayout
from repro_torch.kernels.vnge_q.ref import q_from_stats, vnge_q_stats_ref
from _torch_parity import ATOL, RTOL, assert_state_close, delta_to_port, \
    state_to_port


def close(got, want, label=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL, err_msg=label)


def weights(n, seed, p=0.3):
    rng = np.random.default_rng(seed)
    w = np.triu((rng.random((n, n)) < p) * rng.uniform(0.5, 2.0, (n, n)), 1)
    return (w + w.T).astype(np.float32)


def both_dense(n, seed, n_pad=None):
    w = weights(n, seed)
    kw = {} if n_pad is None else {"n_pad": n_pad}
    return (jtypes.DenseGraph.from_weights(jnp.asarray(w), **kw),
            ptypes.DenseGraph.from_weights(torch.from_numpy(w), **kw))


def both_delta(n, seed, n_pad=None, join=(), leave=(), j_pad=None):
    rng = np.random.default_rng(seed)
    k = 6
    s = rng.integers(0, n, k)
    r = (s + 1 + rng.integers(0, n - 1, k)) % n
    dw = rng.uniform(-0.5, 1.5, k).astype(np.float32)
    w_old = rng.uniform(0.0, 1.0, k).astype(np.float32)
    args = (s, r, dw, w_old)
    kw = dict(n_nodes=n, k_pad=9, n_pad=n_pad, join=join, leave=leave,
              j_pad=j_pad)
    return (jtypes.GraphDelta.from_arrays(*args, **kw),
            ptypes.GraphDelta.from_arrays(*args, **kw))


def test_core_exports_h_tilde_after():
    assert "h_tilde_after" in pcore.__all__
    assert set(jcore.__all__) <= set(pcore.__all__)


@pytest.mark.parametrize("exact_smax", [False, True])
@pytest.mark.parametrize("method", ["dense", "compact", "fused_tick"])
@pytest.mark.parametrize("masked", [False, True])
def test_h_tilde_after_matches_the_reference(exact_smax, method, masked):
    n_pad = 24 if masked else None
    jg, _ = both_dense(20, 1, n_pad=n_pad)
    jst = jcore.finger_state(jg)
    join = (21,) if masked else ()
    jd, _ = both_delta(20, 2, n_pad=n_pad, join=join,
                       j_pad=2 if masked else None)
    jh, jnew = jcore.h_tilde_after(jst, jd, exact_smax=exact_smax,
                                   method="dense")
    ph, pnew = pcore.h_tilde_after(state_to_port(jst), delta_to_port(jd),
                                   exact_smax=exact_smax, method=method)
    close(ph, jh, "H~ after")
    assert_state_close(pnew, jnew, "state after")
    close(ph, pnew.h_tilde(), "H~ of the returned state")


@pytest.mark.parametrize("n_pad", [None, 32])
def test_dense_graph_sizes(n_pad):
    jg, pg = both_dense(20, 3, n_pad=n_pad)
    assert (pg.n, pg.n_pad) == (jg.n, jg.n_pad)
    assert int(pg.n_active()) == int(jg.n_active())
    assert pg.n_active().dtype == torch.int32


@pytest.mark.parametrize("n_pad", [None, 30])
@pytest.mark.parametrize("m_pad", [None, 200])
def test_edge_list_from_dense_and_sizes(n_pad, m_pad):
    jg, pg = both_dense(20, 4, n_pad=n_pad)
    je = jtypes.EdgeList.from_dense(jg, m_pad=m_pad)
    pe = ptypes.EdgeList.from_dense(pg, m_pad=m_pad)
    for f in ("senders", "receivers", "weights", "mask"):
        np.testing.assert_array_equal(getattr(pe, f).numpy(),
                                      np.asarray(getattr(je, f)), f)
    assert pe.senders.dtype == torch.int32
    assert pe.weights.dtype == torch.float32
    if n_pad is None:
        assert pe.node_mask is None and je.node_mask is None
    else:
        np.testing.assert_array_equal(pe.node_mask.numpy(),
                                      np.asarray(je.node_mask))
    assert (pe.n, pe.n_pad, pe.m_pad) == (je.n, je.n_pad, je.m_pad)
    assert int(pe.n_active()) == int(je.n_active())
    assert int(pe.n_edges()) == int(je.n_edges())
    close(pe.strengths(), je.strengths(), "strengths")
    with pytest.raises(ValueError, match="exceeds m_pad"):
        ptypes.EdgeList.from_dense(pg, m_pad=3)


@pytest.mark.parametrize("masked", [False, True])
def test_edge_list_pad_to_matches_the_reference(masked):
    jg, pg = both_dense(20, 5, n_pad=24 if masked else None)
    je = jtypes.EdgeList.from_dense(jg).pad_to(40)
    pe = ptypes.EdgeList.from_dense(pg).pad_to(40)
    assert (pe.n_nodes, pe.m_pad) == (je.n_nodes, je.m_pad) == \
        (40, je.m_pad)
    np.testing.assert_array_equal(pe.node_mask.numpy(),
                                  np.asarray(je.node_mask))
    assert int(pe.n_active()) == int(je.n_active())
    close(pe.strengths(), je.strengths(), "strengths")
    close(pcore.finger_state(pe).q, jcore.finger_state(je).q, "q")
    with pytest.raises(ValueError, match="pad_to"):
        pe.pad_to(10)


@pytest.mark.parametrize("slots", [False, True])
def test_graph_delta_names_match_the_reference(slots):
    kw = dict(n_pad=16, join=(13,), leave=(2,), j_pad=3) if slots else {}
    jd, pd = both_delta(12, 6, **kw)
    assert (pd.n, pd.n_pad, pd.has_node_slots) == \
        (jd.n, jd.n_pad, jd.has_node_slots)
    assert (pd.layout.n_pad, pd.layout.generation) == \
        (jd.layout.n_pad, jd.layout.generation)
    for n in (None, 20):
        close(pd.delta_strengths(n), jd.delta_strengths(n), f"Δs n={n}")
    close(pd.delta_s_total(), jd.delta_s_total(), "ΔS")
    stamped = ptypes.GraphDelta.from_arrays(
        [0], [1], [1.0], [0.0], n_nodes=4,
        layout=NodeLayout(8, generation=3))
    assert stamped.layout == NodeLayout(8, generation=3)
    assert stamped.n_pad == 8


def test_delta_strengths_drop_out_of_range_ids_and_keep_batch_axes():
    _, pd = both_delta(12, 7)
    stacked = pd.map_tensors(lambda x: torch.stack([x, x]))
    ds = stacked.delta_strengths()
    assert ds.shape == (2, 12)
    torch.testing.assert_close(ds[1], pd.delta_strengths())
    torch.testing.assert_close(stacked.delta_s_total(),
                               pd.delta_s_total().expand(2))
    # a smaller n drops the lanes whose ids lie outside it
    small = pd.delta_strengths(4)
    torch.testing.assert_close(small, pd.delta_strengths()[:4])


@pytest.mark.parametrize("n_pad", [None, 28])
def test_finger_state_sizes(n_pad):
    jg, _ = both_dense(20, 8, n_pad=n_pad)
    jst = jcore.finger_state(jg)
    pst = state_to_port(jst)
    assert pst.n_pad == jst.n_pad
    assert int(pst.n_active()) == int(jst.n_active())
    stacked = pst.map_tensors(lambda x: torch.stack([x, x, x]))
    assert stacked.n_pad == jst.n_pad
    assert stacked.n_active().tolist() == [int(jst.n_active())] * 3


@pytest.mark.parametrize("n", [1, 17, 64])
def test_q_from_stats_matches_the_reference(n):
    w = weights(n, 9)
    jq = j_q_from_stats(j_stats_ref(jnp.asarray(w)))
    stats = vnge_q_stats_ref(torch.from_numpy(w))
    close(q_from_stats(stats), jq, "Q")
    close(q_from_stats(torch.stack([stats, stats])), [float(jq)] * 2,
          "Q over a batch")
    close(q_from_stats(stats), pcore.quadratic_q(
        ptypes.DenseGraph.from_weights(torch.from_numpy(w))), "Lemma 1")


def test_strength_stats_importable_from_higher_order():
    from repro_torch.core.higher_order import strength_stats
    from repro_torch.core.vnge import strength_stats as home

    assert strength_stats is home
    jg, pg = both_dense(20, 10, n_pad=25)
    for got, want in zip(strength_stats(pg), j_hostats(jg)):
        close(got, want, "strength stats")
