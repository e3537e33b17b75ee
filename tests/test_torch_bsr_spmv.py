"""The port's BSR layout, plain SpMV and BSR power iteration against the
JAX reference, on the CPU.

The oracle here is the reference's pure-jnp path, not its Pallas
kernel: in jax 0.9.0 ``jax.experimental.pallas`` has no ``load``, so
`repro.kernels.bsr_spmv.kernel.bsr_matvec_pallas` fails in interpret
mode (its ``pl.load`` at kernel.py:28). The port's plain version is
therefore held against `repro.kernels.bsr_spmv.ref.bsr_matvec_ref`, and
its power iteration against ``power_iteration_lmax_bsr(...,
use_pallas=False)``. The CUDA kernel itself is held against the plain
version on the card (`tests/test_torch_cuda_kernels.py`,
``chip_smoke.py`` phase 2).

Tolerances: the layout exactly (`dense_to_bsr` against the reference's
arrays, `edges_to_bsr` against `dense_to_bsr` bit for bit, duplicates
and zero weights included; each stripe's ``counts`` against the blocks
the reference keeps); y at atol 1e-5 with rtol 1e-5, and bit for bit
between the plain version, which adds only each stripe's real slots, and
a sum over every slot; λ_max at
rtol 1e-5 against the reference's iteration from the same start vector
(the reference's own ``jax.random.normal(PRNGKey(seed))`` draw, fed
through ``x0=``), and at 1e-2 against the exact λ_max, the tolerance of
the reference's own test (`tests/test_kernels.py::TestBsrSpmv`): the
community graphs have near-degenerate top eigenvalues.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import generators as jgen
from repro.graphs.spectral import lmax_lmin_positive
from repro.kernels.bsr_spmv import ops as jops
from repro.kernels.bsr_spmv import ref as jref
from repro_torch import interop
from repro_torch.graphs.generators import random_geometric_community_edges
from repro_torch.kernels.bsr_spmv import ops, parity
from repro_torch.kernels.bsr_spmv.ref import (bsr_density, bsr_matvec_ref,
                                              dense_to_bsr, edges_to_bsr)
from _torch_parity import assert_close

# (n, b, graph): ragged n, both block sizes the kernel takes, an ER graph
LAYOUTS = [(256, 128, "community"), (300, 128, "community"),
           (200, 64, "community"), (250, 128, "er"), (130, 64, "er")]


def _weights(n: int, graph: str) -> np.ndarray:
    if graph == "er":
        g = jgen.erdos_renyi(n, 0.05, seed=9, weighted=True)
    else:
        g = jgen.random_geometric_community(n, 4, 0.25, 0.01, seed=n)
    return np.array(g.weights)


def _x0(n: int, seed: int = 0) -> np.ndarray:
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n,),
                                      jnp.float32))


@pytest.mark.parametrize("n,b,graph", LAYOUTS)
def test_dense_to_bsr_equals_the_reference_arrays(n, b, graph):
    w = _weights(n, graph)
    want = jref.dense_to_bsr(w, b=b)
    got = dense_to_bsr(w, b=b, device="cpu")
    arrays, n_pad, n_orig = interop.bsr_to_numpy(got)
    np.testing.assert_array_equal(arrays["values"], np.array(want.values))
    np.testing.assert_array_equal(arrays["col_ids"], np.array(want.col_ids))
    assert (n_pad, n_orig, got.block) == (want.n, want.n_orig, want.block)
    assert bsr_density(got) == jref.bsr_density(want)
    back = interop.bsr_from_numpy(arrays, n_pad, n_orig, device="cpu")
    assert torch.equal(back.values, got.values)
    assert torch.equal(back.col_ids, got.col_ids)


@pytest.mark.parametrize("n,b,graph", LAYOUTS)
def test_edges_to_bsr_equals_dense_to_bsr_bit_for_bit(n, b, graph):
    """Duplicated lanes (split weights), zero-weight lanes, self loops
    and an edge whose lanes cancel to 0 go in; the layout of the summed
    dense W comes out."""
    w = _weights(n, graph)
    iu, ju = np.triu_indices(n, 1)
    live = w[iu, ju] != 0
    s, r, wt = iu[live], ju[live], w[iu, ju][live]
    rng = np.random.default_rng(n)
    dup = rng.random(s.size) < 0.3
    part = (wt[dup] * rng.uniform(0.2, 0.8, dup.sum())).astype(np.float32)
    wt = wt.copy()
    wt[dup] -= part
    # the split parts (reversed), zero lanes, a self loop and a pair
    # (n-1, 1), (1, n-1) whose lanes cancel
    s, r = (np.r_[s, r[dup], rng.integers(0, n, 5), 0, 3, n - 1, 1],
            np.r_[r, s[dup], rng.integers(0, n, 5), 1, 3, 1, n - 1])
    wt = np.r_[wt, part, np.zeros(5, np.float32), 0.0, 2.0, 0.5, -0.5] \
        .astype(np.float32)
    # the lanes in a shuffled order, endpoints swapped on half of them
    order = rng.permutation(s.size)
    swap = rng.random(s.size) < 0.5
    s, r = np.where(swap, r, s)[order], np.where(swap, s, r)[order]
    wt = wt[order]
    dense = np.zeros((n, n), np.float32)
    off = s != r
    np.add.at(dense, (s[off], r[off]), wt[off])
    np.add.at(dense, (r[off], s[off]), wt[off])
    want = dense_to_bsr(dense, b=b, device="cpu")
    got = edges_to_bsr(s.astype(np.int32), r.astype(np.int32), wt, n, b=b,
                       device="cpu")
    assert (got.n, got.n_orig) == (want.n, want.n_orig)
    assert torch.equal(got.col_ids, want.col_ids)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.counts, want.counts)


def test_edges_to_bsr_of_no_edges_is_all_padding():
    m = edges_to_bsr(np.zeros(0, np.int32), np.zeros(0, np.int32),
                     np.zeros(0, np.float32), 200, b=64, device="cpu")
    assert tuple(m.values.shape) == (4, 1, 64, 64) and m.n == 256
    assert not m.values.any() and not m.col_ids.any()
    assert m.counts.dtype == torch.int32 and m.counts.tolist() == [0] * 4


def _kept_blocks(w: np.ndarray, b: int) -> np.ndarray:
    """Blocks per stripe that the reference's `dense_to_bsr` keeps: its
    own rule, ``abs().sum() > 0`` per (b, b) tile of the padded W."""
    jm = jref.dense_to_bsr(w, b=b)
    wp = np.zeros((jm.n, jm.n), np.float32)
    wp[:w.shape[0], :w.shape[0]] = w
    r = jm.n // b
    tiles = wp.reshape(r, b, r, b).transpose(0, 2, 1, 3)
    kept = (np.abs(tiles).sum(axis=(2, 3)) > 0).sum(axis=1)
    # the reference's slots: its kept blocks first, then padding
    vals = np.array(jm.values)
    assert (np.abs(vals).sum(axis=(2, 3)) > 0).sum(axis=1).tolist() \
        == kept.tolist()
    return kept


@pytest.mark.parametrize("n,b,graph", LAYOUTS)
def test_counts_equal_the_blocks_the_reference_keeps(n, b, graph):
    """`dense_to_bsr`, `edges_to_bsr` and `interop.bsr_from_numpy` (of
    the reference's arrays) give each stripe's count of real slots, and
    those slots come first."""
    w = _weights(n, graph)
    want = _kept_blocks(w, b)
    iu, ju = np.triu_indices(n, 1)
    live = w[iu, ju] != 0
    jm = jref.dense_to_bsr(w, b=b)
    arrays = {"values": np.array(jm.values), "col_ids": np.array(jm.col_ids)}
    for m in (dense_to_bsr(w, b=b, device="cpu"),
              edges_to_bsr(iu[live], ju[live], w[iu, ju][live], n, b=b,
                           device="cpu"),
              interop.bsr_from_numpy(arrays, jm.n, jm.n_orig, device="cpu")):
        assert m.counts.dtype == torch.int32
        assert m.counts.tolist() == want.tolist()
        real = m.values.abs().sum((2, 3)) > 0
        slots = torch.arange(m.col_ids.shape[1])[None, :]
        assert torch.equal(real, slots < m.counts[:, None].long())
    # the arrays that cross to the reference are still exactly its own
    back, _, _ = interop.bsr_to_numpy(dense_to_bsr(w, b=b, device="cpu"))
    assert sorted(back) == ["col_ids", "values"]
    np.testing.assert_array_equal(back["values"], arrays["values"])
    np.testing.assert_array_equal(back["col_ids"], arrays["col_ids"])


@pytest.mark.parametrize("label", list(parity.CASES))
def test_plain_matvec_with_counts_equals_the_every_slot_sum(label):
    """The plain version adds each stripe's real slots only; summing
    every slot, padding included, gives the same y bit for bit."""
    n, b, kind = parity.CASES[label]
    m, x = parity.make_case(min(n, 4096), b, seed=4, device="cpu",
                            kind=kind)
    n_rb, max_bpr = m.col_ids.shape
    gathered = x.view(n_rb, b)[m.col_ids.long()]
    every = torch.zeros((n_rb, b))
    for k in range(max_bpr):
        every = every + torch.matmul(m.values[:, k],
                                     gathered[:, k, :, None])[..., 0]
    assert torch.equal(bsr_matvec_ref(m, x), every.reshape(-1))
    if kind == "uneven":
        counts = m.counts.tolist()
        assert counts[0] == max_bpr and 1 in counts and counts[-1] == 0
    if kind == "empty_stripe":
        assert int(m.counts[1]) == 0


def test_bad_counts_are_refused_by_name():
    m, x = parity.make_case(1000, 64, seed=0, device="cpu")
    max_bpr = m.col_ids.shape[1]
    bad = {
        "int32": m.counts.long(),
        "max_bpr": m.counts.clone().fill_(max_bpr + 1),
        "0, max_bpr": torch.where(torch.arange(m.counts.numel()) == 3,
                                  -1, m.counts).to(torch.int32),
        r"\(n_rb,\)": m.counts[None, :],
    }
    for match, counts in bad.items():
        with pytest.raises((TypeError, ValueError), match=match):
            ops.bsr_matvec(dataclasses.replace(m, counts=counts), x)
    order = ops.stripe_order(m.counts, max_bpr)
    assert order.dtype == torch.int32
    got = m.counts[order.long()]
    assert torch.equal(got, m.counts.sort(descending=True, stable=True)[0])


@pytest.mark.parametrize("n,b,graph", LAYOUTS)
def test_plain_matvec_matches_the_reference(n, b, graph):
    w = _weights(n, graph)
    jm = jref.dense_to_bsr(w, b=b)
    tm = dense_to_bsr(w, b=b, device="cpu")
    x = np.random.default_rng(3).standard_normal(jm.n).astype(np.float32)
    want = jref.bsr_matvec_ref(jm, jnp.asarray(x))
    assert_close(bsr_matvec_ref(tm, torch.from_numpy(x)), want)
    before = dict(ops.LAUNCHES)
    assert_close(ops.bsr_matvec(tm, torch.from_numpy(x)), want)
    assert ops.LAUNCHES == before  # CPU tensors: the plain version
    wp = np.zeros((jm.n, jm.n), np.float32)
    wp[:n, :n] = w
    np.testing.assert_allclose(bsr_matvec_ref(tm, torch.from_numpy(x)),
                               wp @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("label", list(parity.CASES))
def test_parity_cases_match_the_dense_product(label):
    n, b, kind = parity.CASES[label]
    if n > 4096:  # the card's large case: its edge list, not its W
        n = 4096 + 100
    m, x = parity.make_case(n, b, seed=1, device="cpu", kind=kind)
    if kind == "block_diagonal":
        assert m.col_ids.shape[1] == 1
    if kind == "empty_stripe":
        assert not m.values[1].any() and not m.col_ids[1].any()
    vals = m.values.numpy()
    dense = np.zeros((m.n, m.n), np.float32)
    for r, row in enumerate(m.col_ids.numpy()):
        for k, c in enumerate(row):
            dense[r * b:(r + 1) * b, c * b:(c + 1) * b] += vals[r, k]
    parity.compare(bsr_matvec_ref(m, x), torch.from_numpy(dense @ x.numpy()),
                   label)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n,b,graph", LAYOUTS)
def test_power_iteration_follows_the_reference(n, b, graph, seed):
    w = _weights(n, graph)
    jm = jref.dense_to_bsr(w, b=b)
    want = jops.power_iteration_lmax_bsr(jm, seed=seed, use_pallas=False)
    tm = dense_to_bsr(w, b=b, device="cpu")
    info = {}
    got = ops.power_iteration_lmax_bsr(tm, x0=_x0(jm.n, seed), info=info)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert 1 <= info["iterations"] <= 100


def test_power_iteration_reaches_the_exact_lambda():
    g = jgen.random_geometric_community(280, 4, 0.3, 0.01, seed=3)
    tm = dense_to_bsr(np.array(g.weights), b=128, device="cpu")
    lam = float(ops.power_iteration_lmax_bsr(tm, num_iters=600, tol=1e-12))
    exact = float(lmax_lmin_positive(g)[0])
    assert abs(lam - exact) / exact < 1e-2


def test_power_iteration_on_an_edge_built_layout_and_empty_graph():
    lo, hi = random_geometric_community_edges(700, 4, 0.05, 0.001, seed=2)
    w = np.ones(lo.shape, np.float32)
    m = edges_to_bsr(lo, hi, w, 700, b=64, device="cpu")
    dense = np.zeros((700, 700), np.float32)
    dense[lo, hi] = dense[hi, lo] = 1.0
    jm = jref.dense_to_bsr(dense, b=64)
    np.testing.assert_allclose(
        float(ops.power_iteration_lmax_bsr(m, x0=_x0(m.n))),
        float(jops.power_iteration_lmax_bsr(jm, use_pallas=False)),
        rtol=1e-5)
    empty = edges_to_bsr(lo[:0], hi[:0], w[:0], 100, b=64, device="cpu")
    assert float(ops.power_iteration_lmax_bsr(empty)) == 0.0


def test_layout_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w = _weights(130, "er")
    with pytest.raises(RuntimeError, match="is_available"):
        dense_to_bsr(w, b=64)
    with pytest.raises(RuntimeError, match="is_available"):
        edges_to_bsr(np.array([0]), np.array([1]), np.array([1.0]), 4)
    m = dense_to_bsr(torch.from_numpy(w), b=64)  # a CPU tensor stays
    assert m.values.device.type == "cpu"
    with pytest.raises(RuntimeError, match="is_available"):
        ops.power_iteration_lmax_bsr(m, device="cuda")
