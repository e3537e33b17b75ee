"""The port's offline spectral path against the JAX reference, on the CPU.

Covers `apply_delta_dense`, the Laplacian operators, the power
iteration, the exact spectrum and entropy, FINGER-Ĥ, Algorithm 1
(`jsdist_fast`), the exact JS distance, the Theorem-1 bounds, the
scaled approximation error, the cubic proxy and the directed VNGE. Each
case makes its graph with numpy from a fixed seed (ER, BA, WS and
planted-partition community graphs at n ≤ 300, masked and empty graphs)
and feeds the same arrays to both packages.

Tolerances: entropies, λ and the other scalars at atol 1e-5 with rtol
1e-5 (`_torch_parity.assert_close`, the reference's kernel parity
tolerance), masks exactly.

The power iteration cannot share the reference's start vector by seed:
the reference draws it from JAX's threefry, the port from a torch
generator. Each comparison of a power-iteration result therefore draws
the reference's own start vector here,
``jax.random.normal(jax.random.PRNGKey(0), (n,), jnp.float32)``, and
passes it to the port through ``x0=``, so both follow one trajectory;
the port's own seeded start is held against the exact λ_max at 1e-2,
the tolerance of the reference's own test (near-degenerate top
eigenvalues stop power iteration about 1e-2 short).

JS distances are sqrt(max(JSdiv, 0)), which amplifies rounding near 0:
where a pair's JSdiv is under 1e-3 the test compares JSdiv instead of
the distance.

λ_min⁺ is the smallest eigenvalue above ``eps = 1e-12`` in both
packages, but a float32 eigensolver leaves the null eigenvalue of L_N at
±1e-8 noise, whose sign differs between LAPACK builds: each package may
pick its noise or the true smallest positive eigenvalue (a reference
fault kept in the port, ROADMAP Queue 3). So λ_min⁺ is compared with
``eps = 1e-6``, above that noise, and where the default ``eps`` picks
different eigenvalues the Theorem-1 bounds are not compared; the test
then checks that the disagreement is that noise and that the port's
bounds still hold H.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graphs as jgraphs
from repro.core import directed as jdirected
from repro.core import higher_order as jhigher
from repro.graphs import generators as jgen
from repro.graphs import laplacian as jlap
from repro.graphs import spectral as jspec
import repro_torch.core as tcore
import repro_torch.graphs as tgraphs
from repro_torch.core import directed as tdirected
from repro_torch.core import higher_order as thigher
from repro_torch.graphs import laplacian as tlap
from repro_torch.graphs import spectral as tspec
from _torch_parity import assert_close

N_PAD = 320


def _weights(name: str) -> np.ndarray:
    """The (n, n) float32 weights of a named test graph."""
    if name == "er":
        g = jgen.erdos_renyi(120, 0.08, seed=3, weighted=True)
    elif name == "ba":
        g = jgen.barabasi_albert(150, 4, seed=3)
    elif name == "ws":
        g = jgen.watts_strogatz(200, 6, 0.2, seed=3)
    elif name == "community":
        g = jgen.random_geometric_community(280, 4, 0.3, 0.01, seed=3)
    elif name == "empty":
        return np.zeros((40, 40), np.float32)
    else:
        raise ValueError(name)
    return np.array(g.weights)


def _mask(name: str, n: int):
    """``masked``: a quarter of the nodes inactive and the layout padded
    to N_PAD; else no mask."""
    if not name.endswith("masked"):
        return None, None
    rng = np.random.default_rng(7)
    mask = np.zeros(N_PAD, np.float32)
    mask[:n] = rng.random(n) < 0.75
    return mask, N_PAD


def _both(name: str, edge_list: bool = False):
    """(reference graph, port graph) of a named graph; ``<base>-masked``
    adds a node mask over an N_PAD layout."""
    base = name.replace("-masked", "")
    w = _weights(base)
    mask, n_pad = _mask(name, w.shape[0])
    if edge_list:
        iu, ju = np.triu_indices(w.shape[0], 1)
        live = w[iu, ju] != 0
        args = (iu[live], ju[live], w[iu, ju][live], w.shape[0])
        kw = {} if mask is None else dict(n_pad=n_pad, node_mask=mask)
        return (jgraphs.EdgeList.from_arrays(*args, **kw),
                tgraphs.EdgeList.from_arrays(*args, **kw))
    kw = {} if mask is None else dict(n_pad=n_pad, node_mask=mask)
    return (jgraphs.DenseGraph.from_weights(jnp.asarray(w), **kw),
            tgraphs.DenseGraph.from_weights(torch.from_numpy(w), **kw))


def _x0(n: int) -> np.ndarray:
    """The reference's own start vector for seed 0."""
    return np.array(jax.random.normal(jax.random.PRNGKey(0), (n,),
                                      jnp.float32))


GRAPHS = ["er", "ba", "ws", "community", "er-masked", "community-masked"]
SPECTRAL = GRAPHS + ["empty"]


class TestApplyDeltaDense:
    @pytest.mark.parametrize("name", ["er", "er-masked", "ws"])
    def test_matches_reference(self, name):
        jg, tg = _both(name)
        n = jg.n_nodes
        rng = np.random.default_rng(11)
        w = np.array(jg.masked_weights())
        ii = rng.integers(0, n, 40)
        jj = rng.integers(0, n, 40)
        keep = ii != jj
        ii, jj = ii[keep], jj[keep]
        w_old = w[ii, jj]
        dw = np.where((w_old > 0) & (rng.random(ii.size) < 0.4), -w_old,
                      rng.uniform(0.1, 2.0, ii.size)).astype(np.float32)
        # one lane past the layout: dropped by both packages
        ii = np.r_[ii, n + 3].astype(np.int32)
        jj = np.r_[jj, 1].astype(np.int32)
        dw = np.r_[dw, 1.0].astype(np.float32)
        w_old = np.r_[w_old, 0.0].astype(np.float32)
        kw = {"k_pad": 48}
        if jg.node_mask is not None:
            mask = np.array(jg.node_mask)
            joins = np.flatnonzero(mask[:200] == 0)[:3]
            isolated = np.flatnonzero((w.sum(1) == 0) & (mask == 1))[:1]
            kw.update(join=joins, leave=isolated, j_pad=6)
        jd = jgraphs.GraphDelta.from_arrays(ii, jj, dw, w_old, n_nodes=n,
                                            **kw)
        td = tgraphs.GraphDelta.from_arrays(ii, jj, dw, w_old, n_nodes=n,
                                            **kw)
        want = jgraphs.apply_delta_dense(jg, jd)
        got = tgraphs.apply_delta_dense(tg, td)
        assert_close(got.weights, want.weights, name)
        if want.node_mask is None:
            assert got.node_mask is None
        else:
            np.testing.assert_array_equal(got.node_mask.numpy(),
                                          np.array(want.node_mask))


class TestLaplacian:
    @pytest.mark.parametrize("name", GRAPHS)
    def test_dense_operators(self, name):
        jg, tg = _both(name)
        assert_close(tlap.laplacian_dense(tg), jlap.laplacian_dense(jg))
        assert_close(tlap.trace_l(tg), jlap.trace_l(jg))
        assert_close(tlap.normalized_laplacian_dense(tg),
                     jlap.normalized_laplacian_dense(jg))

    @pytest.mark.parametrize("edge_list", [False, True])
    @pytest.mark.parametrize("name", GRAPHS)
    def test_matvec(self, name, edge_list):
        jg, tg = _both(name, edge_list=edge_list)
        x = np.random.default_rng(5).standard_normal(jg.n_nodes) \
            .astype(np.float32)
        assert_close(tlap.laplacian_matvec(tg)(torch.from_numpy(x)),
                     jlap.laplacian_matvec(jg)(jnp.asarray(x)), name)
        assert_close(tlap.trace_l(tg), jlap.trace_l(jg))


class TestPowerIteration:
    @pytest.mark.parametrize("edge_list", [False, True])
    @pytest.mark.parametrize("name", SPECTRAL)
    def test_follows_the_reference_trajectory(self, name, edge_list):
        jg, tg = _both(name, edge_list=edge_list)
        want = jspec.power_iteration_lmax(jg)
        got = tspec.power_iteration_lmax(tg, x0=_x0(jg.n_nodes))
        assert_close(got, want, name)

    @pytest.mark.parametrize("name", ["er", "ba", "ws", "community"])
    def test_seeded_start_reaches_the_exact_lambda(self, name):
        _, tg = _both(name)
        lam = float(tspec.power_iteration_lmax(tg, num_iters=600,
                                               tol=1e-12))
        exact = float(tspec.lmax_lmin_positive(tg)[0])
        assert abs(lam - exact) / exact < 1e-2

    def test_iterations_and_matvecs_are_reported(self):
        _, tg = _both("er")
        info = {}
        tspec.power_iteration_lmax(tg, num_iters=7, tol=0.0, info=info)
        assert info == {"iterations": 7, "matvecs": 8}

    def test_start_vector_is_seeded_and_checked(self):
        a = tspec.start_vector(50, seed=4)
        torch.testing.assert_close(a, tspec.start_vector(50, seed=4),
                                   rtol=0, atol=0)
        assert abs(float(torch.linalg.norm(a)) - 1.0) < 1e-6
        with pytest.raises(ValueError, match="expected \\(50,\\)"):
            tspec.start_vector(50, x0=np.ones(49, np.float32))


NULL_NOISE = 1e-7  # float32 eigensolver noise on a zero eigenvalue


def _same_lmin(jg, tg) -> bool:
    """Whether the default eps picks the same λ_min⁺ in both packages;
    if not, assert that the two picks differ by the null eigenvalue's
    noise."""
    a = float(tspec.lmax_lmin_positive(tg)[1])
    b = float(jspec.lmax_lmin_positive(jg)[1])
    if abs(a - b) <= 1e-3 * max(a, b):
        return True
    assert min(a, b) < NULL_NOISE, (a, b)
    ev_t = tspec.exact_eigvals_ln(tg).numpy()
    ev_j = np.array(jspec.exact_eigvals_ln(jg))
    assert abs(ev_t[0]) < NULL_NOISE and abs(ev_j[0]) < NULL_NOISE
    return False


class TestExactSpectrum:
    @pytest.mark.parametrize("edge_list", [False, True])
    @pytest.mark.parametrize("name", SPECTRAL)
    def test_eigvals_entropy_and_extremes(self, name, edge_list):
        jg, tg = _both(name, edge_list=edge_list)
        assert_close(tspec.exact_eigvals_ln(tg), jspec.exact_eigvals_ln(jg))
        assert_close(tcore.exact_vnge(tg), jcore.exact_vnge(jg), name)
        if name != "empty":
            for a, b in zip(tspec.lmax_lmin_positive(tg, eps=1e-6),
                            jspec.lmax_lmin_positive(jg, eps=1e-6)):
                assert_close(a, b, name)
            _same_lmin(jg, tg)


class TestVngeHat:
    @pytest.mark.parametrize("edge_list", [False, True])
    @pytest.mark.parametrize("name", SPECTRAL)
    def test_matches_reference(self, name, edge_list):
        jg, tg = _both(name, edge_list=edge_list)
        want = jcore.vnge_hat(jg)
        got = tcore.vnge_hat(tg, x0=_x0(jg.n_nodes))
        assert_close(got, want, name)
        lam = np.float32(0.05)
        assert_close(tcore.vnge_hat(tg, lambda_max=torch.tensor(lam)),
                     jcore.vnge_hat(jg, lambda_max=jnp.asarray(lam)), name)
        if name == "empty":
            assert float(got) == 0.0

    @pytest.mark.parametrize("name", ["er", "ws", "community"])
    def test_ordering_h_tilde_le_h_hat_le_h(self, name):
        _, tg = _both(name)
        h, hh = float(tcore.exact_vnge(tg)), float(tcore.vnge_hat(tg))
        ht = float(tcore.vnge_tilde(tg))
        assert ht <= hh + 1e-4 and hh <= h + 1e-3, (ht, hh, h)


def _pair(name: str, seed: int):
    """(G, G') in both packages: G' is G with about 5 % of its node pairs
    toggled (present edges deleted, absent ones added)."""
    w = _weights(name)
    n = w.shape[0]
    rng = np.random.default_rng(seed)
    iu, ju = np.triu_indices(n, 1)
    pick = rng.random(iu.size) < 0.05
    w2 = w.copy()
    w2[iu[pick], ju[pick]] = np.where(w[iu[pick], ju[pick]] > 0, 0.0, 1.0)
    w2[ju[pick], iu[pick]] = w2[iu[pick], ju[pick]]
    return [(jgraphs.DenseGraph.from_weights(jnp.asarray(a)),
             tgraphs.DenseGraph.from_weights(torch.from_numpy(a)))
            for a in (w, w2)]


def _assert_distance_close(got, want, label):
    """Distances at 1e-5; below JSdiv = 1e-3 the divergence instead (the
    square root amplifies rounding near 0)."""
    got, want = float(got), float(want)
    if want * want < 1e-3:
        assert_close(got * got, want * want, f"{label}: JSdiv")
    else:
        assert_close(got, want, label)


class TestJsDistance:
    @pytest.mark.parametrize("name", ["er", "ba", "ws", "community"])
    def test_fast_and_exact_match_reference(self, name):
        (ja, ta), (jb, tb) = _pair(name, seed=1)
        x0 = _x0(ja.n_nodes)
        _assert_distance_close(tcore.jsdist_fast(ta, tb, x0=x0),
                               jcore.jsdist_fast(ja, jb), f"{name} fast")
        _assert_distance_close(tcore.jsdist_exact(ta, tb),
                               jcore.jsdist_exact(ja, jb), f"{name} exact")

    def test_fast_on_edge_lists_and_identical_graphs(self):
        jg, tg = _both("community", edge_list=True)
        x0 = _x0(jg.n_nodes)
        _assert_distance_close(tcore.jsdist_fast(tg, tg, x0=x0),
                               jcore.jsdist_fast(jg, jg), "self")
        assert float(tcore.jsdist_fast(tg, tg, power_iters=50)) < 1e-2

    def test_power_iters_cap(self):
        (ja, ta), (jb, tb) = _pair("ws", seed=2)
        _assert_distance_close(
            tcore.jsdist_fast(ta, tb, power_iters=5, x0=_x0(ja.n_nodes)),
            jcore.jsdist_fast(ja, jb, power_iters=5), "ws 5 iterations")


class TestBounds:
    @pytest.mark.parametrize("name", GRAPHS)
    def test_theorem1_bounds(self, name):
        jg, tg = _both(name)
        if _same_lmin(jg, tg):
            for a, b in zip(tcore.theorem1_bounds(tg),
                            jcore.theorem1_bounds(jg)):
                assert_close(a, b, name)
        lo, hi = tcore.theorem1_bounds(tg)
        h = float(tcore.exact_vnge(tg))
        assert float(lo) - 1e-4 <= h <= float(hi) + 1e-4

    def test_scaled_approximation_error(self):
        jg, tg = _both("ba")
        h, hh = tcore.exact_vnge(tg), tcore.vnge_hat(tg, x0=_x0(jg.n_nodes))
        want = jcore.scaled_approximation_error(jcore.exact_vnge(jg),
                                                jcore.vnge_hat(jg), 150)
        assert_close(tcore.scaled_approximation_error(h, hh, 150), want)


class TestCubicProxy:
    @pytest.mark.parametrize("name", ["er", "ws", "community", "empty"])
    def test_moments_q3_and_h_hat3(self, name):
        jg, tg = _both(name)
        for a, b in zip(thigher.spectral_moments_3(tg),
                        jhigher.spectral_moments_3(jg)):
            assert_close(a, b, name)
        assert_close(thigher.cubic_q(tg), jhigher.cubic_q(jg), name)
        if name != "empty":
            assert_close(thigher.vnge_hat3(tg, x0=_x0(jg.n_nodes)),
                         jhigher.vnge_hat3(jg), name)

    def test_edge_list_input(self):
        jg, tg = _both("er", edge_list=True)
        assert_close(thigher.cubic_q(tg), jhigher.cubic_q(jg))


class TestDirected:
    @staticmethod
    def _directed(n: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        w = (rng.random((n, n)) < 0.1).astype(np.float32)
        np.fill_diagonal(w, 0.0)
        return w

    @pytest.mark.parametrize("seed", range(3))
    def test_matches_reference(self, seed):
        w = self._directed(50 + 25 * seed, seed)
        jw, tw = jnp.asarray(w), torch.from_numpy(w)
        assert_close(tdirected.generalized_laplacian(tw),
                     jdirected.generalized_laplacian(jw))
        for name in ("directed_vnge", "directed_quadratic_q",
                     "directed_vnge_hat"):
            assert_close(getattr(tdirected, name)(tw),
                         getattr(jdirected, name)(jw), name)

    def test_symmetric_input(self):
        w = _weights("er")
        assert_close(tdirected.directed_vnge(torch.from_numpy(w)),
                     jdirected.directed_vnge(jnp.asarray(w)))


class TestDevices:
    def test_entry_points_run_where_the_graph_lies(self):
        _, tg = _both("er")
        for fn in (tcore.exact_vnge, tcore.vnge_hat,
                   tspec.power_iteration_lmax):
            assert fn(tg).device.type == "cpu"
            assert fn(tg, device="cpu").device.type == "cpu"
        assert tcore.jsdist_fast(tg, tg, device="cpu").device.type == "cpu"
        assert tcore.jsdist_exact(tg, tg, device="cpu").device.type == "cpu"
