"""The FINGER telemetry probes and the plain versions of their kernels
against the JAX reference on the CPU.

- ``vnge_q``: the port's plain version against the reference's oracle
  and its Pallas kernel in interpret mode, ragged n included, with and
  without a node mask, at the reference's kernel-test tolerance
  (rtol 3e-5, atol 1e-5).
- ``entropy_probe``: the plain row stats and graph parts against the
  reference's Pallas kernels in interpret mode; the closed statistics
  (the plain graph-stats kernel's output, and the op's) against the
  port's oracle, the reference's oracle and the reference's op, ragged
  S included, at rtol 5e-4, atol 1e-5.
- The probes: `attention_entropy_probe` against the reference's at
  ``use_pallas=False`` and ``True`` (rtol 5e-4, atol 1e-5);
  `routing_graph` weights exactly equal; `RoutingGraphTracker` over 12
  fed graphs (distances at 1e-5, the same anomaly steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.distributed.sharding import NO_SHARDING
from repro.graphs.types import DenseGraph as JaxDenseGraph
from repro.kernels.entropy_probe import ops as jax_ep_ops
from repro.kernels.entropy_probe.kernel import attention_graph_stats_pallas
from repro.kernels.entropy_probe.ref import \
    attention_graph_stats_ref as jax_ep_oracle
from repro.kernels.entropy_probe.ref import \
    entropy_from_stats as jax_entropy_from_stats
from repro.kernels.vnge_q import ops as jax_vq_ops
from repro.kernels.vnge_q.ref import vnge_q_stats_ref as jax_vq_oracle
from repro.models import transformer as jax_tf
from repro.models.params import init_params as jax_init_params
from repro.train import telemetry as jax_tel
from repro_torch import interop
from repro_torch.configs import base as pt_base
from repro_torch.graphs.types import DenseGraph
from repro_torch.kernels.entropy_probe import ops as ep_ops
from repro_torch.kernels.entropy_probe import parity as ep_parity
from repro_torch.kernels.entropy_probe import ref as ep_ref
from repro_torch.kernels.vnge_q import ops as vq_ops
from repro_torch.kernels.vnge_q import parity as vq_parity
from repro_torch.train import telemetry as pt_tel

VQ = dict(rtol=3e-5, atol=1e-5)
EP = dict(rtol=5e-4, atol=1e-5)


def granite():
    cfg = jax_base.get_config("granite-moe-3b-a800m").reduced()
    params = jax_init_params(jax_tf.param_defs(cfg, NO_SHARDING),
                             jax.random.PRNGKey(1))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return (cfg, params, pt_base.get_config("granite-moe-3b-a800m").reduced(),
            interop.params_from_numpy(np_params, "cpu"))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [37, 40, 130, 256, 1000])
def test_vnge_q_plain_matches_oracle_and_interpret_kernel(n, masked):
    w, mask = vq_parity.make_case(n, seed=n, device="cpu", masked=masked)
    jw = jnp.asarray(w.numpy())
    jm = None if mask is None else jnp.asarray(mask.numpy())
    got = vq_ops.vnge_q_stats(w, node_mask=mask).numpy()
    masked_w = jw if jm is None else jw * jm[:, None] * jm[None, :]
    np.testing.assert_allclose(got, np.asarray(jax_vq_oracle(masked_w)), **VQ)
    np.testing.assert_allclose(
        got, np.asarray(jax_vq_ops.vnge_q_stats(jw, use_pallas=True,
                                                node_mask=jm)), **VQ)
    for port_fn, jax_fn in ((vq_ops.quadratic_q_dense,
                             jax_vq_ops.quadratic_q_dense),
                            (vq_ops.vnge_tilde_dense,
                             jax_vq_ops.vnge_tilde_dense)):
        np.testing.assert_allclose(
            port_fn(w, node_mask=mask).numpy(),
            np.asarray(jax_fn(jw, use_pallas=False, node_mask=jm)), **VQ)


def test_vnge_q_empty_graph_is_zero():
    w = torch.zeros((40, 40))
    assert vq_ops.vnge_q_stats(w).abs().max().item() == 0.0
    assert vq_ops.vnge_tilde_dense(w).item() == 0.0


def test_telemetry_closings_keep_the_references_empty_graph_value():
    """Both probes close Lemma 1 and eq. (2) through `core/vnge.py`; the
    reference's telemetry closings leave an empty graph unguarded
    (-ln(1e-30) ≈ 69.08), where `vnge_tilde_dense` gives 0."""
    w = np.zeros((40, 40), np.float32)
    want = float(jax_tel._h_tilde_dense(
        JaxDenseGraph(weights=jnp.asarray(w), n_nodes=40)))
    got = float(pt_tel._h_tilde_dense(
        DenseGraph(weights=torch.from_numpy(w), n_nodes=40)))
    assert want > 60.0
    assert got == pytest.approx(want, rel=1e-6)
    rng = np.random.default_rng(0)
    stats = np.abs(rng.standard_normal((5, 4))).astype(np.float32)
    stats[0] = 0.0
    np.testing.assert_allclose(
        ep_ref.entropy_from_stats(torch.from_numpy(stats)).numpy(),
        np.asarray(jax_entropy_from_stats(jnp.asarray(stats))), rtol=1e-6)


@pytest.mark.parametrize("bh,s", [(2, 128), (3, 256)])
def test_entropy_probe_plain_kernels_match_interpret_kernels(bh, s):
    x = ep_parity.make_case(bh, s, seed=s, device="cpu")
    rm, dn = ep_ref.row_stats_ref(x)
    scal, colsum, diag = ep_ref.graph_parts_ref(x, rm, dn)
    want = attention_graph_stats_pallas(jnp.asarray(x.numpy()), bs=128,
                                        interpret=True)
    for g, w, lab in zip((scal, colsum, diag), want,
                         ("scalars", "colsum", "diag")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=lab,
                                   **EP)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s", [(2, 128), (2, 100), (1, 200)])
def test_entropy_probe_stats_match_oracle_and_reference_op(bh, s, causal):
    """A ragged S (100, 200) takes the reference op's quiet plain path;
    the port's closing algebra runs on every S."""
    x = ep_parity.make_case(bh, s, seed=7 * s, device="cpu", causal=causal)
    jx = jnp.asarray(x.numpy())
    got = ep_ops.attention_graph_stats(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_ep_oracle(jx)), **EP)
    np.testing.assert_allclose(got, np.asarray(
        jax_ep_ops.attention_graph_stats(jx, use_pallas=True)), **EP)
    np.testing.assert_allclose(
        ep_ref.attention_graph_stats_ref(x).numpy(),
        np.asarray(jax_ep_oracle(jx)), **EP)
    np.testing.assert_allclose(
        ep_ops.attention_graph_entropy(x).numpy(),
        np.asarray(jax_ep_ops.attention_graph_entropy(jx, use_pallas=False)),
        **EP)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,s", [(2, 128), (2, 100), (1, 200)])
def test_entropy_probe_closed_graph_stats_match_oracles(bh, s, causal):
    """The graph-stats kernel's plain version returns the closed (BH, 4)
    statistics from the row stats: held against the port's oracle and
    the reference's plain op on the same numpy logits."""
    x = ep_parity.make_case(bh, s, seed=11 * s, device="cpu", causal=causal)
    got = ep_ref.graph_stats_ref(x, *ep_ref.row_stats_ref(x))
    assert got.shape == (bh, 4)
    np.testing.assert_allclose(
        got.numpy(), ep_ref.attention_graph_stats_ref(x).numpy(), **EP)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jax_ep_ops.attention_graph_stats(jnp.asarray(x.numpy()),
                                         use_pallas=False)), **EP)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_attention_entropy_probe_matches(use_pallas):
    cfg, params, pcfg, pparams = granite()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 64, (2, 160)).astype(np.int32)
    want = jax_tel.attention_entropy_probe(params, jnp.asarray(toks), cfg,
                                           NO_SHARDING, probe_len=128,
                                           use_pallas=use_pallas)
    got = pt_tel.attention_entropy_probe(pparams, torch.from_numpy(toks),
                                         pcfg, probe_len=128)
    assert got.shape == (2 * pcfg.n_heads,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EP)


def test_routing_graph_weights_are_equal():
    cfg, params, pcfg, pparams = granite()
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 64, (4, 48)).astype(np.int32)
    want = jax_tel.routing_graph(params, {"tokens": jnp.asarray(toks)}, cfg,
                                 NO_SHARDING)
    got = pt_tel.routing_graph(pparams, {"tokens": torch.from_numpy(toks)},
                               pcfg)
    assert got.n_nodes == want.n_nodes == pcfg.n_experts
    np.testing.assert_array_equal(got.weights.numpy(),
                                  np.asarray(want.weights))
    assert got.weights.sum().item() == 4 * 48 * 2  # one pair per token


def test_routing_tracker_distances_and_anomalies_match():
    """12 fed co-activation graphs on 40 experts: 11 drifting around one
    routing pattern, then a collapse onto half the experts that the
    z-score flags."""
    rng = np.random.default_rng(8)
    base = rng.integers(0, 50, (40, 40)).astype(np.float32)
    graphs = []
    for i in range(12):
        w = base + rng.integers(0, 80, (40, 40)).astype(np.float32)
        if i == 11:
            w = base.copy()
            w[:, :20] = 0.0
            w[:20, :] = 0.0
        w = np.triu(w, 1)
        graphs.append(w + w.T)
    jt, pt = jax_tel.RoutingGraphTracker(), pt_tel.RoutingGraphTracker()
    for step, w in enumerate(graphs):
        jd = jt.update(JaxDenseGraph(weights=jnp.asarray(w), n_nodes=40),
                       step)
        pd = pt.update(DenseGraph(weights=torch.from_numpy(w), n_nodes=40),
                       step)
        assert (jd is None) == (pd is None) == (step == 0)
    np.testing.assert_allclose(pt.distances, jt.distances, rtol=1e-5,
                               atol=1e-5)
    assert pt.anomalies == jt.anomalies == [11]
    assert pt.update(None, 12) is None
