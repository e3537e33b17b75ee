"""The port's stream synthesizers and baseline methods against the JAX
reference, on the CPU.

`graphs/streams.py` draws from numpy ``default_rng`` in both packages,
so each sequence (graphs, deltas, planted truth) must be the same bit
for bit. The six baseline modules (DeltaCon and RMD, the three
degree-distribution distances, GED, λ-distance, VEO, VNGE-NL/GL) are
held at atol 1e-5 with rtol 1e-5 (`_torch_parity.assert_close`) on
pairs of consecutive graphs of those sequences.

λ-distance is the norm of a difference of top-k eigenvalues taken by
two different float32 eigensolvers; each eigenvalue agrees at rtol 1e-5,
but the distance between nearly equal spectra is small, so their
absolute errors do not shrink with it. Its test holds the eigenvalues at
rtol 1e-5 and the distance within the triangle-inequality bound those
errors allow, ‖δe₁‖ + ‖δe₂‖ (plus atol 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines as jbase
import repro_torch.baselines as tbase
from repro.baselines import lambda_dist as jld
from repro.baselines import vnge_variants as jvv
from repro.graphs import streams as jstreams
from repro_torch.baselines import lambda_dist as tld
from repro_torch.baselines import vnge_variants as tvv
from repro_torch.graphs import streams as tstreams
from _torch_parity import assert_close

DELTA_FIELDS = ("senders", "receivers", "dw", "w_old", "mask")

STREAMS = {
    "churn": ("churn_stream", dict(n=80, steps=6, burst_steps=(3,),
                                   burst_multiplier=8.0, seed=2)),
    "dos": ("dos_attack_sequence", dict(n=120, attack_frac=0.1, seed=4)),
    "hic": ("hic_bifurcation_sequence", dict(n=60, n_samples=5,
                                             bifurcation_at=2, seed=1)),
}


def _sequences(name):
    fn, kw = STREAMS[name]
    want = getattr(jstreams, fn)(**kw)
    got = getattr(tstreams, fn)(**kw)
    return got, want


@pytest.mark.parametrize("name", list(STREAMS))
def test_streams_reproduce_bit_for_bit(name):
    got, want = _sequences(name)
    if name == "dos":
        (got, at_got), (want, at_want) = got, want
        assert at_got == at_want
    assert len(got.graphs) == len(want.graphs)
    for a, b in zip(got.graphs, want.graphs):
        assert a.n_nodes == b.n_nodes
        np.testing.assert_array_equal(a.weights.numpy(), np.array(b.weights))
    assert len(got.deltas) == len(want.deltas)
    for a, b in zip(got.deltas, want.deltas):
        for f in DELTA_FIELDS:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.array(getattr(b, f)), f)
    if want.anomaly_truth is None:
        assert got.anomaly_truth is None
    else:
        np.testing.assert_array_equal(got.anomaly_truth,
                                      want.anomaly_truth)


def _pairs(name):
    """Consecutive graph pairs of a sequence in both packages."""
    got, want = _sequences(name)
    if name == "dos":
        got, want = got[0], want[0]
    return [((want.graphs[t], want.graphs[t + 1]),
             (got.graphs[t], got.graphs[t + 1]))
            for t in range(len(want.graphs) - 1)]


BASELINES = ["deltacon_distance", "deltacon_similarity", "rmd_distance",
             "cosine_distance", "bhattacharyya_distance",
             "hellinger_distance", "graph_edit_distance", "veo_score"]


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("fn", BASELINES)
def test_baseline_scores_match(stream, fn):
    for (ja, jb), (ta, tb) in _pairs(stream):
        assert_close(getattr(tbase, fn)(ta, tb),
                     getattr(jbase, fn)(ja, jb), f"{fn} {stream}")


@pytest.mark.parametrize("matrix,k", [("adj", 6), ("lap", 4)])
@pytest.mark.parametrize("stream", list(STREAMS))
def test_lambda_distance_matches(stream, matrix, k):
    mats = {"adj": lambda g: g.weights,
            "lap": lambda g: jnp.diag(g.weights.sum(1)) - g.weights}
    for (ja, jb), (ta, tb) in _pairs(stream):
        errs = []
        for jg, tg in ((ja, ta), (jb, tb)):
            want = np.array(jld._topk_eigs(mats[matrix](jg), k))
            tm = torch.from_numpy(np.array(mats[matrix](jg)))
            got = tld._topk_eigs(tm, k).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
            errs.append(np.linalg.norm(got.astype(np.float64) - want))
        got = float(tbase.lambda_distance(ta, tb, k=k, matrix=matrix))
        want = float(jbase.lambda_distance(ja, jb, k=k, matrix=matrix))
        assert abs(got - want) <= sum(errs) + 1e-5, (got, want, errs)


@pytest.mark.parametrize("stream", list(STREAMS))
def test_vnge_variants_match(stream):
    for (ja, jb), (ta, tb) in _pairs(stream):
        assert_close(tbase.vnge_nl(ta), jbase.vnge_nl(ja), "nl")
        assert_close(tbase.vnge_gl(ta), jbase.vnge_gl(ja), "gl")
        for kind in ("nl", "gl"):
            assert_close(tvv.vnge_variant_score(ta, tb, kind),
                         jvv.vnge_variant_score(ja, jb, kind), kind)


def test_lambda_distance_refuses_an_unknown_matrix():
    (_, _), (ta, tb) = _pairs("churn")[0]
    with pytest.raises(ValueError, match="unknown matrix"):
        tbase.lambda_distance(ta, tb, matrix="normalized")


def test_degree_histogram_clips_to_the_last_bin():
    w = np.ones((12, 12), np.float32) - np.eye(12, dtype=np.float32)
    from repro.graphs.types import DenseGraph as JDense
    from repro_torch.graphs.types import DenseGraph as TDense

    ja, ta = JDense.from_weights(jnp.asarray(w)), \
        TDense.from_weights(torch.from_numpy(w))
    jb = JDense.from_weights(jnp.zeros((12, 12)))
    tb = TDense.from_weights(torch.zeros((12, 12)))
    for fn in ("cosine_distance", "bhattacharyya_distance",
               "hellinger_distance"):
        assert_close(getattr(tbase, fn)(ta, tb, n_bins=4),
                     getattr(jbase, fn)(ja, jb, n_bins=4), fn)
