"""Shared helpers of the port's fleet tests: one numpy scenario driven
through the JAX fleet (`repro.fleet`, the reference; its kernel
methods in interpret mode) and the port's (`repro_torch.fleet` on the
CPU), tenant for tenant.

Scores are compared as `test_torch_serving_lifecycle.assert_scores`
does: at atol 1e-5 with rtol 1e-5 (the reference's kernel parity
tolerance), held as divergences (score²) where the divergence is below
1e-3 — the score is the square root of a difference of float32
entropies of order 1, so one ulp there becomes 1e-5 in the score of a
barely changed tenant.
"""
import numpy as np

import repro.fleet as jfleet
import repro.graphs.types as jtypes
import repro_torch.fleet as tfleet
import repro_torch.graphs.types as ttypes

K_PAD, J_PAD = 3, 2
ATOL = RTOL = 1e-5
TYPES = {jfleet: jtypes, tfleet: ttypes}


def weights(n, seed, p=0.4):
    """A seeded symmetric (n, n) float32 weight matrix."""
    rng = np.random.default_rng(seed)
    w = np.triu(rng.random((n, n)) < p, 1) * rng.uniform(0.5, 1.5, (n, n))
    return (w + w.T).astype(np.float32)


def graph(mod, w):
    return TYPES[mod].DenseGraph.from_weights(w)


def edge(n_nodes, seed, scale=2.0, k_pad=K_PAD, j_pad=J_PAD):
    """One added edge between two of the first n_nodes nodes, as the
    `GraphDelta.from_arrays` arguments both packages take."""
    r = np.random.default_rng(seed)
    i, j = sorted(r.choice(n_nodes, 2, replace=False).tolist())
    return dict(senders=[i], receivers=[j],
                dw=[float(r.uniform(0.5, scale))], w_old=[0.0],
                n_nodes=n_nodes, k_pad=k_pad, j_pad=j_pad)


def grow(n_old, n_new, w, k_pad=K_PAD, j_pad=J_PAD):
    """Joins of nodes [n_old, n_new) with an edge 0 — (n_new − 1)."""
    return dict(senders=[0], receivers=[n_new - 1], dw=[w], w_old=[0.0],
                n_nodes=n_new, k_pad=k_pad, j_pad=j_pad,
                join=list(range(n_old, n_new)))


def delta(mod, args):
    a = dict(args)
    return TYPES[mod].GraphDelta.from_arrays(
        a.pop("senders"), a.pop("receivers"), a.pop("dw"), a.pop("w_old"),
        **a)


def two_buckets(mod, method="dense", **kw):
    return mod.FleetConfig(pools=(
        mod.PoolSpec(name="small", n_pad=8, shards=2, streams_per_shard=2,
                     k_pad=K_PAD, j_pad=J_PAD, method=method),
        mod.PoolSpec(name="large", n_pad=32, shards=2, streams_per_shard=2,
                     k_pad=K_PAD, j_pad=J_PAD, method=method),
    ), **kw)


def assert_scores(got: dict, want: dict, label, names=None):
    """Per-tenant scores of the port against the reference's (see the
    module docstring)."""
    for n in (names or want):
        g, w = float(got[n]), float(want[n])
        np.testing.assert_allclose(g * g, w * w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label}: {n} divergence")
        if w * w > 1e-3:
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=f"{label}: {n} score")


class Pair:
    """The JAX fleet and the port's, opened from one config factory and
    driven with the same calls; with ``jax=False`` the port's alone
    (`both` then returns None for the reference)."""

    def __init__(self, make_cfg, restore=False, jax=True):
        self.j = None
        if jax:
            self.j = (jfleet.FingerFleet.restore if restore
                      else jfleet.FingerFleet.open)(make_cfg(jfleet))
        self.t = (tfleet.FingerFleet.restore if restore
                  else tfleet.FingerFleet.open)(make_cfg(tfleet),
                                                device="cpu")

    def both(self, fn):
        """``fn(fleet, mod)`` on the reference, then on the port."""
        return (None if self.j is None else fn(self.j, jfleet),
                fn(self.t, tfleet))

    def admit(self, name, w):
        je, te = self.both(lambda f, m: f.admit(name, graph(m, w)))
        if je is not None:
            assert (te.pool, te.shard, te.slot) == \
                (je.pool, je.shard, je.slot)
        return te

    def ingest(self, spec: dict):
        self.both(lambda f, m: f.ingest(
            {n: delta(m, a) for n, a in spec.items()}))

    def poll(self):
        self.both(lambda f, m: f.poll())

    def tick(self, spec: dict, label, names=None):
        """ingest → poll on both; the scores compared and returned (the
        port's, the reference's)."""
        self.ingest(spec)
        self.poll()
        return self.check(label, names)

    def check(self, label, names=None):
        ts = self.t.scores()
        if self.j is None:
            return ts, None
        js = self.j.scores()
        assert set(ts) == set(js), label
        assert_scores(ts, js, label, names)
        self.check_placements(label)
        return ts, js

    def check_placements(self, label):
        if self.j is None:
            return
        for e in self.j.directory:
            t = self.t.directory.get(e.name)
            assert (t.pool, t.shard, t.slot, t.n_nodes) == \
                (e.pool, e.shard, e.slot, e.n_nodes), (label, e.name)

    def state_bits(self) -> dict:
        """Every live shard's state tensors of the port, on the host."""
        return {(p, s, k): v.cpu().numpy().copy()
                for p, s in self.t.live_shard_ids()
                for k, v in self.t.shard_service(p, s).states()
                .tensors().items()}

    def close(self):
        self.both(lambda f, m: f.close())
