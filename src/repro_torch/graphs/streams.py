"""Dynamic-graph stream synthesizers for the paper's Section 4 tasks.

The port's copy of `repro.graphs.streams`. The real Wikipedia /
Oregon-AS / Hi-C data are not available offline; these synthesizers make
statistically analogous sequences with *planted* ground truth
(documented per function), which is what the benchmarks score against.
They draw from numpy ``default_rng`` and build host (CPU) graphs, so a
seed gives the reference's sequences bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.graphs.generators import barabasi_albert, erdos_renyi
from repro_torch.graphs.types import DenseGraph, GraphDelta


def _graph(w: np.ndarray) -> DenseGraph:
    """A host DenseGraph of a float32 copy of ``w``."""
    return DenseGraph.from_weights(torch.from_numpy(w.astype(np.float32)))


@dataclass
class GraphSequence:
    """A sequence of graphs with the deltas connecting them."""

    graphs: List[DenseGraph]
    deltas: List[GraphDelta]  # deltas[t]: graphs[t] ⊕ deltas[t] = graphs[t+1]
    anomaly_truth: Optional[np.ndarray] = None  # per-transition score/label


def _delta_between(g0: DenseGraph, g1: DenseGraph,
                   k_pad: Optional[int] = None) -> GraphDelta:
    """Exact ΔG turning g0 into g1 (host-side)."""
    w0 = g0.weights.numpy()
    w1 = g1.weights.numpy()
    diff = w1 - w0
    iu, ju = np.triu_indices(g0.n_nodes, k=1)
    vals = diff[iu, ju]
    nz = np.abs(vals) > 1e-12
    return GraphDelta.from_arrays(
        iu[nz], ju[nz], vals[nz], w0[iu, ju][nz],
        n_nodes=g0.n_nodes, k_pad=k_pad,
    )


def churn_stream(
    n: int = 500,
    p0: float = 0.02,
    steps: int = 40,
    churn_frac: float = 0.01,
    burst_steps: Tuple[int, ...] = (),
    burst_multiplier: float = 10.0,
    seed: int = 0,
    k_pad: Optional[int] = None,
) -> GraphSequence:
    """Wikipedia-like evolving network: background edge churn plus bursty
    'edit storm' months. `anomaly_truth` = per-step fraction of edges
    changed (the VEO-style proxy in the paper's ex-post-facto analysis).
    """
    rng = np.random.default_rng(seed)
    g = erdos_renyi(n, p0, seed=seed)
    w = g.weights.numpy().copy()
    iu, ju = np.triu_indices(n, k=1)
    m_possible = len(iu)
    # Snapshot with a host-side copy: w is mutated in place every step,
    # and a tensor made from the live buffer would share its memory.
    graphs = [_graph(w)]
    deltas, truth = [], []
    if k_pad is None:
        k_pad = int(max(64, m_possible * churn_frac * burst_multiplier * 4))
    for t in range(steps):
        frac = churn_frac * (burst_multiplier if t in burst_steps else 1.0)
        k = max(1, int(m_possible * frac))
        pick = rng.choice(m_possible, size=k, replace=False)
        ii, jj = iu[pick], ju[pick]
        w_old = w[ii, jj]
        # toggle: existing edges are deleted, absent edges are added
        dw = np.where(w_old > 0, -w_old, 1.0).astype(np.float64)
        d = GraphDelta.from_arrays(ii, jj, dw, w_old, n_nodes=n, k_pad=k_pad)
        w[ii, jj] += dw
        w[jj, ii] += dw
        graphs.append(_graph(w))
        deltas.append(d)
        truth.append(k / max(w[w > 0].size / 2.0, 1.0))
    return GraphSequence(graphs, deltas, np.asarray(truth))


def dos_attack_sequence(
    n: int = 600,
    n_graphs: int = 9,
    attack_frac: float = 0.05,
    seed: int = 0,
    k_pad: Optional[int] = None,
) -> Tuple[GraphSequence, int]:
    """Oregon-AS-like peering sequence with one planted DoS event.

    Each snapshot is a BA graph (AS-level router topologies are
    scale-free) with mild natural churn; in one randomly chosen snapshot
    among the first `n_graphs - 1`, X% of nodes all connect to a single
    random target — the paper's synthesized DoS pattern. Returns the
    sequence and the attacked transition index.
    """
    rng = np.random.default_rng(seed)
    base = barabasi_albert(n, 3, seed=seed)
    w = base.weights.numpy().copy()
    attack_at = int(rng.integers(0, n_graphs - 1))
    graphs = [_graph(w)]
    deltas = []
    iu, ju = np.triu_indices(n, k=1)
    if k_pad is None:
        # one common padded shape for the whole sequence: churn toggles
        # plus the worst-case attack fan-in, so every delta keeps the same
        # (k_pad,) shape and a jitted incremental step compiles once.
        churn_k = max(1, int(0.001 * len(iu)))
        k_pad = int(churn_k + max(1, int(attack_frac * n)) + 1)
    for t in range(n_graphs - 1):
        w_new = w.copy()
        # natural churn: ~0.1% of node pairs toggle (AS peering snapshots
        # are comparatively stable month-to-month)
        k = max(1, int(0.001 * len(iu)))
        pick = rng.choice(len(iu), size=k, replace=False)
        ii, jj = iu[pick], ju[pick]
        w_new[ii, jj] = np.where(w_new[ii, jj] > 0, 0.0, 1.0)
        w_new[jj, ii] = w_new[ii, jj]
        if t == attack_at:
            target = int(rng.integers(0, n))
            botnet = rng.choice(np.setdiff1d(np.arange(n), [target]),
                                size=max(1, int(attack_frac * n)),
                                replace=False)
            w_new[botnet, target] = 1.0
            w_new[target, botnet] = 1.0
        g_new = _graph(w_new)
        deltas.append(_delta_between(graphs[-1], g_new, k_pad=k_pad))
        graphs.append(g_new)
        w = w_new
    return GraphSequence(graphs, deltas), attack_at


def hic_bifurcation_sequence(
    n: int = 400,
    n_samples: int = 12,
    bifurcation_at: int = 5,  # 0-based; paper's "6th measurement"
    seed: int = 0,
    k_pad: Optional[int] = None,
) -> GraphSequence:
    """Hi-C-like weighted contact-map sequence with a planted bifurcation.

    Before the bifurcation the sequence drifts smoothly inside
    configuration A (block-diagonal TAD-like structure); at
    `bifurcation_at` the compartment assignment flips for a subset of
    loci and subsequent samples drift inside configuration B. Weighted,
    dense — VEO is blind to it (paper's point), entropy-based JS distance
    is not.
    """
    rng = np.random.default_rng(seed)
    blocks = 8
    labels_a = rng.integers(0, blocks, n)
    labels_b = labels_a.copy()
    flip = rng.choice(n, size=n // 3, replace=False)
    labels_b[flip] = rng.integers(0, blocks, len(flip))

    idx = np.arange(n)
    dist = np.abs(idx[:, None] - idx[None, :]) + 1.0

    def contact_map(labels, log_noise):
        same = labels[:, None] == labels[None, :]
        base = np.where(same, 2.0, 0.15)
        # power-law distance decay along the genome + multiplicative noise
        w = base / dist ** 0.7 * np.exp(log_noise)
        w = np.triu(w, 1)
        w = w + w.T
        return w

    graphs, deltas = [], []
    if k_pad is None:
        # contact maps are dense: the noise perturbs every upper-triangle
        # entry, so pad all deltas to the full n(n-1)/2 — one shape, one
        # compilation of the jitted incremental step.
        k_pad = n * (n - 1) // 2
    # smooth AR(1) measurement noise: consecutive samples drift, so the
    # bifurcation (compartment flip) dominates consecutive JS distances
    rho = 0.9
    log_noise = rng.normal(0.0, 0.25, (n, n))
    for t in range(n_samples):
        labels = labels_a if t <= bifurcation_at else labels_b
        w = contact_map(labels, log_noise)
        g = _graph(w)
        if graphs:
            deltas.append(_delta_between(graphs[-1], g, k_pad=k_pad))
        graphs.append(g)
        log_noise = rho * log_noise + np.sqrt(1 - rho * rho) * \
            rng.normal(0.0, 0.25, (n, n))
    truth = np.zeros(n_samples)
    truth[bifurcation_at + 1] = 1.0
    return GraphSequence(graphs, deltas, truth)
