"""Random-graph generators used in the paper's Section 3 experiments.

The port's copy of `repro.graphs.generators`: Erdős–Rényi (ER),
Barabási–Albert (BA), Watts–Strogatz (WS). Generation is host-side
numpy `default_rng`, so the same seed gives the same graph bit for bit
as the JAX package; outputs are CPU `DenseGraph`s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.types import DenseGraph


def _to_graphs(w: np.ndarray) -> DenseGraph:
    return DenseGraph.from_weights(torch.from_numpy(w.astype(np.float32)))


def erdos_renyi(n: int, p: float, seed: int = 0,
                weighted: bool = False) -> DenseGraph:
    """ER(n, p): every node pair connected independently with prob p."""
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    w = np.triu(upper, k=1).astype(np.float64)
    if weighted:
        w *= rng.uniform(0.5, 1.5, (n, n))
    w = w + w.T
    return _to_graphs(w)


def barabasi_albert(n: int, m_attach: int, seed: int = 0) -> DenseGraph:
    """BA(n, m): preferential attachment; power-law degree distribution."""
    rng = np.random.default_rng(seed)
    m_attach = max(1, min(m_attach, n - 1))
    w = np.zeros((n, n))
    # seed clique of m_attach + 1 nodes
    w[: m_attach + 1, : m_attach + 1] = 1.0
    np.fill_diagonal(w, 0.0)
    deg = w.sum(1)
    repeated = list(np.repeat(np.arange(m_attach + 1), m_attach))
    for v in range(m_attach + 1, n):
        targets: set = set()
        while len(targets) < m_attach:
            targets.add(int(repeated[rng.integers(0, len(repeated))]))
        for t in targets:
            w[v, t] = w[t, v] = 1.0
            repeated.append(t)
            repeated.append(v)
        deg[v] = m_attach
    return _to_graphs(w)


def watts_strogatz(n: int, k: int, p_rewire: float,
                   seed: int = 0) -> DenseGraph:
    """WS(n, k, p): ring lattice with k neighbors, each edge rewired w.p. p."""
    rng = np.random.default_rng(seed)
    w = np.zeros((n, n))
    half = k // 2
    for offset in range(1, half + 1):
        for i in range(n):
            j = (i + offset) % n
            w[i, j] = w[j, i] = 1.0
    # rewire
    for offset in range(1, half + 1):
        for i in range(n):
            j = (i + offset) % n
            if rng.random() < p_rewire and w[i, j] > 0:
                # pick a new endpoint not already adjacent
                for _ in range(16):
                    t = int(rng.integers(0, n))
                    if t != i and w[i, t] == 0:
                        w[i, j] = w[j, i] = 0.0
                        w[i, t] = w[t, i] = 1.0
                        break
    return _to_graphs(w)


def average_degree(g: DenseGraph) -> float:
    w = g.weights.numpy()
    return float((w > 0).sum() / g.n_nodes)


def random_geometric_community(n: int, n_comm: int, p_in: float, p_out: float,
                               seed: int = 0) -> DenseGraph:
    """Planted-partition graph — community structure (BSR-friendly)."""
    rng = np.random.default_rng(seed)
    labels = np.sort(rng.integers(0, n_comm, n))  # contiguous communities
    same = labels[:, None] == labels[None, :]
    p = np.where(same, p_in, p_out)
    upper = rng.random((n, n)) < p
    w = np.triu(upper, 1).astype(np.float64)
    w = w + w.T
    return _to_graphs(w)


def random_geometric_community_edges(n: int, n_comm: int, p_in: float,
                                     p_out: float, seed: int = 0):
    """`random_geometric_community`'s planted partition drawn as an edge
    list, for graphs whose (n, n) matrix does not fit on the host.

    Communities are contiguous, as there (sorted labels drawn from
    ``default_rng(seed)``). The edge counts are binomial over the
    in-community and cross-community pairs with probabilities ``p_in``
    and ``p_out``; each edge's endpoints are drawn uniformly inside its
    community (across communities), self loops dropped and each pair kept
    once, so the draw is not the dense generator's bit for bit and holds
    slightly fewer edges than the binomial counts. Returns ``(lo, hi)``
    int32 numpy arrays, lo < hi, ascending.
    """
    rng = np.random.default_rng(seed)
    labels = np.sort(rng.integers(0, n_comm, n))
    sizes = np.bincount(labels, minlength=n_comm).astype(np.int64)
    starts = np.cumsum(sizes) - sizes
    pairs_in = sizes * (sizes - 1) // 2
    m_in = rng.binomial(int(pairs_in.sum()), p_in) if pairs_in.sum() else 0
    comm = rng.choice(n_comm, m_in, p=pairs_in / max(pairs_in.sum(), 1))
    a_in = starts[comm] + rng.integers(0, sizes[comm])
    b_in = starts[comm] + rng.integers(0, sizes[comm])
    m_out = rng.binomial(n * (n - 1) // 2 - int(pairs_in.sum()), p_out)
    a_out = rng.integers(0, n, m_out)
    b_out = rng.integers(0, n, m_out)
    cross = labels[a_out] != labels[b_out]
    a = np.concatenate([a_in, a_out[cross]])
    b = np.concatenate([b_in, b_out[cross]])
    keep = a != b
    key = np.unique(np.minimum(a, b)[keep] * n + np.maximum(a, b)[keep])
    return (key // n).astype(np.int32), (key % n).astype(np.int32)
