"""Jensen–Shannon graph distance: Algorithms 1 (Fast) and 2 (Incremental).

The port's copy of `repro.core.jsdist`:

  JSdiv(G, G')  = H(Ḡ) - ½ [H(G) + H(G')],   Ḡ = (G ⊕ G')/2
  JSdist(G, G') = sqrt(max(JSdiv, 0))

`jsdist_fast` (Algorithm 1) takes the three entropies with FINGER-Ĥ and
`jsdist_exact` with the exact H. `jsdist_incremental` runs Algorithm 2 —
two Theorem-2 updates, ΔG/2 for Ḡ and ΔG for G' — and works unchanged
on a stacked (B, ·) batch.

`average_graph` of two edge lists goes through the dense form, as in
the reference: `jsdist_fast` on edge lists is O(n²) in memory. A caller
with a large graph forms Ḡ's edge list itself (`coalesce_edges` of the
two halved lists).
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from repro_torch.core.incremental import update_state
from repro_torch.core.state import FingerState
from repro_torch.core.vnge import exact_vnge, vnge_hat, vnge_tilde
from repro_torch.graphs.types import DenseGraph, EdgeList, GraphDelta, \
    on_device
from repro_torch.kernels.dispatch import Device

Graph = Union[DenseGraph, EdgeList]

__all__ = ["average_graph", "js_distance", "jsdist_exact", "jsdist_fast",
           "jsdist_incremental", "jsdist_stream", "jsdist_tilde"]


def average_graph(g: Graph, g2: Graph) -> DenseGraph:
    """Ḡ = (G ⊕ G')/2 on the union of the two active node sets; each
    operand's weights are gated by its own mask first."""
    if isinstance(g, EdgeList) and isinstance(g2, EdgeList):
        return average_graph(g.to_dense(), g2.to_dense())
    if isinstance(g, DenseGraph) and isinstance(g2, DenseGraph):
        m1, m2 = g.node_mask, g2.node_mask
        if m1 is None and m2 is None:
            mask = None
        else:
            ones = torch.ones((g.n_nodes,), dtype=g.weights.dtype,
                              device=g.weights.device)
            mask = torch.maximum(ones if m1 is None else m1,
                                 ones if m2 is None else m2)
        return DenseGraph(
            weights=0.5 * (g.masked_weights() + g2.masked_weights()),
            n_nodes=g.n_nodes, node_mask=mask)
    raise TypeError("average_graph: mismatched graph representations")


def js_from_entropies(h_avg, h_a, h_b) -> torch.Tensor:
    """sqrt(max(H(Ḡ) - ½(H(G) + H(G')), 0))."""
    return torch.sqrt(torch.clamp(h_avg - 0.5 * (h_a + h_b), min=0.0))


def js_distance(g: Graph, g2: Graph,
                entropy_fn: Callable[[Graph], torch.Tensor]):
    """JSdist under an arbitrary entropy functional."""
    gbar = average_graph(g, g2)
    return js_from_entropies(entropy_fn(gbar), entropy_fn(g),
                             entropy_fn(g2))


def jsdist_fast(g: Graph, g2: Graph, power_iters: int = 100, x0=None,
                device: Device = None) -> torch.Tensor:
    """Algorithm 1: FINGER-JSdist (Fast), linear complexity via Ĥ; every
    power iteration starts from ``x0`` (default: seed 0)."""
    g, g2 = on_device(g, device), on_device(g2, device)
    return js_distance(g, g2, lambda x: vnge_hat(x, power_iters=power_iters,
                                                 x0=x0))


def jsdist_exact(g: Graph, g2: Graph, device: Device = None) -> torch.Tensor:
    """Exact JSdist via full eigendecompositions (the O(n³) reference)."""
    g, g2 = on_device(g, device), on_device(g2, device)
    return js_distance(g, g2, exact_vnge)


def jsdist_tilde(g: Graph, g2: Graph) -> torch.Tensor:
    """JSdist with H̃ on full graphs (batch counterpart of Algorithm 2)."""
    return js_distance(g, g2, vnge_tilde)


def jsdist_incremental(state: FingerState, delta: GraphDelta,
                       exact_smax: bool = False, method: str = "dense"
                       ) -> Tuple[torch.Tensor, FingerState]:
    """Algorithm 2: (JSdist(G, G ⊕ ΔG), state(G ⊕ ΔG)).

    `GraphDelta.scaled(0.5)` keeps joins and drops leaves for the Ḡ
    update (a leaving node is still in Ḡ with its half-weight edges).
    """
    half_state = update_state(state, delta.scaled(0.5),
                              exact_smax=exact_smax, method=method)
    full_state = update_state(state, delta, exact_smax=exact_smax,
                              method=method)
    dist = js_from_entropies(half_state.h_tilde(), state.h_tilde(),
                             full_state.h_tilde())
    return dist, full_state


def jsdist_stream(init_state: FingerState, deltas: GraphDelta,
                  exact_smax: bool = False, method: str = "dense"
                  ) -> Tuple[torch.Tensor, FingerState]:
    """Algorithm 2 over T deltas stacked on a leading axis.

    Returns the (T,) distances and the final state.
    """
    state = init_state
    dists = []
    for t in range(deltas.dw.shape[0]):
        dist, state = jsdist_incremental(
            state, deltas.map_tensors(lambda x: x[t]),
            exact_smax=exact_smax, method=method)
        dists.append(dist)
    return torch.stack(dists), state
