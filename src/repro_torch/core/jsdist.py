"""Jensen–Shannon graph distance with FINGER-H̃: Algorithm 2 and its
batch counterpart.

The port's copy of the H̃ part of `repro.core.jsdist`:

  JSdiv(G, G')  = H̃(Ḡ) - ½ [H̃(G) + H̃(G')],   Ḡ = (G ⊕ G')/2
  JSdist(G, G') = sqrt(max(JSdiv, 0))

`jsdist_incremental` runs Algorithm 2 — two Theorem-2 updates, ΔG/2 for
Ḡ and ΔG for G' — and works unchanged on a stacked (B, ·) batch.
"""
from __future__ import annotations

from typing import Callable, Tuple, Union

import torch

from repro_torch.core.incremental import update_state
from repro_torch.core.state import FingerState
from repro_torch.core.vnge import vnge_tilde
from repro_torch.graphs.types import DenseGraph, EdgeList, GraphDelta

Graph = Union[DenseGraph, EdgeList]

__all__ = ["average_graph", "js_distance", "jsdist_incremental",
           "jsdist_stream", "jsdist_tilde"]


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
