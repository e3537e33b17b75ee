"""FingerState: the O(n) sufficient statistics for incremental FINGER.

The port's copy of `repro.core.state`, as a dataclass of tensors. The
fields may carry leading batch axes: the serving engine's stacked state
is a `FingerState` whose ``q`` is (B,) and whose ``strengths`` is
(B, n_pad). ``layout`` names the `NodeLayout` the state is addressed in
(None = legacy unmasked state).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.vnge import (c_from_s_total, h_tilde_from_stats,
                                   strength_stats)
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import DenseGraph, EdgeList, _n_active

Graph = Union[DenseGraph, EdgeList]


@dataclasses.dataclass(frozen=True)
class FingerState:
    """Sufficient statistics of the current graph G for FINGER-H̃ updates."""

    q: torch.Tensor  # Lemma-1 quadratic proxy Q of G
    s_total: torch.Tensor  # S = trace(L) = 1/c
    s_max: torch.Tensor  # largest nodal strength
    strengths: torch.Tensor  # (..., n) nodal strengths of G
    node_mask: Optional[torch.Tensor] = None  # (..., n) 0/1
    layout: Optional[NodeLayout] = None

    @property
    def c(self) -> torch.Tensor:
        return c_from_s_total(self.s_total)

    @property
    def n_pad(self) -> int:
        """The (trailing) node-layout size of the carried strengths."""
        return int(self.strengths.shape[-1])

    def n_active(self) -> torch.Tensor:
        """Number of live node slots (the layout size when unmasked),
        int32 over the leading axes."""
        return _n_active(self.node_mask, self.strengths.shape[:-1],
                         self.n_pad, self.strengths.device)

    def tensors(self) -> dict:
        """The tensor fields by name (an absent mask left out)."""
        out = {f: getattr(self, f)
               for f in ("q", "s_total", "s_max", "strengths")}
        if self.node_mask is not None:
            out["node_mask"] = self.node_mask
        return out

    def map_tensors(self, fn) -> "FingerState":
        """A copy with ``fn`` applied to every tensor field."""
        return dataclasses.replace(
            self, **{k: fn(v) for k, v in self.tensors().items()})

    def to(self, device) -> "FingerState":
        return self.map_tensors(lambda t: t.to(device))

    def h_tilde(self) -> torch.Tensor:
        """H̃(G) = -Q ln(2 c s_max); 0 on an empty graph."""
        return h_tilde_from_stats(self.q, self.s_total, self.s_max)


def finger_state(g: Graph,
                 layout: Optional[NodeLayout] = None) -> FingerState:
    """Build the state from a full graph (one O(n + m) pass), on the
    graph's device."""
    s_total, sum_s2, sum_w2, s_max = strength_stats(g)
    c = c_from_s_total(s_total)
    q = 1.0 - c * c * (sum_s2 + 2.0 * sum_w2)
    if layout is None and g.node_mask is not None:
        layout = g.layout
    if layout is not None and layout.n_pad != g.n_nodes:
        raise ValueError(
            f"finger_state: layout.n_pad={layout.n_pad} != graph "
            f"n_nodes={g.n_nodes}")
    return FingerState(q=q, s_total=s_total, s_max=s_max,
                       strengths=g.strengths(), node_mask=g.node_mask,
                       layout=layout)
