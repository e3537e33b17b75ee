"""StreamEngine: B independent FINGER streams advanced in lockstep.

The port's counterpart of `repro.engine.stream`. The per-stream state of
Algorithm 2 — (Q, S, s_max) plus the (n_pad,) strengths and node mask —
is stacked along a leading batch axis, and each tick applies one
`GraphDelta` per stream:

  tick : one batched Algorithm-2 step over the B axis. Under
         ``method="fused_tick"`` it is one launch of the `stream_tick`
         kernel (`repro_torch.kernels.stream_tick`); under ``dense`` and
         ``compact`` it is `jsdist_incremental` on the stacked tensors;
         under ``sparse_tick`` it is one launch of the `sparse_tick`
         kernel on a stacked `SparseStreamState` and slot-space deltas.
  run  : T ticks over a stacked (T, B, ·) delta sequence.

Streams need not share a true node count: `init_states` embeds every
graph into one shared `NodeLayout` with a per-stream node mask, and
node joins/leaves are per-stream delta slots. `init_sparse_states`
gives every graph slots in one shared `SparseLayout` and returns the
per-stream `SlotMap`s that translate its virtual deltas.

The engine owns its stacked state: `tick` updates it in place (the
counterpart of JAX's donation), so rebind to the returned state and do
not reuse the one passed in.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.jsdist import jsdist_incremental
from repro_torch.core.sparse import (SlotMap, SparseLayout,
                                     SparseStreamState,
                                     sparse_states_from_graphs)
from repro_torch.core.state import FingerState, finger_state
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.kernels.sparse_tick.ops import sparse_tick_fused
from repro_torch.kernels.stream_tick.ops import stream_tick_fused

METHODS = ("dense", "compact", "fused_tick", "sparse_tick")


def _check_consistent(label: str, kind: str, values) -> None:
    """Raise naming the offending streams when a static field disagrees."""
    values = list(values)
    if not values:
        raise ValueError(f"{label}: empty stream list")
    majority = max(set(values), key=values.count)
    bad = [i for i, v in enumerate(values) if v != majority]
    if bad:
        raise ValueError(
            f"{label} needs a common {kind}, got {majority!r} for most "
            f"streams but {[values[i] for i in bad]!r} for stream(s) "
            f"{bad}; pad every stream to one shared layout "
            f"(thread n_pad/k_pad through the constructors)")


def stack_states(states: Sequence[FingerState]) -> FingerState:
    """[state_b] → stacked FingerState with a leading (B,) axis."""
    states = list(states)
    _check_consistent("stack_states", "n_pad (strengths shape)",
                      (tuple(s.strengths.shape) for s in states))
    _check_consistent("stack_states", "node_mask presence",
                      (s.node_mask is not None for s in states))
    _check_consistent("stack_states", "NodeLayout",
                      (s.layout for s in states))
    fields = states[0].tensors().keys()
    return FingerState(
        **{f: torch.stack([getattr(s, f) for s in states]) for f in fields},
        layout=states[0].layout)


def unstack_states(states: FingerState) -> List[FingerState]:
    """Stacked (B, …) FingerState → list of B per-stream states."""
    return [states.map_tensors(lambda x, i=i: x[i])
            for i in range(states.q.shape[0])]


def stack_deltas(deltas: Sequence[GraphDelta]) -> GraphDelta:
    """[delta_b] → stacked (B, k_pad) GraphDelta; k_pad, n_pad,
    node-slot presence, j_pad, layout generation and edge-slot presence
    must agree."""
    deltas = list(deltas)
    _check_consistent("stack_deltas", "k_pad",
                      (d.dw.shape[-1] for d in deltas))
    _check_consistent("stack_deltas", "n_pad (static n_nodes)",
                      (d.n_nodes for d in deltas))
    _check_consistent("stack_deltas", "node-slot presence",
                      (d.node_ids is not None for d in deltas))
    _check_consistent("stack_deltas", "layout_generation",
                      (d.layout_generation for d in deltas))
    _check_consistent("stack_deltas", "edge_slots presence",
                      (d.edge_slots is not None for d in deltas))
    if deltas[0].node_ids is not None:
        _check_consistent("stack_deltas", "j_pad",
                          (d.node_ids.shape[-1] for d in deltas))
    fields = deltas[0].tensors().keys()
    return GraphDelta(
        **{f: torch.stack([getattr(d, f) for d in deltas]) for f in fields},
        n_nodes=deltas[0].n_nodes,
        layout_generation=deltas[0].layout_generation)


class StreamEngine:
    """Batched Algorithm-2 engine for B concurrent graph streams.

    Parameters
    ----------
    exact_smax : recompute s_max exactly after deletions.
    method : ``"dense"``, ``"compact"``, ``"fused_tick"`` (one
        `stream_tick` kernel launch per tick) or ``"sparse_tick"`` (one
        `sparse_tick` launch per tick on slot-space state).
    device : where the engine runs; ``None`` is CUDA. The engine ticks
        whatever state it is given, which `init_states` places there.
    """

    def __init__(self, exact_smax: bool = False, method: str = "dense",
                 device: Device = None):
        if method not in METHODS:
            raise ValueError(f"StreamEngine: method {method!r} not in "
                             f"{METHODS}")
        self.exact_smax = exact_smax
        self.method = method
        self.device = resolve_device(device)

    # -- construction ----------------------------------------------------
    @staticmethod
    def init_states(graphs, n_pad: Optional[int] = None,
                    layout: Optional[NodeLayout] = None,
                    device: Device = None) -> FingerState:
        """Initial stacked state from B host graphs, placed on
        ``device`` (``None`` is CUDA).

        Each state is computed on the *unpadded* graph and only the
        node-space arrays are embedded into the shared layout, so an
        `EdgeList` batch never builds an (n, n) weight matrix.
        """
        device = resolve_device(device)
        graphs = list(graphs)
        if layout is None:
            layout = NodeLayout(max(g.n_nodes for g in graphs)
                                if n_pad is None else int(n_pad))
        elif n_pad is not None and int(n_pad) != layout.n_pad:
            raise ValueError(
                f"init_states: n_pad={n_pad} conflicts with "
                f"layout.n_pad={layout.n_pad}; pass one or the other")
        too_big = [i for i, g in enumerate(graphs)
                   if g.n_nodes > layout.n_pad]
        if too_big:
            raise ValueError(
                f"init_states: stream(s) {too_big} have n_nodes > "
                f"n_pad={layout.n_pad}")

        def embed(g) -> FingerState:
            st = finger_state(g)
            n = g.n_nodes
            strengths = torch.nn.functional.pad(st.strengths,
                                                (0, layout.n_pad - n))
            mask = layout.embed_mask(g.node_mask, n, strengths.dtype)
            return FingerState(q=st.q, s_total=st.s_total,
                               s_max=st.s_max, strengths=strengths,
                               node_mask=mask, layout=layout)

        return stack_states([embed(g) for g in graphs]).to(device)

    @staticmethod
    def init_sparse_states(graphs, layout: SparseLayout, n_virtual: int,
                           device: Device = None
                           ) -> Tuple[SparseStreamState, List[SlotMap]]:
        """Initial stacked `SparseStreamState` on ``device`` (``None`` is
        CUDA) + per-stream `SlotMap`s, for ``method="sparse_tick"``.

        Every graph's active nodes and edges take slots in the shared
        `SparseLayout`; the host-side maps own all later virtual-id →
        slot translation. ``graphs`` is consumed one at a time.
        """
        device = resolve_device(device)
        states, maps = sparse_states_from_graphs(graphs, layout,
                                                 n_virtual=int(n_virtual))
        return states.to(device), maps

    # -- serving ---------------------------------------------------------
    def tick(self, states: FingerState, deltas: GraphDelta
             ) -> Tuple[torch.Tensor, FingerState]:
        """One serving tick: (B,) JSdist scores + updated stacked state.

        `states` is updated in place under ``fused_tick`` and
        ``sparse_tick``; rebind to the returned state either way.
        """
        deltas = deltas.to(states.strengths.device)
        if self.method == "fused_tick":
            return stream_tick_fused(states, deltas,
                                     exact_smax=self.exact_smax,
                                     inplace=True)
        if self.method == "sparse_tick":
            return sparse_tick_fused(states, deltas,
                                     exact_smax=self.exact_smax,
                                     inplace=True)
        return jsdist_incremental(states, deltas,
                                  exact_smax=self.exact_smax,
                                  method=self.method)

    def run(self, states: FingerState, delta_seq: GraphDelta
            ) -> Tuple[torch.Tensor, FingerState]:
        """T ticks over a stacked (T, B, k_pad) delta sequence → the
        (T, B) distances and the final stacked state."""
        dists = []
        for t in range(delta_seq.dw.shape[0]):
            d, states = self.tick(states,
                                  delta_seq.map_tensors(lambda x: x[t]))
            dists.append(d)
        return torch.stack(dists), states
