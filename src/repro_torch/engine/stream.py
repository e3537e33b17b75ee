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

Restartable serving: `save` / `restore` persist the stacked state
through `train.checkpoint` in the reference's on-disk format (the
arrays named as the JAX pytree flattening names a stacked state's
leaves, ``0`` … ``5``, and the reference's manifest keys), so a
checkpoint written by either package restores in the other, and a
`FingerService` checkpoint restores into a bare engine.

Multi-device: `shard_states` splits a stacked state by rows over a
`DeviceGrid` axis and `make_sharded_tick` ticks each shard on its
device (the streams are independent, so no collective); `restore`
takes ``grid=`` to come back sharded.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.jsdist import jsdist_incremental
from repro_torch.core.sparse import (SlotMap, SparseLayout,
                                     SparseStreamState,
                                     sparse_states_from_graphs)
from repro_torch.core.state import FingerState, finger_state
from repro_torch.distributed.sharding import (Axes, DeviceGrid, Sharded,
                                              device_context, split_rows)
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.kernels.sparse_tick.ops import sparse_tick_fused
from repro_torch.kernels.stream_tick.ops import stream_tick_fused
from repro_torch.train.checkpoint import (latest_checkpoint, load_manifest,
                                          restore_checkpoint,
                                          save_checkpoint)

METHODS = ("dense", "compact", "fused_tick", "sparse_tick")
CKPT_KIND = "stream_engine_state"

State = Union[FingerState, SparseStreamState]


def state_tree(states: State) -> dict:
    """A stacked state's tensors by the names JAX's pytree flattening
    gives its leaves: the field's position, ``"0"`` (q) to ``"4"``
    (node_mask, when present) and ``"5"`` (edge_weights, sparse)."""
    return {str(i): t for i, t in enumerate(states.tensors().values())}


def restore_stacked_state(ckpt_dir: str, *, exact_smax: bool,
                          method: str) -> Tuple[State, int, dict]:
    """Latest checkpoint → (stacked state on the CPU, step, metadata).

    The manifest's layout fields rebuild the state without a template,
    and the saved engine config is checked against the restoring one.
    Shared by `StreamEngine.restore` and `FingerService.restore`.
    """
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(
            f"restore: no checkpoint under {ckpt_dir!r}")
    manifest = load_manifest(path)
    meta = manifest["metadata"]
    if meta.get("kind") != CKPT_KIND:
        raise ValueError(
            f"restore: {path!r} is not a FINGER serving checkpoint "
            f"(kind={meta.get('kind')!r})")
    for key, want in (("exact_smax", exact_smax), ("method", method)):
        if key in meta and meta[key] != want:
            raise ValueError(
                f"restore: checkpoint was saved with {key}="
                f"{meta[key]!r} but this engine uses {want!r}; "
                "resuming across configs breaks the identical-"
                "scores guarantee — construct the engine with the "
                "saved config")
    b, n_pad = int(meta["b"]), int(meta["n_pad"])
    sp = meta.get("sparse")
    if sp is not None:
        layout = SparseLayout(int(sp["n_slots"]), int(sp["m_pad"]),
                              generation=int(sp["generation"]))
        shapes = [(b,)] * 3 + [(b, layout.n_slots)] * 2 \
            + [(b, layout.m_pad)]
    else:
        has_mask = bool(meta.get("has_node_mask"))
        # older manifests predate migrations: generation 0
        layout = NodeLayout(n_pad, generation=int(
            meta.get("layout_generation", 0))) if has_mask else None
        shapes = [(b,)] * 3 + [(b, n_pad)] * (2 if has_mask else 1)
    template = {str(i): torch.empty(s) for i, s in enumerate(shapes)}
    tree, manifest = restore_checkpoint(path, template, manifest=manifest)
    fields = [tree[str(i)] for i in range(len(shapes))]
    if sp is not None:
        states = SparseStreamState(*fields, layout=layout)
    else:
        states = FingerState(*fields, layout=layout)
    return states, int(manifest["step"]), meta


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

    # -- persistence -----------------------------------------------------
    def save(self, ckpt_dir: str, states: State, step: int = 0,
             metadata: Optional[dict] = None, prune_policy=3) -> str:
        """Persist the stacked state (atomic write, ``prune_policy`` as
        in `train.checkpoint`). Waits for the device's streams first:
        the ticks update the state in place."""
        if states.q.device.type == "cuda":
            torch.cuda.synchronize(states.q.device)
        # reserved keys win over the caller's metadata
        meta = dict(metadata or {})
        meta.update({
            "kind": CKPT_KIND,
            "b": int(states.q.shape[0]),
            "n_pad": int(states.strengths.shape[-1]),
            "has_node_mask": states.node_mask is not None,
            "layout_generation": (states.layout.generation
                                  if states.layout is not None else 0),
            "exact_smax": self.exact_smax,
            "method": self.method,
        })
        if isinstance(states, SparseStreamState):
            # n_pad above is the slot width; the SlotMaps ride in the
            # caller's metadata ("slot_maps", from FingerService.save)
            meta["sparse"] = {
                "n_slots": int(states.layout.n_slots),
                "m_pad": int(states.layout.m_pad),
                "generation": int(states.layout.generation),
            }
        return save_checkpoint(ckpt_dir, step, state_tree(states),
                               metadata=meta, prune_policy=prune_policy)

    def restore(self, ckpt_dir: str, grid: Optional[DeviceGrid] = None,
                axis: Axes = "data") -> Tuple[Union[State, Sharded], int]:
        """The stacked state of the latest checkpoint and its step: on
        this engine's device, or split over ``grid``'s ``axis`` (the
        saving job's placement does not matter: the arrays come back on
        the host and are laid out anew)."""
        states, step, _ = restore_stacked_state(
            ckpt_dir, exact_smax=self.exact_smax, method=self.method)
        if grid is not None:
            return self.shard_states(states, grid, axis), step
        return states.to(self.device), step

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

    # -- multi-device ----------------------------------------------------
    @staticmethod
    def shard_states(states: State, grid: DeviceGrid,
                     axis: Axes = "data") -> Sharded:
        """The stacked state split by rows over ``grid``'s ``axis`` (an
        axis name, or a tuple of names in mixed-radix order), each
        shard's block on its device and owning its storage."""
        return split_rows(states, grid.shard_devices(axis))

    def make_sharded_tick(self, grid: DeviceGrid, axis: Axes = "data"):
        """A tick with the streams split over ``grid``'s ``axis``:
        ``(Sharded states, deltas) → (Sharded scores, Sharded states)``,
        where ``deltas`` is `Sharded` alike or one stacked delta (split
        here). Each shard runs this engine's tick over its B/p streams on
        its device (one kernel launch a shard under ``fused_tick`` and
        ``sparse_tick``). Every shard's tick is enqueued before anything
        waits, so shards on several cards overlap and logical shards on
        one card run in order on its current stream."""
        devices = grid.shard_devices(axis)

        def tick(states: Sharded, deltas):
            if not isinstance(deltas, Sharded):
                deltas = split_rows(deltas, devices)
            if not states.num_shards == deltas.num_shards == len(devices):
                raise ValueError(
                    f"sharded tick over {len(devices)} shard(s) got "
                    f"{states.num_shards} state and {deltas.num_shards} "
                    "delta block(s)")
            scores, out = [], []
            for dev, st, d in zip(devices, states.parts, deltas.parts):
                with device_context(dev):
                    sc, st = self.tick(st, d)
                scores.append(sc)
                out.append(st)
            return (Sharded(tuple(scores), states.rows),
                    Sharded(tuple(out), states.rows))

        return tick

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
