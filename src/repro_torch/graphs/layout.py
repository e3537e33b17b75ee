"""NodeLayout: the shared node-slot layout of a stream batch.

The port's copy of `repro.graphs.layout.NodeLayout`. Every mask-aware
structure — `DenseGraph`/`EdgeList`/`GraphDelta`, `FingerState`, the
stacked serving state — shares one static layout of ``n_pad`` slots per
stream, of which a per-stream ``node_mask`` marks the live subset.
``generation`` counts layout migrations; two layouts are
interchangeable only when ``n_pad`` and ``generation`` both agree.

The migrations' host-side plans are numpy, as in the reference: a
`LayoutCompaction` holds the old→new ``index_map`` of a shrink
(`plan_compaction`, `truncation_plan`), and `compose_index_maps` /
`identity_index_map` chain the maps of successive migrations.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NodeLayout:
    """One shared static node-slot layout (hashable, frozen)."""

    n_pad: int
    generation: int = 0

    def __post_init__(self):
        if self.n_pad <= 0:
            raise ValueError(f"NodeLayout: n_pad must be positive, got "
                             f"{self.n_pad}")
        if self.generation < 0:
            raise ValueError(f"NodeLayout: generation must be >= 0, got "
                             f"{self.generation}")

    def default_mask(self, n_logical: int, dtype=torch.float32,
                     device=None) -> torch.Tensor:
        """[1]*n_logical + [0]*(n_pad - n_logical)."""
        mask = torch.zeros((self.n_pad,), dtype=dtype, device=device)
        mask[:n_logical] = 1
        return mask

    def embed_mask(self, node_mask: Optional[torch.Tensor], n_logical: int,
                   dtype=torch.float32, device=None) -> torch.Tensor:
        """Embed a (n_logical,)-or-(n_pad,) mask (None = all active over
        the first n_logical slots) into this layout; new slots inactive."""
        if n_logical > self.n_pad:
            raise ValueError(
                f"NodeLayout.embed_mask: n_logical={n_logical} exceeds "
                f"n_pad={self.n_pad}")
        if node_mask is None:
            return self.default_mask(n_logical, dtype, device)
        node_mask = torch.as_tensor(node_mask, dtype=dtype, device=device)
        if node_mask.shape[0] == n_logical and self.n_pad > n_logical:
            node_mask = torch.nn.functional.pad(
                node_mask, (0, self.n_pad - n_logical))
        if node_mask.shape[0] != self.n_pad:
            raise ValueError(
                f"NodeLayout.embed_mask: mask length "
                f"{node_mask.shape[0]} fits neither n_logical="
                f"{n_logical} nor n_pad={self.n_pad}")
        return node_mask

    @staticmethod
    def resolve(n_nodes: int, n_pad: Optional[int], node_mask,
                layout: Optional["NodeLayout"] = None,
                kind: str = "graph",
                ) -> Tuple[Optional["NodeLayout"], Optional[torch.Tensor]]:
        """Constructor args → (layout, mask) for the graph classes;
        ``(None, None)`` keeps the legacy unmasked layout."""
        if layout is not None:
            if n_pad is not None and int(n_pad) != layout.n_pad:
                raise ValueError(
                    f"{kind}: n_pad={n_pad} conflicts with "
                    f"layout.n_pad={layout.n_pad}; pass one or the other")
            n_pad = layout.n_pad
        if n_pad is None and node_mask is None:
            return None, None
        if layout is None:
            layout = NodeLayout(int(n_nodes) if n_pad is None
                                else int(n_pad))
        if layout.n_pad < n_nodes:
            raise ValueError(f"{kind}: n_pad={layout.n_pad} < "
                             f"n_nodes={n_nodes}")
        try:
            mask = layout.embed_mask(node_mask, int(n_nodes))
        except ValueError:
            length = torch.as_tensor(node_mask).shape[0]
            raise ValueError(
                f"{kind}: node_mask length {length} != "
                f"n_pad {layout.n_pad}") from None
        return layout, mask

    # -- lifecycle --------------------------------------------------------
    def grown(self, new_n_pad: int) -> "NodeLayout":
        """The next layout after growing to ``new_n_pad`` slots."""
        if new_n_pad <= self.n_pad:
            raise ValueError(
                f"NodeLayout.grown: new_n_pad={new_n_pad} must exceed "
                f"the current n_pad={self.n_pad}")
        return NodeLayout(new_n_pad, generation=self.generation + 1)

    def compacted(self, new_n_pad: int) -> "NodeLayout":
        """The next layout after compacting to ``new_n_pad`` slots."""
        if new_n_pad > self.n_pad:
            raise ValueError(
                f"NodeLayout.compacted: new_n_pad={new_n_pad} exceeds "
                f"the current n_pad={self.n_pad} (use grown())")
        return NodeLayout(new_n_pad, generation=self.generation + 1)


@dataclasses.dataclass(frozen=True)
class LayoutCompaction:
    """Host-side plan of one shrinking layout migration.

    ``index_map[old_slot] == new_slot`` for surviving slots, ``-1`` for
    dropped ones. The renumbering keeps the survivors' order, so
    ``senders < receivers`` survives a remap.
    """

    old: NodeLayout
    new: NodeLayout
    index_map: np.ndarray  # (old.n_pad,) int32, -1 = dropped

    @property
    def keep(self) -> np.ndarray:
        """Surviving old slot ids, in new-slot order (ascending)."""
        return np.nonzero(self.index_map >= 0)[0].astype(np.int32)

    @property
    def n_live(self) -> int:
        return int((self.index_map >= 0).sum())

    @property
    def reclaimed(self) -> int:
        return self.old.n_pad - self.new.n_pad


def plan_compaction(occupancy: np.ndarray, old: NodeLayout,
                    new_n_pad: Optional[int] = None) -> LayoutCompaction:
    """Occupancy vector (slot live in *any* stream) → compaction plan.

    Survivors keep their order and pack to the front; the new layout
    defaults to the live-slot count (at least 1). A ``new_n_pad`` below
    the live count would drop active slots and raises ValueError.
    """
    occupancy = np.asarray(occupancy).astype(bool).ravel()
    if occupancy.shape[0] != old.n_pad:
        raise ValueError(
            f"plan_compaction: occupancy length {occupancy.shape[0]} != "
            f"layout n_pad {old.n_pad}")
    n_live = int(occupancy.sum())
    if new_n_pad is None:
        new_n_pad = max(n_live, 1)
    if new_n_pad < n_live:
        raise ValueError(
            f"plan_compaction: new_n_pad={new_n_pad} < {n_live} live "
            "slot(s); a compaction can never drop an active slot")
    index_map = np.full((old.n_pad,), -1, np.int32)
    index_map[occupancy] = np.arange(n_live, dtype=np.int32)
    return LayoutCompaction(old=old, new=old.compacted(new_n_pad),
                            index_map=index_map)


def truncation_plan(occupancy: np.ndarray, old: NodeLayout,
                    new_n_pad: int) -> LayoutCompaction:
    """A shrink that only cuts the tail: slots [0, new_n_pad) keep their
    ids, slots beyond are dropped (they must all be unoccupied)."""
    occupancy = np.asarray(occupancy).astype(bool).ravel()
    if new_n_pad >= old.n_pad:
        raise ValueError(
            f"truncation_plan: new_n_pad={new_n_pad} does not shrink "
            f"n_pad={old.n_pad}")
    lost = np.nonzero(occupancy[new_n_pad:])[0] + new_n_pad
    if lost.size:
        raise ValueError(
            f"truncation_plan: slot(s) {lost[:8].tolist()} at/above "
            f"new_n_pad={new_n_pad} are still active")
    index_map = np.full((old.n_pad,), -1, np.int32)
    index_map[:new_n_pad] = np.arange(new_n_pad, dtype=np.int32)
    return LayoutCompaction(old=old, new=old.compacted(new_n_pad),
                            index_map=index_map)


def compose_index_maps(first: np.ndarray,
                       second: np.ndarray) -> np.ndarray:
    """old→mid ∘ mid→new → old→new (dropped stays dropped)."""
    first = np.asarray(first, np.int32)
    second = np.asarray(second, np.int32)
    out = np.where(first >= 0, second[np.clip(first, 0, None)],
                   np.int32(-1))
    return out.astype(np.int32)


def identity_index_map(n_pad: int) -> np.ndarray:
    """The map of a pure growth: every old slot keeps its id."""
    return np.arange(n_pad, dtype=np.int32)
