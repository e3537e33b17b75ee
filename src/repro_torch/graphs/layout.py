"""NodeLayout: the shared node-slot layout of a stream batch.

The port's copy of `repro.graphs.layout.NodeLayout`. Every mask-aware
structure — `DenseGraph`/`EdgeList`/`GraphDelta`, `FingerState`, the
stacked serving state — shares one static layout of ``n_pad`` slots per
stream, of which a per-stream ``node_mask`` marks the live subset.
``generation`` counts layout migrations; two layouts are
interchangeable only when ``n_pad`` and ``generation`` both agree.

Compaction plans (`plan_compaction`, `truncation_plan`, index maps)
belong to the layout migrations, which the port has not reached yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
