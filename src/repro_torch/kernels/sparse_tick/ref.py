"""Plain PyTorch version of the fused sparse serving tick.

The semantics of one sparse serving tick have one home —
`repro_torch.core.sparse.sparse_jsdist_tick` (two Theorem-2 updates on
the slot-space view, then the edge-store scatter) — and the port writes
it on the trailing axes, so the batched tick is the same function on
stacked (B, ·) or (S, B, ·) tensors. The edge-store scatter drops
`EDGE_SLOT_SENTINEL` and every slot outside ``[0, m_pad)``. It never
builds the TPU kernel's one-hots, so it runs at the serving size on the
card, where `sparse_tick.cu` is compared with it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.sparse import SparseStreamState, sparse_jsdist_tick
from repro_torch.graphs.types import GraphDelta

__all__ = ["sparse_tick_ref"]


def sparse_tick_ref(states: SparseStreamState, deltas: GraphDelta,
                    exact_smax: bool = False
                    ) -> Tuple[torch.Tensor, SparseStreamState]:
    """Batched sparse Algorithm-2 tick: (…) JSdist scores + updated
    states."""
    return sparse_jsdist_tick(states, deltas, exact_smax=exact_smax)
