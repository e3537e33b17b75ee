"""Plain PyTorch version of the fused batched serving tick.

The semantics of one serving tick have one home —
`repro_torch.core.jsdist.jsdist_incremental` (two Theorem-2 updates,
ΔG/2 for Ḡ and ΔG for G') — and the port writes it on the trailing
axes, so the batched tick is the same function on stacked (B, ·) or
(S, B, ·) tensors. Its dense path uses `scatter_add` and
`scatter_reduce` over the (B, n_pad) rows and never builds the (2k, n)
one-hot or (2k, 2k) matrices of the TPU kernel, so it runs at the
serving size on the card, where `stream_tick.cu` is compared with it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.jsdist import jsdist_incremental
from repro_torch.core.state import FingerState
from repro_torch.graphs.types import GraphDelta

__all__ = ["stream_tick_ref"]


def stream_tick_ref(states: FingerState, deltas: GraphDelta,
                    exact_smax: bool = False, method: str = "dense"
                    ) -> Tuple[torch.Tensor, FingerState]:
    """Batched Algorithm-2 tick: (…) JSdist scores + updated states.

    ``method`` is ``dense`` or ``compact``; both give the same
    statistics.
    """
    return jsdist_incremental(states, deltas, exact_smax=exact_smax,
                              method=method)
