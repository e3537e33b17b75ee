"""Kernel-vs-plain parity for the ``entropy_probe`` kernels on the card.

`make_case` builds seeded (BH, S, S) attention logits, by default with
the causal -1e30 mask the training probe applies (every row keeps its
diagonal). `compare` holds a tuple of kernel outputs against the plain
versions' — the row stats (row max, exp-sum) on the logits, or the
graph stats, the closed (BH, 4) statistics, on the same logits and row
stats.

Tolerance: rtol 5e-4 with atol 1e-5, the reference's own kernel test
(`tests/test_kernels.py::TestEntropyProbe`): the exp-sums and the tile
and column sums run in another order on the card.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

ATOL = 1e-5
RTOL = 5e-4


def make_case(bh: int, s: int, seed: int, device,
              causal: bool = True) -> torch.Tensor:
    """Seeded (BH, S, S) float32 logits, N(0, 2²), causal-masked."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 2.0, (bh, s, s)).astype(np.float32)
    if causal:
        x = np.where(np.tril(np.ones((s, s), bool)), x,
                     np.float32(-1e30))
    return torch.from_numpy(x).to(device)


def compare(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor],
            label: str = "entropy_probe") -> float:
    """Raise if any output disagrees with its plain version; return the
    largest absolute error over them."""
    pairs = [(g.cpu().numpy(), w.cpu().numpy()) for g, w in zip(got, want)]
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label} output {i}")
    return float(max((np.abs(a - b).max(initial=0.0) for a, b in pairs),
                     default=0.0))
