"""Kernel-vs-plain parity for the ``vnge_q`` kernel on the card.

`make_case` builds a seeded symmetric, zero-diagonal, nonnegative
(n, n) W and, with ``masked=True``, a node mask with about a quarter of
the nodes inactive. `compare` holds the kernel's (4,) statistics
against the plain version's on the same input.

Tolerance: rtol 3e-5 with atol 1e-5, the reference's own kernel test
(`tests/test_kernels.py::TestVngeQKernel`): row and block sums run in
another order on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

ATOL = 1e-5
RTOL = 3e-5


def make_case(n: int, seed: int, device, masked: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A seeded (W, node mask or None) pair."""
    rng = np.random.default_rng(seed)
    w = np.triu(rng.random((n, n)).astype(np.float32), 1)
    w = w + w.T
    mask = (rng.random(n) < 0.75).astype(np.float32) if masked else None
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return t(w), None if mask is None else t(mask)


def compare(got: torch.Tensor, want: torch.Tensor,
            label: str = "vnge_q") -> float:
    """Raise if the kernel's statistics disagree with the plain
    version's; return the largest absolute error."""
    a, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL, err_msg=label)
    return float(np.abs(a - w).max(initial=0.0))
