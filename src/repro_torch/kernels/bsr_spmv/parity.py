"""Kernel-vs-plain parity for the ``bsr_spmv`` kernel on the card.

`make_case` builds a seeded planted-partition W (contiguous communities
of mean in-community degree about 16, weights in [0.5, 1.5)) in the BSR
layout, and a standard normal x. ``kind`` picks the layout's edge cases:

- ``community``: the general case; a ragged n leaves padded rows;
- ``block_diagonal``: only edges inside aligned b-blocks, so
  ``max_bpr = 1``;
- ``empty_stripe``: the community graph without the edges of stripe 1,
  whose slots are then all padding.

Cases up to 4096 nodes go through `dense_to_bsr`, larger ones through
`edges_to_bsr`. `CASES` lists the ones ``chip_smoke.py`` phase 2 runs.
`compare` holds the kernel's y against the plain version's.

Tolerance: atol 1e-5 with rtol 1e-5, the port's parity tolerance
(`tests/_torch_parity.py`); the kernel sums each row's products in
another order than the plain version's batched products.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.graphs.generators import random_geometric_community_edges
from repro_torch.kernels.bsr_spmv.ref import (BsrMatrix, dense_to_bsr,
                                              edges_to_bsr)

ATOL = 1e-5
RTOL = 1e-5
# label: (n, b, kind)
CASES = {
    "ragged n=300 b=128": (300, 128, "community"),
    "b=64 n=1000": (1000, 64, "community"),
    "max_bpr=1 n=512 b=128": (512, 128, "block_diagonal"),
    "padding-only stripe n=512 b=64": (512, 64, "empty_stripe"),
    "large n=32768 b=128": (32768, 128, "community"),
}


def make_case(n: int, b: int, seed: int, device,
              kind: str = "community") -> Tuple[BsrMatrix, torch.Tensor]:
    """A seeded (W in BSR form, x) pair on ``device``."""
    n_comm = max(4, n // 1024)
    size = n / n_comm
    cross = 0.05  # mean cross-community degree
    lo, hi = random_geometric_community_edges(
        n, n_comm, min(1.0, 16.0 / size), cross / n, seed=seed)
    if kind == "block_diagonal":
        keep = lo // b == hi // b
    elif kind == "empty_stripe":
        keep = (lo // b != 1) & (hi // b != 1)
    elif kind == "community":
        keep = np.ones(lo.shape, bool)
    else:
        raise ValueError(f"unknown bsr_spmv case kind {kind!r}")
    lo, hi = lo[keep], hi[keep]
    rng = np.random.default_rng(seed + 1)
    w = rng.uniform(0.5, 1.5, lo.shape).astype(np.float32)
    if n <= 4096:
        dense = np.zeros((n, n), np.float32)
        dense[lo, hi] = w
        dense[hi, lo] = w
        m = dense_to_bsr(dense, b=b, device=device)
    else:
        m = edges_to_bsr(lo, hi, w, n, b=b, device=device)
    x = rng.standard_normal(m.n).astype(np.float32)
    return m, torch.from_numpy(x).to(device)


def compare(got: torch.Tensor, want: torch.Tensor,
            label: str = "bsr_matvec") -> float:
    """Raise if the kernel's y disagrees with the plain version's;
    return the largest absolute error."""
    a, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL, err_msg=label)
    return float(np.abs(a - w).max(initial=0.0))
