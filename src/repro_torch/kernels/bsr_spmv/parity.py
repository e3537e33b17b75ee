"""Kernel-vs-plain parity for the ``bsr_spmv`` kernel on the card.

`make_case` builds a seeded planted-partition W (contiguous communities
of mean in-community degree about 16, weights in [0.5, 1.5)) in the BSR
layout, and a standard normal x. ``kind`` picks the layout's edge cases:

- ``community``: the general case; a ragged n leaves padded rows;
- ``block_diagonal``: only edges inside aligned b-blocks, so
  ``max_bpr = 1``;
- ``empty_stripe``: the community graph without the edges of stripe 1,
  whose slots are then all padding;
- ``uneven``: strongly uneven stripe counts: stripe 0 is a hub linked to
  every stripe but the last four (its count is ``max_bpr``), the others
  hold 1–3 real slots, and the last stripes none (count 0).

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
    "uneven counts n=2000 b=64": (2000, 64, "uneven"),
    "large n=32768 b=128": (32768, 128, "community"),
}


def make_case(n: int, b: int, seed: int, device,
              kind: str = "community") -> Tuple[BsrMatrix, torch.Tensor]:
    """A seeded (W in BSR form, x) pair on ``device``."""
    if kind == "uneven":
        lo, hi = _uneven_edges(n, b, seed)
        kind = "community"
    else:
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


def _uneven_edges(n: int, b: int, seed: int) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Edges whose BSR stripes hold very uneven counts: stripe 0 links
    to each of stripes 1 .. n_rb − 5 and to itself; an even stripe adds a
    block on its diagonal, a stripe divisible by 5 one to the next
    stripe; the last four stripes hold no edge."""
    rng = np.random.default_rng(seed)
    n_rb = (n + b - 1) // b
    if n_rb < 8:
        raise ValueError("the uneven case needs at least 8 stripes")
    lo, hi = [], []

    def link(r0, r1, count):
        a = r0 * b + rng.integers(0, b, count)
        c = r1 * b + rng.integers(0, b, count)
        ok = (a != c) & (a < n) & (c < n)
        lo.append(a[ok])
        hi.append(c[ok])

    live = n_rb - 4
    link(0, 0, 4 * b)
    for r in range(1, live):
        link(0, r, 3)
        if r % 2 == 0:
            link(r, r, b)
        if r % 5 == 0 and r + 1 < live:
            link(r, r + 1, 2)
    return (np.concatenate(lo).astype(np.int32),
            np.concatenate(hi).astype(np.int32))


def compare(got: torch.Tensor, want: torch.Tensor,
            label: str = "bsr_matvec") -> float:
    """Raise if the kernel's y disagrees with the plain version's;
    return the largest absolute error."""
    a, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL, err_msg=label)
    return float(np.abs(a - w).max(initial=0.0))
