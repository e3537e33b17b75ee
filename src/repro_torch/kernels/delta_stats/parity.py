"""Kernel-vs-plain parity for the ``delta_stats`` kernel on the card.

`make_case` builds a seeded single-stream state on ``n`` nodes and a
delta of ``k`` edges — re-weights, deletions, additions, repeated node
ids, masked lanes, and (``all_masked=True``) a delta whose every lane is
masked, where the max is -inf. `compare` holds the kernel's (4,) stats
against the plain version's on the same sorted-endpoint inputs.

Tolerance: atol 1e-5 with rtol 1e-5, the reference's kernel parity
tolerance (segment and block sums run in another order on the card);
the -inf max of an all-masked delta must match exactly.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.state import FingerState
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta

ATOL = 1e-5
RTOL = 1e-5


def make_case(n: int, k: int, seed: int, device,
              all_masked: bool = False) -> Tuple[FingerState, GraphDelta]:
    """A seeded single-stream (state, delta) pair."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    strengths = rng.uniform(0.0, 10.0, n).astype(f32)
    mask = np.ones(n, f32)
    # a hub: a quarter of the lanes touch node 1 (long segments)
    snd = rng.integers(0, n, k)
    snd[: k // 4] = 1
    rcv = (snd + 1 + rng.integers(0, n - 1, k)) % n
    w_old = np.where(rng.random(k) < 0.7, rng.uniform(0.1, 2.0, k), 0.0)
    dw = np.where(rng.random(k) < 0.3, -w_old, rng.normal(0.0, 1.0, k))
    emask = (rng.random(k) < 0.9).astype(f32)
    if all_masked:
        emask[:] = 0.0
    s_total = strengths.astype(np.float64).sum()

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(
            dtype=dtype, device=device)

    state = FingerState(
        q=t(np.float32(0.9), torch.float32),
        s_total=t(np.float32(s_total), torch.float32),
        s_max=t(strengths.max(), torch.float32),
        strengths=t(strengths, torch.float32),
        node_mask=t(mask, torch.float32), layout=NodeLayout(n))
    delta = GraphDelta(
        senders=t(np.minimum(snd, rcv), torch.int32),
        receivers=t(np.maximum(snd, rcv), torch.int32),
        dw=t(dw.astype(f32), torch.float32),
        w_old=t(w_old.astype(f32), torch.float32),
        mask=t(emask, torch.float32), n_nodes=n)
    return state, delta


def compare(got: torch.Tensor, want: torch.Tensor,
            label: str = "delta_stats") -> float:
    """Raise if the kernel's stats disagree with the plain version's;
    return the largest absolute error over the finite entries."""
    a, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL, err_msg=label)
    fin = np.isfinite(w)
    return float(np.abs(a[fin] - w[fin]).max(initial=0.0))
