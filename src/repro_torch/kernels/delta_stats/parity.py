"""Kernel-vs-plain parity for the ``delta_stats`` kernel on the card.

`make_case` builds a seeded single-stream state on ``n`` nodes and a
delta of ``k`` edges. ``kind`` picks the delta:

- ``"mixed"``: re-weights, deletions, additions, repeated node ids (a
  quarter of the lanes touch node 1), masked lanes;
- ``"hub"``: every lane touches node 1, so its segment spans k of the
  2k sorted endpoints and one lane sums it;
- ``"repeat"``: ids from four nodes only, so edges repeat across lanes;
- ``"gating"``: a node mask with inactive nodes (the last four never
  active), ids outside [0, n) on some lanes (n, n + 7, -1 … -4), and
  join and leave slots on touched nodes; the ids outside [0, n) land on
  the inactive tail under the JAX package's clamped indexing too, so
  both packages gate them.

``all_masked=True`` masks every lane, where the max is -inf.
`stack_case` stacks seeded cases on leading batch axes. `plain` is the
plain version (`ref.delta_stats_gated_ref`) evaluated in float64 and
rounded to float32, the kernel's own precision (it sums in float64);
`compare` holds the kernel's (..., 4) stats against it.

Tolerance: atol 1e-5 with rtol 1e-5, the reference's kernel parity
tolerance; the -inf max of an all-masked delta must match exactly. The
float64 evaluation keeps the comparison clear of float32 summation
order: ΔS and ΔQ can cancel to near 0 from terms of tens, where two
float32 orders differ by more than 1e-5 (seen on the card in 2 of 1024
streams at k = 128 against the float32 plain version).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.state import FingerState
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.delta_stats.ref import delta_stats_gated_ref

ATOL = 1e-5
RTOL = 1e-5
KINDS = ("mixed", "hub", "repeat", "gating")


def make_case(n: int, k: int, seed: int, device, all_masked: bool = False,
              kind: str = "mixed") -> Tuple[FingerState, GraphDelta]:
    """A seeded single-stream (state, delta) pair."""
    if kind not in KINDS:
        raise ValueError(f"unknown delta_stats case kind {kind!r}")
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
    node_ids = node_flag = None
    if kind == "hub":
        snd[:] = 1
        rcv = 2 + rng.integers(0, n - 2, k)
    elif kind == "repeat":
        snd = rng.integers(0, 2, k)
        rcv = 2 + rng.integers(0, 2, k)
    elif kind == "gating":
        mask = (rng.random(n) < 0.75).astype(f32)
        mask[:2] = 1.0
        mask[-4:] = 0.0
        strengths = strengths * mask
        bad = rng.random(k) < 0.15
        snd = np.where(bad, rng.choice([n, n + 7, -1, -2, -3, -4], k), snd)
        inactive = np.flatnonzero(mask[: n - 4] == 0)
        join = inactive[:2] if len(inactive) >= 2 else np.array([2, 3])
        rcv[2:4] = join[: len(rcv[2:4])]
        leave = np.flatnonzero(mask[2: n - 4] > 0)[:1] + 2
        node_ids = np.array([join[0], join[1], leave[0], 0], np.int32)
        node_flag = np.array([1.0, 1.0, -1.0, 0.0], f32)
    if all_masked:
        emask[:] = 0.0
    lo = np.where(snd < 0, snd, np.minimum(snd, rcv))
    hi = np.where(snd < 0, rcv, np.maximum(snd, rcv))
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
        senders=t(lo, torch.int32), receivers=t(hi, torch.int32),
        dw=t(dw.astype(f32), torch.float32),
        w_old=t(w_old.astype(f32), torch.float32),
        mask=t(emask, torch.float32), n_nodes=n,
        node_ids=None if node_ids is None else t(node_ids, torch.int32),
        node_flag=None if node_flag is None else t(node_flag,
                                                   torch.float32))
    return state, delta


def stack_case(n: int, k: int, lead: Tuple[int, ...], seed: int, device,
               kind: str = "mixed") -> Tuple[torch.Tensor, GraphDelta]:
    """(lead..., n) strengths and a delta of (lead..., k) lanes from
    math.prod(lead) seeded cases (seeds ``seed``, ``seed + 1``, …), the
    first one all-masked; no node slots."""
    cases = [make_case(n, k, seed + i, device, all_masked=i == 0,
                       kind=kind) for i in range(math.prod(lead))]
    strengths = torch.stack([s.strengths for s, _ in cases])
    fields = {f: torch.stack([getattr(d, f) for _, d in cases])
              .reshape(*lead, k)
              for f in ("senders", "receivers", "dw", "w_old", "mask")}
    return strengths.reshape(*lead, n), GraphDelta(**fields, n_nodes=n)


def plain(strengths: torch.Tensor, delta: GraphDelta) -> torch.Tensor:
    """The plain version in float64, rounded to float32 → (..., 4)."""
    wide = delta.map_tensors(
        lambda t: t.double() if t.is_floating_point() else t)
    return delta_stats_gated_ref(strengths.double(), wide).float()


def compare(got: torch.Tensor, want: torch.Tensor,
            label: str = "delta_stats") -> float:
    """Raise if the kernel's stats disagree with the plain version's;
    return the largest absolute error over the finite entries."""
    a, w = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL, err_msg=label)
    fin = np.isfinite(w)
    return float(np.abs(a[fin] - w[fin]).max(initial=0.0))
