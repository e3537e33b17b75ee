"""Kernel-vs-plain parity for the ``stream_tick`` kernel on the card.

`make_case` builds a seeded synthetic stacked (state, delta) batch that
walks the kernel's edge cases: mixed-n node masks, padded edge lanes and
join slots (id 0, mask or flag 0), ids outside ``[0, n_pad)``, repeated
node ids and duplicate edges, a join and a leave of one node in one
delta, an emptying delta, a revive from empty, an all-masked delta, and
an all-masked delta on an empty graph. ``kind="stress"`` adds rows
8–14 that stress the kernel's split of a stream over one warp (at least
16 streams): a hub whose segment spans all 2k endpoints (every lane a
loop on it), a star whose hub is one endpoint of every lane (a segment
of k endpoints across the lanes), joins of dead nodes that are
endpoints of live lanes and leaves of live endpoints, and all-masked
rows without node slots beside live ones. `STRESS` lists the shapes
the card runs it at: k odd, at the serving k, and above the 256 keys a
warp sorts in registers (the shared-memory sort, and k = 1024 with the
opt-in above 48 KB). `compare` holds the kernel's outputs against the
plain version's (`ref.stream_tick_ref`) on the same inputs. The CUDA
tests and ``chip_smoke.py`` run both.

Tolerance. Carried state: atol 1e-5 with rtol 1e-5 (the reference's
kernel parity tolerance; sums run in another order on the card). Masks:
exact. Scores: the score is sqrt of a divergence that is about 0 on an
unchanged stream, where sqrt magnifies a rounding difference of 1e-10
into 1e-5, so the divergence (score²) is held at atol 1e-5 and the score
itself at atol 1e-5 wherever the divergence exceeds 1e-3.
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
DIV_FLOOR = 1e-3
KINDS = ("edge_cases", "stress")
# label: (B, n_pad, k_pad, j_pad) of the stress case on the card
STRESS = {
    "k=37 ragged n": (64, 333, 37, 3),
    "serving k=128": (256, 1024, 128, 8),
    "k=200 shared-memory sort": (64, 808, 200, 4),
    "k=1024 opt-in": (32, 4104, 1024, 8),
}


def make_case(b: int, n_pad: int, k_pad: int, j_pad: int, seed: int,
              device, out_of_range: bool = True, kind: str = "edge_cases"
              ) -> Tuple[FingerState, GraphDelta]:
    """A seeded (states, deltas) batch of ``b`` ≥ 8 streams; rows 0–7
    hold the named edge cases, with ``kind="stress"`` rows 8–14 the
    stress rows (``b`` ≥ 16), the rest are random. ``out_of_range=False``
    keeps every id inside the layout (the JAX reference clamps such ids
    where the port gates them)."""
    if kind not in KINDS:
        raise ValueError(f"unknown stream_tick case kind {kind!r}")
    if b < (16 if kind == "stress" else 8) or n_pad < 4 * k_pad + 8 \
            or j_pad < 2:
        raise ValueError("make_case needs b >= 8 (16 for the stress rows), "
                         "n_pad >= 4*k_pad + 8 and j_pad >= 2")
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ns = rng.integers(max(n_pad // 4, 2 * k_pad + 4), n_pad + 1, b)
    mask = (np.arange(n_pad)[None, :] < ns[:, None]).astype(f32)
    strengths = (rng.uniform(0.0, 10.0, (b, n_pad)) * mask).astype(f32)
    q = rng.uniform(0.5, 0.99, b).astype(f32)
    k_used = rng.integers(0, k_pad + 1, b)
    lane = np.arange(k_pad)[None, :]
    emask = (lane < k_used[:, None]).astype(f32)
    # a few ids land on inactive slots, or past n_pad when allowed
    hi = (ns + 2 if out_of_range else np.minimum(ns + 2, n_pad))[:, None]
    snd = rng.integers(0, 1 << 30, (b, k_pad)) % hi
    rcv = rng.integers(0, 1 << 30, (b, k_pad)) % hi
    rcv = np.where(rcv == snd, (snd + 1) % n_pad, rcv)
    dw = rng.normal(0.0, 1.0, (b, k_pad)).astype(f32)
    w_old = rng.uniform(0.0, 2.0, (b, k_pad)).astype(f32)
    nid = np.zeros((b, j_pad), np.int64)
    nflag = np.zeros((b, j_pad), f32)
    # random rows: a join of an inactive slot and a leave of a live one
    nid[:, 0] = rng.integers(0, 1 << 30, b) % n_pad
    nflag[:, 0] = 1.0
    nid[:, 1] = rng.integers(0, 1 << 30, b) % ns
    nflag[:, 1] = np.where(rng.random(b) < 0.5, -1.0, 0.0)
    # row 4: ids outside [0, n_pad) on live lanes
    emask[4, :4] = 1.0
    if out_of_range:
        snd[4, :2] = (-3, n_pad + 5)
    # row 5: repeated ids — one node as sender and receiver of several
    # edges, and one edge twice
    emask[5, :6] = 1.0
    snd[5, :6], rcv[5, :6] = (7, 7, 3, 7, 9, 9), (3, 11, 7, 3, 7, 7)
    # row 6: a node that joins and leaves in the same delta
    nid[6, :2], nflag[6, :2] = (ns[6] - 1, ns[6] - 1), (1.0, -1.0)
    # row 7: join slots that are padding except one far join
    nid[7, :], nflag[7, :] = 0, 0.0
    nid[7, -1], nflag[7, -1] = n_pad - 1, 1.0

    # row 0: a delta that deletes every edge of its graph (empty snap)
    m0 = k_pad
    w = rng.uniform(0.5, 1.5, m0).astype(f32)
    strengths[0] = 0.0
    strengths[0, 0:2 * m0:2] = w
    strengths[0, 1:2 * m0:2] = w
    mask[0] = 1.0
    snd[0], rcv[0] = np.arange(0, 2 * m0, 2), np.arange(1, 2 * m0, 2)
    dw[0], w_old[0], emask[0] = -w, w, 1.0
    s2 = float((strengths[0].astype(np.float64) ** 2).sum())
    w2 = float((w.astype(np.float64) ** 2).sum())
    s_tot0 = float(strengths[0].astype(np.float64).sum())
    q[0] = 1.0 - (s2 + 2.0 * w2) / s_tot0 ** 2
    nflag[0] = 0.0
    # rows 1 and 3: empty graphs; row 1 revives with joins and first
    # edges, row 3 gets an all-masked delta
    for r in (1, 3):
        strengths[r] = 0.0
        q[r] = 1.0
    mask[1, :] = 0.0
    mask[1, :4] = 1.0
    snd[1, :3], rcv[1, :3] = (0, 1, 4), (1, 2, 5)
    emask[1] = 0.0
    emask[1, :3] = 1.0
    dw[1, :3], w_old[1, :3] = (1.5, 0.5, 2.0), 0.0
    nid[1, :2], nflag[1, :2] = (4, 5), 1.0
    # row 2: all-masked delta on a live graph; row 3 likewise on empty
    emask[2:4] = 0.0
    nflag[2:4] = 0.0

    keep_ids = [2]  # rows whose masked lanes keep real ids
    if kind == "stress":
        _stress_rows(rng, ns, mask, strengths, snd, rcv, dw, w_old, emask,
                     nid, nflag)
        keep_ids += [11, 13]
    # padded lanes carry id 0; the rows above keep real ids on masked lanes
    pad = emask == 0
    pad[keep_ids] = False
    snd, rcv = np.where(pad, 0, snd), np.where(pad, 0, rcv)
    s_total = strengths.astype(np.float64).sum(1).astype(f32)
    s_max = strengths.max(1)

    def t(x, dtype):
        return torch.from_numpy(np.array(x)).to(
            dtype=dtype, device=device)

    states = FingerState(
        q=t(q, torch.float32), s_total=t(s_total, torch.float32),
        s_max=t(s_max, torch.float32),
        strengths=t(strengths, torch.float32),
        node_mask=t(mask, torch.float32), layout=NodeLayout(n_pad))
    deltas = GraphDelta(
        senders=t(snd, torch.int32), receivers=t(rcv, torch.int32),
        dw=t(dw, torch.float32), w_old=t(w_old, torch.float32),
        mask=t(emask, torch.float32), n_nodes=n_pad,
        node_ids=t(nid, torch.int32), node_flag=t(nflag, torch.float32))
    return states, deltas


def _stress_rows(rng, ns, mask, strengths, snd, rcv, dw, w_old, emask,
                 nid, nflag) -> None:
    """Rows 8–14 of the stress case, in place on the numpy batch."""
    k, j = snd.shape[1], nid.shape[1]
    lanes = np.arange(k)
    emask[8:11] = 1.0
    nflag[8:10] = 0.0
    # row 8: every lane a loop on one hub, so its segment spans all 2k
    # endpoints of the sorted keys
    hub = int(ns[8]) // 2
    snd[8], rcv[8] = hub, hub
    # row 9: a star, its hub one endpoint of every lane
    hub = int(ns[9]) // 3
    other = np.setdiff1d(np.arange(ns[9]), [hub])[:k]
    snd[9] = np.where(lanes % 2 == 0, hub, other)
    rcv[9] = np.where(lanes % 2 == 0, other, hub)
    # row 10: dead nodes join and are endpoints of live lanes; live
    # endpoints leave
    n_live = int(mask.shape[1]) - 8
    mask[10] = 0.0
    mask[10, :n_live] = 1.0
    strengths[10, n_live:] = 0.0
    snd[10] = rng.integers(0, n_live, k)
    rcv[10] = (snd[10] + 1 + rng.integers(0, n_live - 1, k)) % n_live
    joiners = n_live + np.arange(min(j, 3))
    snd[10, :joiners.size] = joiners
    rcv[10, joiners.size] = joiners[0]
    nid[10], nflag[10] = 0, 0.0
    nid[10, :joiners.size - 1] = joiners[:-1]
    nflag[10, :joiners.size - 1] = 1.0
    nid[10, joiners.size - 1] = rcv[10, 0]
    nflag[10, joiners.size - 1] = -1.0
    if j > 3:
        nid[10, 3] = snd[10, k - 1]
        nflag[10, 3] = -1.0
    # rows 11 and 13: every lane masked and no node slot, beside the live
    # random rows 12 and 14
    emask[[11, 13]] = 0.0
    nflag[[11, 13]] = 0.0


def compare(got: Tuple[torch.Tensor, FingerState],
            want: Tuple[torch.Tensor, FingerState],
            label: str = "stream_tick") -> float:
    """Raise if the kernel's tick disagrees with the plain tick; return
    the largest absolute error over the compared outputs."""
    (d_got, s_got), (d_want, s_want) = got, want
    div_got = (d_got.double() ** 2).cpu().numpy()
    div_want = (d_want.double() ** 2).cpu().numpy()
    np.testing.assert_allclose(div_got, div_want, atol=ATOL, rtol=RTOL,
                               err_msg=f"{label}: divergence")
    errs = [np.abs(div_got - div_want).max(initial=0.0)]
    big = div_want > DIV_FLOOR
    dg, dw_ = d_got.cpu().numpy(), d_want.cpu().numpy()
    np.testing.assert_allclose(dg[big], dw_[big], atol=ATOL, rtol=0,
                               err_msg=f"{label}: dist")
    errs.append(np.abs(dg[big] - dw_[big]).max(initial=0.0))
    for field in ("q", "s_total", "s_max", "strengths"):
        # one pull a state field: the fields are separate tensors
        a = getattr(s_got, field).cpu().numpy()  # lint: disable=per-item-host-sync
        w = getattr(s_want, field).cpu().numpy()  # lint: disable=per-item-host-sync
        np.testing.assert_allclose(a, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label}: {field}")
        errs.append(np.abs(a - w).max(initial=0.0))
    np.testing.assert_array_equal(s_got.node_mask.cpu().numpy(),
                                  s_want.node_mask.cpu().numpy(),
                                  err_msg=f"{label}: node_mask")
    return float(max(errs))
