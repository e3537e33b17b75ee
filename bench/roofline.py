"""The table of peaks and the bytes a tick's inputs need.

`bytes_needed` is frozen: it counts what the inputs of one tick need,
whatever implements the tick, so a share of the roofline reads the same
work after a later change renames, splits, fuses or moves a kernel.

- A stream whose delta is empty (no live lane, no node flag) needs only
  its score written: 4 bytes.
- Any other stream needs its strength and node-mask rows read once
  (2 · n_pad · 4 bytes: the exact s_max reads the whole row), its q,
  s_total and s_max read and written (24), its delta read once
  (20 · k_pad + 8 · j_pad), the row elements that change written once
  (4 bytes for each distinct endpoint of a live lane with a nonzero
  change, and for each distinct node a slot flags) and its score (4).

It counts less than the bytes bound of PERF.md's kernel table, which
writes every element of the rows it names.

`sparse_bytes_needed` is the sparse tick's count beside it, over the
slot space: the same for the n_slots rows, the scalars, the changed row
elements and the score, and 4 bytes for an empty delta; a non-empty
one's delta also carries each lane's edge slot (24 · k_pad + 8 · j_pad
bytes read once), and each live lane writes its edge's weight in the
(m_pad,) edge store (4 bytes; the edge store is never read: ``w_old``
rides in the delta).
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, at its 700 W power limit
PEAK = {"hbm_bytes_per_s": 3.35e12}
F32 = 4


def _distinct(ids: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Distinct kept ids per row of a (B, c) array."""
    marked = np.where(keep, ids.astype(np.int64), -1)
    marked.sort(axis=1)
    new = marked >= 0
    new[:, 1:] &= marked[:, 1:] != marked[:, :-1]
    return new.sum(axis=1)


def bytes_needed(senders: np.ndarray, receivers: np.ndarray,
                 dw: np.ndarray, mask: np.ndarray, node_ids: np.ndarray,
                 node_flag: np.ndarray, n_pad: int) -> int:
    """Bytes one tick's stacked delta needs moved: lane fields (B, k_pad),
    node slots (B, j_pad)."""
    k_pad, j_pad = dw.shape[1], node_ids.shape[1]
    live = mask > 0
    flagged = node_flag != 0
    empty = ~live.any(axis=1) & ~flagged.any(axis=1)
    changed = live & (dw != 0)
    ends = np.concatenate([senders, receivers], axis=1)
    written = _distinct(ends, np.concatenate([changed, changed], axis=1)) \
        + _distinct(node_ids, flagged)
    per_stream = (2 * n_pad * F32 + 6 * F32 + 5 * F32 * k_pad
                  + 2 * F32 * j_pad + F32 * written + F32)
    return int(np.where(empty, F32, per_stream).sum())


def sparse_bytes_needed(senders: np.ndarray, receivers: np.ndarray,
                        dw: np.ndarray, mask: np.ndarray,
                        node_ids: np.ndarray, node_flag: np.ndarray,
                        n_slots: int) -> int:
    """Bytes one tick's stacked delta needs moved by the sparse tick, the
    delta in the reference's dense ids (translation keeps its lanes and
    slots): lane fields (B, k_pad), node slots (B, j_pad)."""
    live = mask > 0
    empty = ~live.any(axis=1) & ~(node_flag != 0).any(axis=1)
    edge_slots = F32 * dw.shape[1] + F32 * live.sum(axis=1)
    return bytes_needed(senders, receivers, dw, mask, node_ids, node_flag,
                        n_slots) + int(np.where(empty, 0, edge_slots).sum())
