"""Plain PyTorch version of the BSR SpMV y = W x and its layout helpers.

The port's copy of `repro.kernels.bsr_spmv.ref`:

- `BsrMatrix` : the ELL-of-blocks layout, as tensors.
- `dense_to_bsr` : the reference's host algorithm on an (n, n) matrix,
  line for line (blocks kept by ``abs().sum() > 0``, slots in ascending
  column-block order, padding slots with col 0 and zero values), plus
  each stripe's count of real slots, which the reference does not keep.
- `edges_to_bsr` : the same `BsrMatrix` from an edge list, built on the
  device without an (n, n) matrix — the form for graphs of a few hundred
  thousand nodes, where the dense host matrix would be hundreds of GB.
- `bsr_matvec_ref` : the plain version of the kernel. The CPU tests run
  it, and the card compares the CUDA kernel with it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.types import coalesce_edges
from repro_torch.kernels.dispatch import Device, resolve_device


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """ELL-of-blocks sparse layout of a square W.

    values:  (n_rb, max_bpr, b, b) float32 — dense blocks per row stripe
    col_ids: (n_rb, max_bpr) int32 — column-block index of each slot, in
             ascending order; padding slots have col 0 and all-zero
             values, so any id is numerically safe
    counts:  (n_rb,) int32 — the real slots of each stripe: slots
             ``0 .. counts[r] - 1`` hold its blocks in ascending column
             order, the rest is padding (a padding slot at index 0 has
             col 0 like a real block at column 0; only this field, or the
             values, tell them apart)
    n:       padded matrix dimension (n_rb · b)
    n_orig:  original dimension before padding
    """

    values: torch.Tensor
    col_ids: torch.Tensor
    counts: torch.Tensor
    n: int
    n_orig: int

    @property
    def block(self) -> int:
        return self.values.shape[-1]

    def to(self, device) -> "BsrMatrix":
        return dataclasses.replace(self, values=self.values.to(device),
                                   col_ids=self.col_ids.to(device),
                                   counts=self.counts.to(device))


def _target(device: Device, *inputs) -> torch.device:
    """``device`` if given, else where the first tensor input lies; inputs
    without a device (numpy) default to CUDA."""
    if device is None:
        for x in inputs:
            if isinstance(x, torch.Tensor):
                return x.device
    return resolve_device(device)


def dense_to_bsr(w, b: int = 128, device: Device = None) -> BsrMatrix:
    """(n, n) W (numpy or tensor) → `BsrMatrix` on ``device``. Keeps only
    blocks with any nonzero entry. Host-side: a loop over the stripes of
    a dense padded copy, for parity with the reference."""
    dev = _target(device, w)
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    n_orig = w.shape[0]
    n = ((n_orig + b - 1) // b) * b
    wp = np.zeros((n, n), dtype=np.float32)
    wp[:n_orig, :n_orig] = w
    n_rb = n // b
    tiles = wp.reshape(n_rb, b, n_rb, b).transpose(0, 2, 1, 3)
    nz = np.abs(tiles).sum(axis=(2, 3)) > 0  # (rb, cb)
    max_bpr = max(int(nz.sum(axis=1).max()), 1)
    values = np.zeros((n_rb, max_bpr, b, b), dtype=np.float32)
    col_ids = np.zeros((n_rb, max_bpr), dtype=np.int32)
    for r in range(n_rb):
        for k, cidx in enumerate(np.nonzero(nz[r])[0]):
            values[r, k] = tiles[r, cidx]
            col_ids[r, k] = cidx
    counts = nz.sum(axis=1).astype(np.int32)
    return BsrMatrix(torch.from_numpy(values).to(dev),
                     torch.from_numpy(col_ids).to(dev),
                     torch.from_numpy(counts).to(dev), n, n_orig)


def edges_to_bsr(senders, receivers, weights, n: int, b: int = 128,
                 device: Device = None) -> BsrMatrix:
    """Undirected edge list (numpy or tensors; each edge once, or split
    over duplicate lanes) → the `BsrMatrix` that `dense_to_bsr` gives
    for its (n, n) W, on ``device``.

    Zero-weight lanes, self loops and ids outside ``[0, n)`` are dropped
    and duplicates summed (`coalesce_edges`), then both orientations are
    written. Vectorised: one sort of the entries' block keys, no loop
    per slot. Duplicates sum in lane order on the CPU; on the card three
    or more duplicates of one edge may round in another order.
    """
    dev = _target(device, senders, receivers, weights)
    lo, hi, w = coalesce_edges(torch.as_tensor(senders).to(dev),
                               torch.as_tensor(receivers).to(dev),
                               torch.as_tensor(weights).to(dev), n)
    n_pad = ((n + b - 1) // b) * b
    n_rb = n_pad // b
    rows = torch.cat([lo, hi]).long()
    cols = torch.cat([hi, lo]).long()
    blocks, entry_block = torch.unique((rows // b) * n_rb + cols // b,
                                       sorted=True, return_inverse=True)
    stripe = blocks // n_rb
    counts = torch.bincount(stripe, minlength=n_rb)
    max_bpr = max(int(counts.max()) if blocks.numel() else 0, 1)
    slot = torch.arange(blocks.numel(), device=dev) \
        - (torch.cumsum(counts, 0) - counts)[stripe]
    col_ids = torch.zeros((n_rb, max_bpr), dtype=torch.int32, device=dev)
    col_ids[stripe, slot] = (blocks % n_rb).to(torch.int32)
    values = torch.zeros((n_rb * max_bpr * b * b,), dtype=torch.float32,
                         device=dev)
    at = ((stripe[entry_block] * max_bpr + slot[entry_block]) * b
          + rows % b) * b + cols % b
    values[at] = torch.cat([w, w])
    return BsrMatrix(values.view(n_rb, max_bpr, b, b), col_ids,
                     counts.to(torch.int32), n_pad, n)


def bsr_density(m: BsrMatrix) -> float:
    """Stored (padded) blocks' share of the full n × n matrix."""
    n_rb, max_bpr = m.col_ids.shape
    return float(n_rb * max_bpr * m.block * m.block) / float(m.n * m.n)


def bsr_matvec_ref(m: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = W x on the BSR layout, one batched (b, b) @ (b,) product per
    slot, summed in slot order; a stripe adds only its ``counts`` real
    slots (a padding slot would add exact zeros, so y is the same bit for
    bit as the sum over every slot)."""
    b = m.block
    n_rb, max_bpr = m.col_ids.shape
    gathered = x.view(n_rb, b)[m.col_ids.long()]  # (n_rb, max_bpr, b)
    y = torch.zeros((n_rb, b), dtype=torch.float32, device=x.device)
    for k in range(max_bpr):
        part = torch.matmul(m.values[:, k], gathered[:, k, :, None])[..., 0]
        y = torch.where((m.counts > k)[:, None], y + part, y)
    return y.reshape(-1)
