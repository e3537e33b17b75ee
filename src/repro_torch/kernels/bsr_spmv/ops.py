"""Public ops: BSR SpMV and the BSR-backed power iteration for λ_max.

`bsr_matvec` computes y = W x for W in the ELL-of-blocks layout
(`ref.BsrMatrix`):

- a W on a CUDA device goes to the hand-written kernel
  (`csrc/bsr_spmv.cu`, which replaces the TPU kernel
  `bsr_matvec_pallas`); it takes b = 64 or 128, float32 values, int32
  column ids, int32 counts and a float32 x, all contiguous and 16-byte
  aligned, and refuses anything else by name; a launch CUDA refuses
  raises;
- a W on the CPU goes to the plain version (`ref.bsr_matvec_ref`).

Either way the stripe counts are checked first (`stripe_order`: shape
(n_rb,), int32, each in [0, max_bpr]), which costs one read of them on
the host; the kernel reads only each stripe's real slots, and launches
the stripes in the order `stripe_order` returns (longest first).
`power_iteration_lmax_bsr` checks and orders once per call.

`power_iteration_lmax_bsr` is λ_max of L_N on a BSR W: the strengths
from one W·1 matvec, then ``L_N x = c (s ∘ x − W x)`` in the shared
power iteration (`graphs.spectral.power_iterate`), which reuses each
iteration's last matvec, so a call launches the kernel
``iterations + 2`` times (W·1, the start vector's quotient, one an
iteration), where the reference's loop makes ``2 + 2·iterations``
matvecs. The kernel is deterministic, so the reused product is the one
the reference computes again, bit for bit.

``LAUNCHES["bsr_matvec"]`` counts kernel launches (never plain-version
calls).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.vnge import c_from_s_total
from repro_torch.graphs.spectral import power_iterate, start_vector
from repro_torch.graphs.types import on_device
from repro_torch.kernels import dispatch
from repro_torch.kernels.bsr_spmv.ref import (BsrMatrix, bsr_matvec_ref,
                                              dense_to_bsr, edges_to_bsr)

LAUNCHES = {"bsr_matvec": 0}
BLOCKS = (64, 128)  # the block sizes the kernel is built for

_P, _I = ctypes.c_void_p, ctypes.c_int


def stripe_order(counts: torch.Tensor, max_bpr: int) -> torch.Tensor:
    """Refuse by name counts that are not (n_rb,) int32 in [0, max_bpr];
    return the stripes by descending count (ties in stripe order) as
    int32, the kernel's launch order."""
    if counts.dim() != 1:
        raise ValueError(f"bsr_matvec: counts must be (n_rb,), got shape "
                         f"{tuple(counts.shape)}")
    if counts.dtype != torch.int32:
        raise TypeError(f"bsr_matvec: counts tensor must be torch.int32, "
                        f"got {counts.dtype}")
    if counts.numel() and (int(counts.min()) < 0
                           or int(counts.max()) > max_bpr):
        raise ValueError(
            f"bsr_matvec: counts must lie in [0, max_bpr={max_bpr}], got "
            f"[{int(counts.min())}, {int(counts.max())}]")
    return torch.argsort(counts, descending=True, stable=True) \
        .to(torch.int32)


def bsr_matvec_cuda(values: torch.Tensor, col_ids: torch.Tensor,
                    counts: torch.Tensor, x: torch.Tensor,
                    order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the CUDA kernel: (n_rb, max_bpr, b, b) values, (n_rb,
    max_bpr) col ids, (n_rb,) counts and (n_rb·b,) x → y (n_rb·b,).
    ``order`` is `stripe_order`'s, computed here when not given."""
    if values.device.type != "cuda":
        raise ValueError(f"bsr_matvec kernel needs CUDA tensors, got "
                         f"{values.device}")
    if values.dim() != 4 or values.shape[2] != values.shape[3] \
            or values.shape[2] not in BLOCKS:
        raise ValueError(f"bsr_matvec: values must be (n_rb, max_bpr, b, "
                         f"b) with b in {BLOCKS}, got {tuple(values.shape)}")
    n_rb, max_bpr, b, _ = values.shape
    if order is None:
        order = stripe_order(counts, max_bpr)
    dispatch.check_operands("bsr_matvec", values.device, [
        ("values", values, (n_rb, max_bpr, b, b), torch.float32),
        ("col_ids", col_ids, (n_rb, max_bpr), torch.int32),
        ("counts", counts, (n_rb,), torch.int32),
        ("order", order, (n_rb,), torch.int32),
        ("x", x, (n_rb * b,), torch.float32)])
    for label, t in (("values", values), ("x", x)):
        if t.data_ptr() % 16:
            raise ValueError(f"bsr_matvec: {label} tensor is not 16-byte "
                             "aligned (the kernel reads float4)")
    y = torch.empty((n_rb * b,), dtype=torch.float32, device=x.device)
    fn = dispatch.library()["bsr_spmv"].bsr_matvec_launch
    fn.argtypes = [_P] * 6 + [_I, _I, _I, _P]
    fn.restype = _I
    err = fn(values.data_ptr(), col_ids.data_ptr(), counts.data_ptr(),
             order.data_ptr(), x.data_ptr(), y.data_ptr(), n_rb, max_bpr,
             b, dispatch.stream_handle(x.device))
    dispatch.check_launch("bsr_spmv", err)
    LAUNCHES["bsr_matvec"] += 1
    return y


def bsr_matvec(m: BsrMatrix, x: torch.Tensor,
               order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = W x (n,) on the device of W; ``order`` is
    `stripe_order(m.counts, max_bpr)`, computed (and the counts checked)
    here when not given."""
    if order is None:
        order = stripe_order(m.counts, m.col_ids.shape[1])
    if m.values.device.type == "cpu":
        return bsr_matvec_ref(m, x)
    return bsr_matvec_cuda(m.values, m.col_ids, m.counts, x, order)


def power_iteration_lmax_bsr(m: BsrMatrix, num_iters: int = 100,
                             tol: float = 1e-7, seed: int = 0, x0=None,
                             device: dispatch.Device = None,
                             info: Optional[dict] = None) -> torch.Tensor:
    """λ_max of L_N = (S − W)/trace(L) with W in BSR form, on ``device``
    (``None``: where W lies).

    Padding rows are all-zero and contribute λ = 0, so they never
    perturb λ_max of the PSD matrix. The start vector is ``x0`` or the
    seeded draw of `graphs.spectral.start_vector`, of length ``m.n``.
    """
    m = on_device(m, device)
    dev = m.values.device
    order = stripe_order(m.counts, m.col_ids.shape[1])
    s = bsr_matvec(m, torch.ones((m.n,), dtype=torch.float32, device=dev),
                   order)
    c = c_from_s_total(s.sum())

    def ln_mv(x):
        return c * (s * x - bsr_matvec(m, x, order))

    return power_iterate(ln_mv, start_vector(m.n, seed, x0, dev), num_iters,
                         tol, info)


__all__ = ["BsrMatrix", "bsr_matvec", "dense_to_bsr", "edges_to_bsr",
           "power_iteration_lmax_bsr", "stripe_order"]
