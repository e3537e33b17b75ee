"""Public op: Lemma-1 statistics, Q and H̃ of a dense W in one pass.

`vnge_q_stats` reduces an (n, n) W to ``[S, Σs², Σ_E w², s_max]``:

- a float32 W on a CUDA device goes to the hand-written kernel
  (`csrc/vnge_q.cu`, which replaces the TPU kernel
  `vnge_q_stats_pallas`); a launch CUDA refuses raises;
- a W on the CPU goes to the plain version (`ref.vnge_q_stats_ref`).

``node_mask`` zeroes inactive rows and columns before the call, as the
reference's `ops.py` does. The kernel masks the ragged edge itself, so
W is not padded to a block multiple. `quadratic_q_dense` and
`vnge_tilde_dense` close Lemma 1 and eq. (2) on the statistics.

``LAUNCHES`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.vnge import _lemma1_cq, h_tilde_from_stat_vector
from repro_torch.kernels import dispatch
from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int


def vnge_q_stats_cuda(w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous float32 (n, n) W → (4,)."""
    global LAUNCHES
    if w.device.type != "cuda":
        raise ValueError(f"vnge_q kernel needs CUDA tensors, got {w.device}")
    if w.dim() != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"vnge_q: W must be square, got {tuple(w.shape)}")
    n = w.shape[0]
    dispatch.check_operands("vnge_q", w.device,
                            [("W", w, (n, n), torch.float32)])
    lib = dispatch.library()["vnge_q"]
    lib.vnge_q_partial_blocks.argtypes = [_I]
    lib.vnge_q_partial_blocks.restype = _I
    blocks = lib.vnge_q_partial_blocks(n)
    partial = torch.empty((max(blocks, 1), 4), dtype=torch.float32,
                          device=w.device)
    out = torch.empty((4,), dtype=torch.float32, device=w.device)
    fn = lib.vnge_q_stats_launch
    fn.argtypes = [_P, _P, _P, _I, _P]
    fn.restype = _I
    err = fn(w.data_ptr(), partial.data_ptr(), out.data_ptr(), n,
             dispatch.stream_handle(w.device))
    dispatch.check_launch("vnge_q", err)
    LAUNCHES += 1
    return out


def _apply_node_mask(w: torch.Tensor, node_mask) -> torch.Tensor:
    """Zero inactive rows/columns: padded node slots contribute nothing."""
    if node_mask is None:
        return w
    m = node_mask.to(w.dtype)
    return w * m[:, None] * m[None, :]


def vnge_q_stats(w: torch.Tensor,
                 node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, n) W → (4,) [S, Σs², Σ_E w², s_max]."""
    w = _apply_node_mask(w, node_mask)
    if w.device.type == "cpu":
        return vnge_q_stats_ref(w)
    return vnge_q_stats_cuda(w.float().contiguous())


def quadratic_q_dense(w: torch.Tensor,
                      node_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Lemma-1 Q of a dense graph in one pass."""
    stats = vnge_q_stats(w, node_mask=node_mask)
    return _lemma1_cq(stats[0], stats[1], stats[2])[1]


def vnge_tilde_dense(w: torch.Tensor,
                     node_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """FINGER-H̃ (eq. 2) of a dense graph in one pass; 0 when empty."""
    return h_tilde_from_stat_vector(vnge_q_stats(w, node_mask=node_mask))
