"""Public op: Lemma-1 statistics, Q and H̃ of a dense W in one pass.

`vnge_q_stats` reduces an (n, n) W to ``[S, Σs², Σ_E w², s_max]``:

- a float32 W on a CUDA device goes to one launch of the hand-written
  kernel (`csrc/vnge_q.cu`, which replaces the TPU kernel
  `vnge_q_stats_pallas`); a launch CUDA refuses raises;
- a W on the CPU goes to the plain version (`ref.vnge_q_stats_ref`).

``node_mask`` zeroes inactive rows and columns before the call, as the
reference's `ops.py` does. The kernel masks the ragged edge itself, so
W is not padded to a block multiple. Above n = 128 its blocks write
partials that the last block to finish reduces in index order; the
partials and the device counter that finds that block are a workspace
cached by device and by CUDA stream (`_workspace`), zeroed once, so a
call allocates only its output and two streams never share a counter.
`quadratic_q_dense` and `vnge_tilde_dense` close Lemma 1 and eq. (2) on
the statistics.

``LAUNCHES`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.vnge import _lemma1_cq, h_tilde_from_stat_vector
from repro_torch.kernels import dispatch
from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# (device index, stream handle) → (partials, counter)
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def _blocks(n: int) -> int:
    """Partial rows a launch for n writes (the library's own count)."""
    return int(dispatch.bind("vnge_q", "vnge_q_blocks", (_I,))(n))


def _workspace(device: torch.device, stream: int, blocks: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stream's partials (at least ``blocks`` rows) and its counter;
    the counter is zeroed when it is made, and every launch leaves it
    0."""
    key = (device.index, stream)
    got = _WORKSPACE.get(key)
    if got is None:
        got = (torch.empty((blocks, 4), dtype=torch.float32, device=device),
               torch.zeros((1,), dtype=torch.int32, device=device))
        _WORKSPACE[key] = got
    elif got[0].shape[0] < blocks:
        got = (torch.empty((blocks, 4), dtype=torch.float32, device=device),
               got[1])
        _WORKSPACE[key] = got
    return got


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
    stream = dispatch.stream_handle(w.device)
    partial, counter = _workspace(w.device, stream, _blocks(n))
    out = torch.empty((4,), dtype=torch.float32, device=w.device)
    fn = dispatch.bind("vnge_q", "vnge_q_stats_launch",
                       (_P, _P, _P, _P, _I, _P))
    err = fn(w.data_ptr(), partial.data_ptr(), counter.data_ptr(),
             out.data_ptr(), n, stream)
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
