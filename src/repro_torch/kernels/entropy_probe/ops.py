"""Public op: per-head attention-graph VNGE statistics and entropies.

`attention_graph_stats` takes (BH, S, S) attention logits to the Lemma-1
statistics ``[S_tot, Σs², Σ_E w², s_max]`` of each head's symmetrized
zero-diagonal attention graph W = (A + Aᵀ)/2, A = softmax(logits):

- float32 logits on a CUDA device go to the two hand-written kernels
  (`csrc/entropy_probe.cu`, which replace the TPU kernels
  `_row_stats_kernel` and `_graph_stats_kernel` of
  `attention_graph_stats_pallas`); A is never written to device memory,
  and a launch CUDA refuses raises;
- logits on the CPU go to the kernels' plain versions (`ref.py`).

Either way the closing algebra below (the reference's `ops.py:25-33`)
turns the kernels' outputs into the statistics. Unlike the reference,
there is no ``use_pallas`` knob and no quiet plain path for an S that
is not a multiple of the tile: the kernel masks a ragged S itself.

``LAUNCHES`` counts launches of each kernel by name (never
plain-version calls).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.entropy_probe.ref import (entropy_from_stats,
                                                   graph_stats_ref,
                                                   row_stats_ref)

LAUNCHES = {"row_stats": 0, "graph_stats": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check_logits(name: str, logits: torch.Tensor) -> Tuple[int, int]:
    if logits.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{logits.device}")
    if logits.dim() != 3 or logits.shape[1] != logits.shape[2]:
        raise ValueError(f"{name}: logits must be (BH, S, S), got "
                         f"{tuple(logits.shape)}")
    bh, s, _ = logits.shape
    dispatch.check_operands(name, logits.device,
                            [("logits", logits, (bh, s, s), torch.float32)])
    return bh, s


def row_stats_cuda(logits: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the row-stats kernel → (row max, exp-sum), each (BH, S)."""
    bh, s = _check_logits("row_stats", logits)
    rowmax = torch.empty((bh, s), dtype=torch.float32, device=logits.device)
    denom = torch.empty_like(rowmax)
    fn = dispatch.library()["entropy_probe"].row_stats_launch
    fn.argtypes = [_P, _P, _P, _L, _I, _P]
    fn.restype = _I
    err = fn(logits.data_ptr(), rowmax.data_ptr(), denom.data_ptr(),
             bh * s, s, dispatch.stream_handle(logits.device))
    dispatch.check_launch("entropy_probe", err)
    LAUNCHES["row_stats"] += 1
    return rowmax, denom


def graph_stats_cuda(logits: torch.Tensor, rowmax: torch.Tensor,
                     denom: torch.Tensor):
    """Launch the graph-stats kernel (tile pass + per-head reduction)
    → (scalars (BH, 3), colsum (BH, S), diag (BH, S))."""
    bh, s = _check_logits("graph_stats", logits)
    dev = logits.device
    dispatch.check_operands("graph_stats", dev, [
        ("rowmax", rowmax, (bh, s), torch.float32),
        ("denom", denom, (bh, s), torch.float32)])
    lib = dispatch.library()["entropy_probe"]
    for f in (lib.entropy_probe_tiles, lib.entropy_probe_pairs):
        f.argtypes, f.restype = [_I], _I
    tiles, pairs = lib.entropy_probe_tiles(s), lib.entropy_probe_pairs(s)
    part_col = torch.empty((bh, tiles, s), dtype=torch.float32, device=dev)
    part_scal = torch.empty((bh, pairs, 2), dtype=torch.float32, device=dev)
    scal = torch.empty((bh, 3), dtype=torch.float32, device=dev)
    colsum = torch.empty((bh, s), dtype=torch.float32, device=dev)
    diag = torch.empty((bh, s), dtype=torch.float32, device=dev)
    fn = lib.graph_stats_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P]
    fn.restype = _I
    err = fn(logits.data_ptr(), rowmax.data_ptr(), denom.data_ptr(), bh, s,
             part_col.data_ptr(), part_scal.data_ptr(), scal.data_ptr(),
             colsum.data_ptr(), diag.data_ptr(),
             dispatch.stream_handle(dev))
    dispatch.check_launch("entropy_probe", err)
    LAUNCHES["graph_stats"] += 1
    return scal, colsum, diag


def stats_from_parts(scal: torch.Tensor, colsum: torch.Tensor,
                     diag: torch.Tensor) -> torch.Tensor:
    """The closing algebra: with every row of A summing to 1,
    r_i = 1 − diag_i, c_i = colsum_i − diag_i, s_i = (r_i + c_i)/2,
    Σ_E w² = ¼(ΣA² − Σdiag²) + ¼(ΣA∘Aᵀ − Σdiag²)."""
    sum_a2, cross, sum_d2 = scal.unbind(-1)
    s = 0.5 * ((1.0 - diag) + (colsum - diag))
    sum_w2 = 0.25 * (sum_a2 - sum_d2) + 0.25 * (cross - sum_d2)
    return torch.stack([s.sum(-1), (s * s).sum(-1), sum_w2, s.amax(-1)],
                       dim=-1)


def attention_graph_stats(logits: torch.Tensor) -> torch.Tensor:
    """logits (BH, S, S) → (BH, 4) [S_tot, Σs², Σ_E w², s_max]."""
    if logits.device.type == "cpu":
        x = logits.float()
        return stats_from_parts(*graph_stats_ref(x, *row_stats_ref(x)))
    x = logits.float().contiguous()
    return stats_from_parts(*graph_stats_cuda(x, *row_stats_cuda(x)))


def attention_graph_entropy(logits: torch.Tensor) -> torch.Tensor:
    """FINGER-H̃ of each head's attention graph, (BH,) f32."""
    return entropy_from_stats(attention_graph_stats(logits))
