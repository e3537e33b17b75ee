"""Public op: per-head attention-graph VNGE statistics and entropies.

`attention_graph_stats` takes (BH, S, S) attention logits to the Lemma-1
statistics ``[S_tot, Σs², Σ_E w², s_max]`` of each head's symmetrized
zero-diagonal attention graph W = (A + Aᵀ)/2, A = softmax(logits):

- float32 logits on a CUDA device go to the two hand-written kernels
  (`csrc/entropy_probe.cu`, which replace the TPU kernels
  `_row_stats_kernel` and `_graph_stats_kernel` of
  `attention_graph_stats_pallas`): one launch for the row stats, one
  from them to the closed statistics. A is never written to device
  memory, and a launch CUDA refuses raises;
- logits on the CPU go to the kernels' plain versions (`ref.py`), whose
  `stats_from_parts` is the closing the graph-stats kernel does on the
  card.

Unlike the reference, there is no ``use_pallas`` knob and no quiet plain
path for an S that is not a multiple of the tile: the kernel masks a
ragged S itself. The graph-stats kernel's partials and its per-head
arrival counters are a workspace cached by device and by CUDA stream
(`_workspace`), zeroed once, so a call allocates only its output and two
streams never share a counter.

``LAUNCHES`` counts launches of each kernel by name (never
plain-version calls).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.entropy_probe.ref import (entropy_from_stats,
                                                   graph_stats_ref,
                                                   row_stats_ref)

LAUNCHES = {"row_stats": 0, "graph_stats": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (device index, stream handle) → (partials, per-head counters)
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def _head_floats(s: int) -> int:
    """Workspace floats a head needs at row length s (the library's own
    count)."""
    return int(dispatch.bind("entropy_probe", "entropy_probe_workspace",
                             (_I,), _L)(s))


def _workspace(device: torch.device, stream: int, floats: int, heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stream's partials (at least ``floats``) and its per-head
    counters (at least ``heads``); counters are zeroed when they are
    made, and every launch leaves them 0."""
    key = (device.index, stream)
    work, counter = _WORKSPACE.get(key, (None, None))
    if work is None or work.numel() < floats:
        work = torch.empty((floats,), dtype=torch.float32, device=device)
    if counter is None or counter.numel() < heads:
        counter = torch.zeros((heads,), dtype=torch.int32, device=device)
    _WORKSPACE[key] = (work, counter)
    return work, counter


def _check_logits(name: str, logits: torch.Tensor) -> Tuple[int, int]:
    """(BH, S) of contiguous float32 (BH, S, S) CUDA logits; raises by
    name otherwise. The path's one check a call, so it reads each
    attribute once."""
    if not logits.is_cuda:
        raise ValueError(f"{name} kernel needs CUDA tensors, got "
                         f"{logits.device}")
    shape = logits.shape
    if len(shape) != 3 or shape[1] != shape[2]:
        raise ValueError(f"{name}: logits must be (BH, S, S), got "
                         f"{tuple(shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"{name}: logits tensor must be torch.float32, got "
                        f"{logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError(f"{name}: logits tensor is not contiguous")
    return shape[0], shape[1]


def _launch_rows(logits: torch.Tensor, bh: int, s: int) -> torch.Tensor:
    """One row-stats launch on checked logits → (2, BH, S): the row
    maxes, then the exp-sums."""
    out = logits.new_empty((2, bh, s))
    fn = dispatch.bind("entropy_probe", "row_stats_launch",
                       (_P, _P, _L, _I, _P))
    err = fn(logits.data_ptr(), out.data_ptr(), bh * s, s,
             dispatch.stream_handle(logits.device))
    dispatch.check_launch("entropy_probe", err)
    LAUNCHES["row_stats"] += 1
    return out


def _launch_graph(logits: torch.Tensor, bh: int, s: int, rowmax: int,
                  denom: int) -> torch.Tensor:
    """One graph-stats launch on checked logits and the row stats at the
    device addresses ``rowmax`` and ``denom`` → (BH, 4)."""
    dev = logits.device
    stream = dispatch.stream_handle(dev)
    work, counter = _workspace(dev, stream, bh * _head_floats(s), bh)
    out = logits.new_empty((bh, 4))
    fn = dispatch.bind("entropy_probe", "graph_stats_launch",
                       (_P, _P, _P, _P, _P, _P, _I, _I, _P))
    err = fn(logits.data_ptr(), rowmax, denom, work.data_ptr(),
             counter.data_ptr(), out.data_ptr(), bh, s, stream)
    dispatch.check_launch("entropy_probe", err)
    LAUNCHES["graph_stats"] += 1
    return out


def row_stats_cuda(logits: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the row-stats kernel → (row max, exp-sum), each (BH, S),
    two views of one (2, BH, S) output."""
    bh, s = _check_logits("row_stats", logits)
    return _launch_rows(logits, bh, s).unbind(0)


def graph_stats_cuda(logits: torch.Tensor, rowmax: torch.Tensor,
                     denom: torch.Tensor) -> torch.Tensor:
    """Launch the graph-stats kernel → (BH, 4) [S_tot, Σs², Σ_E w²,
    s_max], closed on the card."""
    bh, s = _check_logits("graph_stats", logits)
    dispatch.check_operands("graph_stats", logits.device, [
        ("rowmax", rowmax, (bh, s), torch.float32),
        ("denom", denom, (bh, s), torch.float32)])
    return _launch_graph(logits, bh, s, rowmax.data_ptr(), denom.data_ptr())


def attention_graph_stats(logits: torch.Tensor) -> torch.Tensor:
    """logits (BH, S, S) → (BH, 4) [S_tot, Σs², Σ_E w², s_max]."""
    x = logits.float()
    if x.device.type == "cpu":
        return graph_stats_ref(x, *row_stats_ref(x))
    x = x.contiguous()
    bh, s = _check_logits("attention_graph_stats", x)
    rows = _launch_rows(x, bh, s)  # checked once; no views made
    return _launch_graph(x, bh, s, rows.data_ptr(),
                         rows.data_ptr() + 4 * bh * s)


def attention_graph_entropy(logits: torch.Tensor) -> torch.Tensor:
    """FINGER-H̃ of each head's attention graph, (BH,) f32."""
    return entropy_from_stats(attention_graph_stats(logits))
