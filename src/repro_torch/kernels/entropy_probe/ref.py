"""Plain PyTorch versions of the attention-graph statistics.

- `attention_graph_stats_ref`: the port's copy of the reference oracle
  (`repro.kernels.entropy_probe.ref`): A = softmax(logits) per head,
  W = (A + Aᵀ)/2 with a zero diagonal, and W's Lemma-1 statistics
  ``[S_tot, Σs², Σ_E w², s_max]``, materializing the (S, S) matrices.
- `row_stats_ref` and `graph_stats_ref`: the plain versions of the two
  CUDA kernels (`csrc/entropy_probe.cu`), with their inputs and outputs:
  row max and exp-sum; then ``[ΣA², ΣA∘Aᵀ, Σ diag²]``, colsum(A) and
  diag(A). The CPU path of `ops.attention_graph_stats` runs them, and
  the card compares each kernel with its own.
- `entropy_from_stats`: FINGER-H̃ (eq. 2) per head from the statistics,
  through the one closing of Lemma 1 and eq. (2) in `core/vnge.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.vnge import h_tilde_from_stat_vector


def attention_graph_stats_ref(logits: torch.Tensor) -> torch.Tensor:
    """logits (BH, S, S) → (BH, 4) f32 [S_tot, Σs², Σ_E w², s_max]."""
    a = torch.softmax(logits.float(), dim=-1)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    w = 0.5 * (a + a.transpose(-1, -2)) * (1.0 - eye)
    s = w.sum(-1)
    return torch.stack([s.sum(-1), (s * s).sum(-1),
                        0.5 * (w * w).sum((-1, -2)), s.amax(-1)], dim=-1)


def row_stats_ref(logits: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (BH, S, S) → (row max, Σ exp(x − max)), each (BH, S)."""
    x = logits.float()
    m = x.amax(-1)
    return m, torch.exp(x - m[..., None]).sum(-1)


def graph_stats_ref(logits: torch.Tensor, rowmax: torch.Tensor,
                    denom: torch.Tensor):
    """(logits, row max, exp-sum) → (scalars (BH, 3) = [ΣA², ΣA∘Aᵀ,
    Σ diag²], colsum (BH, S), diag (BH, S)) of A = exp(x − m)/d."""
    a = torch.exp(logits.float() - rowmax[..., None]) / denom[..., None]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    scal = torch.stack([(a * a).sum((-1, -2)),
                        (a * a.transpose(-1, -2)).sum((-1, -2)),
                        (diag * diag).sum(-1)], dim=-1)
    return scal, a.sum(-2), diag


def entropy_from_stats(stats: torch.Tensor) -> torch.Tensor:
    """FINGER-H̃ (eq. 2) per head from the 4-vector statistics; an empty
    graph gives the reference's unguarded -ln(1e-30), not 0."""
    return h_tilde_from_stat_vector(stats, empty_is_zero=False)
