"""Plain PyTorch versions of the attention-graph statistics.

- `attention_graph_stats_ref`: the port's copy of the reference oracle
  (`repro.kernels.entropy_probe.ref`): A = softmax(logits) per head,
  W = (A + Aᵀ)/2 with a zero diagonal, and W's Lemma-1 statistics
  ``[S_tot, Σs², Σ_E w², s_max]``, materializing the (S, S) matrices.
- `row_stats_ref` and `graph_stats_ref`: the plain versions of the two
  CUDA kernels (`csrc/entropy_probe.cu`), with their inputs and outputs:
  row max and exp-sum; then the closed (BH, 4) statistics. The CPU path
  of `ops.attention_graph_stats` runs them, and the card compares each
  kernel with its own.
- `graph_parts_ref`: what the reference's `_graph_stats_kernel` returns,
  ``[ΣA², ΣA∘Aᵀ, Σ diag²]``, colsum(A) and diag(A); `stats_from_parts`
  is the one closing of those parts (the graph-stats kernel closes on
  the card by the same algebra).
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


def graph_parts_ref(logits: torch.Tensor, rowmax: torch.Tensor,
                    denom: torch.Tensor):
    """(logits, row max, exp-sum) → (scalars (BH, 3) = [ΣA², ΣA∘Aᵀ,
    Σ diag²], colsum (BH, S), diag (BH, S)) of A = exp(x − m)/d."""
    a = torch.exp(logits.float() - rowmax[..., None]) / denom[..., None]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    scal = torch.stack([(a * a).sum((-1, -2)),
                        (a * a.transpose(-1, -2)).sum((-1, -2)),
                        (diag * diag).sum(-1)], dim=-1)
    return scal, a.sum(-2), diag


def stats_from_parts(scal: torch.Tensor, colsum: torch.Tensor,
                     diag: torch.Tensor) -> torch.Tensor:
    """The closing algebra (the reference's `ops.py`): with every row of
    A summing to 1, r_i = 1 − diag_i, c_i = colsum_i − diag_i,
    s_i = (r_i + c_i)/2, Σ_E w² = ¼(ΣA² − Σdiag²) + ¼(ΣA∘Aᵀ − Σdiag²)
    → (BH, 4) [S_tot, Σs², Σ_E w², s_max]."""
    sum_a2, cross, sum_d2 = scal.unbind(-1)
    s = 0.5 * ((1.0 - diag) + (colsum - diag))
    sum_w2 = 0.25 * (sum_a2 - sum_d2) + 0.25 * (cross - sum_d2)
    return torch.stack([s.sum(-1), (s * s).sum(-1), sum_w2, s.amax(-1)],
                       dim=-1)


def graph_stats_ref(logits: torch.Tensor, rowmax: torch.Tensor,
                    denom: torch.Tensor) -> torch.Tensor:
    """(logits, row max, exp-sum) → (BH, 4) [S_tot, Σs², Σ_E w², s_max],
    what the graph-stats kernel returns."""
    return stats_from_parts(*graph_parts_ref(logits, rowmax, denom))


def entropy_from_stats(stats: torch.Tensor) -> torch.Tensor:
    """FINGER-H̃ (eq. 2) per head from the 4-vector statistics; an empty
    graph gives the reference's unguarded -ln(1e-30), not 0."""
    return h_tilde_from_stat_vector(stats, empty_is_zero=False)
