"""Static and runtime analysis gates for the port's serving stack.

The counterpart of `repro.analysis`. Four checks, one CLI
(``python -m repro_torch.analysis [lint|audit|smem|sentinel] [--json]
[--device cuda|cpu]``):

- `repro_torch.analysis.lint` — an AST linter over the port
  (``src/repro_torch/``, ``chip_smoke.py``, ``benchmarks_torch/``,
  ``examples_torch/``) with named, suppressible rules for its hazards:
  per-item host syncs, aliased numpy hand-offs, JAX imports, TF32, a
  kernel error swallowed into a fallback.
- `repro_torch.analysis.tick_audit` — one tick of every placement's
  warmed plan and every migration transform, op by op: no host transfer
  or sync, the stacked state updated in place, no collective, no
  float64, one kernel launch a shard.
- `repro_torch.analysis.smem` — every kernel instantiation's launch
  against the card: shared memory, registers, spills, blocks an SM, and
  the Python guards against the kernels' own checks.
- `repro_torch.analysis.sentinel` — the migration chains (dense, sparse,
  fleet, and on the card the phase-3 shape) at zero first-use events.

`repro_torch.analysis.sanitize` holds the runtime sanitizers the gates
and the tests share. Everything runs on ``cuda`` unless the caller asks
for the CPU, and ``smem`` only on the card.
"""
from repro_torch.analysis.sanitize import (FirstUseBudgetExceeded,
                                           NanCheckError,
                                           TransferBudgetExceeded,
                                           assert_first_use_at_most,
                                           debug_nan_checks,
                                           first_use_budget, no_transfers,
                                           transfer_budget)

__all__ = [
    "FirstUseBudgetExceeded",
    "NanCheckError",
    "TransferBudgetExceeded",
    "assert_first_use_at_most",
    "debug_nan_checks",
    "first_use_budget",
    "no_transfers",
    "transfer_budget",
]
