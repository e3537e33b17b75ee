# The port's analysis gate as a benchmark suite: lint / audit / smem /
# sentinel, timed and emitted as CSV rows. Any unsuppressed violation
# raises, which fails the harness (the twin of benchmarks/analysis_gate.py).
"""Run with::

    PYTHONPATH=src python -m benchmarks_torch.run --only analysis [--device cpu]

The suite entry point for `repro_torch.analysis`: the lint over the
port, the tick audit (every placement's warmed tick and the migration
transforms), the shared-memory check of every kernel instantiation's
launch, and the zero-first-use migration-chain sentinel. `smem` reads
the card: with ``--device cpu`` its row says so and the other three
checks run. The CLI form (``python -m repro_torch.analysis``) prints the
same checks with per-violation detail and a ``--json`` report.
"""
from __future__ import annotations

import time

from benchmarks_torch.common import emit


class AnalysisGateError(AssertionError):
    """An analysis check reported unsuppressed violations."""


def _timed(name: str, fn):
    t0 = time.perf_counter()
    ok, detail = fn()
    emit(f"analysis/{name}", time.perf_counter() - t0, detail)
    if not ok:
        raise AnalysisGateError(f"analysis check '{name}' failed: {detail}")


def run(device="cuda") -> None:
    from repro_torch.analysis.__main__ import _repo_root
    from repro_torch.analysis.lint import lint_tree
    from repro_torch.analysis.sanitize import FirstUseBudgetExceeded
    from repro_torch.analysis.sentinel import run_migration_chain
    from repro_torch.analysis.smem import run_smem
    from repro_torch.analysis.tick_audit import audit_repo
    from repro_torch.kernels.dispatch import resolve_device

    dev = resolve_device(device)

    def _lint():
        report = lint_tree(_repo_root())
        bad = report.unsuppressed
        return not bad, (f"{len(bad)} unsuppressed violation(s)" if bad
                         else f"0 violations ({len(report.violations)} "
                              "suppressed)")

    def _audit():
        report = audit_repo(dev)
        return report.ok, (f"{len(report.violations)} violation(s)" if
                           not report.ok else
                           f"{len(report.targets)} targets clean")

    def _smem():
        if dev.type != "cuda":
            return True, "not run: smem reads the card"
        report = run_smem(dev)
        return report.ok, (f"{len(report.violations)} violation(s)" if
                           not report.ok else
                           f"{len(report.configs)} launches fit")

    def _sentinel():
        try:
            result = run_migration_chain(device=dev)
        except FirstUseBudgetExceeded as exc:
            return False, str(exc)
        return result["ok"], (f"{result['generations']} generations at "
                              f"{result['budget_per_phase']} first uses")

    _timed("lint", _lint)
    _timed("tick_audit", _audit)
    _timed("smem", _smem)
    _timed("sentinel", _sentinel)
