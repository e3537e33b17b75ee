"""``python -m repro_torch.analysis`` — the port's analysis gate.

Subcommands (default: run all four and fail on any violation):

- ``lint``     — AST hazard rules over the port (see
  `repro_torch.analysis.lint` for the rules and the inline
  ``# lint: disable=<rule>`` pragma).
- ``audit``    — one tick of every placement's warmed plan and every
  migration transform under the recording dispatch mode (host
  transfers and syncs, in place, collectives, float64, launches).
- ``smem``     — every kernel instantiation's launch against the card
  (shared memory, registers, spills, blocks an SM, guard drift); it
  reads the card and refuses ``--device cpu``.
- ``sentinel`` — the migration chains at zero first-use events.

``--json`` prints one machine-readable report (each check's payload
with the seconds it took); the exit code is 0 iff every selected check
passed. ``--device`` is ``cuda`` (the default) or
``cpu``; asking for the card without one fails by name.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from repro_torch.kernels.dispatch import resolve_device


def _repo_root() -> Path:
    # .../src/repro_torch/analysis/__main__.py → the repository root
    return Path(__file__).resolve().parents[3]


def _run_lint(json_mode: bool, device) -> tuple:
    from repro_torch.analysis.lint import lint_tree

    report = lint_tree(_repo_root())
    if not json_mode:
        for v in report.unsuppressed:
            print(f"  {v}")
        n = len(report.unsuppressed)
        print(f"lint: {'OK' if report.ok else 'FAIL'} "
              f"({n} unsuppressed violation(s), "
              f"{len(report.violations) - n} suppressed)")
    return report.ok, report.to_dict()


def _run_audit(json_mode: bool, device) -> tuple:
    from repro_torch.analysis.tick_audit import audit_repo

    report = audit_repo(device)
    if not json_mode:
        for t in report.targets:
            mark = "OK " if t.ok else "FAIL"
            print(f"  [{mark}] {t.target}: launches={t.launches or '{}'} "
                  f"host_transfers={len(t.host_transfers)} "
                  f"moved={len(t.moved)} upcasts={len(t.upcasts)}")
            for v in t.violations:
                print(f"         {v.rule}: {v.message}")
        print(f"audit: {'OK' if report.ok else 'FAIL'} "
              f"({len(report.violations)} violation(s) across "
              f"{len(report.targets)} targets)")
    return report.ok, report.to_dict()


def _run_smem(json_mode: bool, device) -> tuple:
    from repro_torch.analysis.smem import SmemNeedsCard, run_smem, table

    try:
        report = run_smem(device)
    except SmemNeedsCard as exc:
        print(f"smem: FAIL ({exc})", file=sys.stderr)
        return False, {"ok": False, "error": str(exc)}
    if not json_mode:
        for row in table(report):
            print(f"  {row}")
        for v in report.violations:
            print(f"  {v.rule} [{v.kernel}]: {v.message}")
        print(f"smem: {'OK' if report.ok else 'FAIL'} "
              f"({len(report.configs)} launches on {report.device})")
    return report.ok, report.to_dict()


def _run_sentinel(json_mode: bool, device) -> tuple:
    from repro_torch.analysis.sanitize import (FirstUseBudgetExceeded,
                                               TransferBudgetExceeded)
    from repro_torch.analysis.sentinel import (run_fleet_chain,
                                               run_migration_chain,
                                               run_scaled_chain,
                                               run_sparse_chain)

    chains = [("dense", run_migration_chain), ("sparse", run_sparse_chain),
              ("fleet", run_fleet_chain)]
    if device.type == "cuda":
        chains.append(("dense_phase3", run_scaled_chain))
    result = {"ok": True, "chains": {}}
    for name, chain in chains:
        try:
            result["chains"][name] = chain(device=device)
        except (FirstUseBudgetExceeded, TransferBudgetExceeded,
                AssertionError) as exc:
            result["chains"][name] = {"ok": False, "error": str(exc)}
            result["ok"] = False
    if not json_mode:
        for name, res in result["chains"].items():
            print(f"  {name}: " + (f"phases {res['phases']}" if res["ok"]
                                   else res["error"]))
        print(f"sentinel: {'OK' if result['ok'] else 'FAIL'}")
    return result["ok"], result


RUNNERS = {"lint": _run_lint, "audit": _run_audit, "smem": _run_smem,
           "sentinel": _run_sentinel}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis gate: lint / audit / smem / "
                    "sentinel")
    parser.add_argument("checks", nargs="*", choices=[*RUNNERS, []],
                        help="checks to run (default: all)")
    parser.add_argument("--json", action="store_true",
                        help="one machine-readable report on stdout")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; cuda without a card "
                             "raises")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    selected = args.checks or list(RUNNERS)

    results = {}
    all_ok = True
    for name in selected:
        t0 = time.perf_counter()
        ok, payload = RUNNERS[name](args.json, device)
        results[name] = dict(payload, seconds=time.perf_counter() - t0)
        all_ok = all_ok and ok

    if args.json:
        print(json.dumps({"ok": all_ok, "device": str(device),
                          "checks": results}, indent=2))
    else:
        print(f"analysis: {'OK' if all_ok else 'FAIL'} "
              f"({', '.join(selected)} on {device})")
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
