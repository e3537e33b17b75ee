"""The paper-script twins' harness: one module per paper table or
figure, each printing ``name,us_per_call,derived`` CSV rows on the
device of ``--device`` (the card by default). Usage:

    PYTHONPATH=src python -m benchmarks_torch.run [--only fig1,table3]
        [--device cuda|cpu]

The twin of `benchmarks/run.py` for its five paper suites and its
``analysis`` gate; a failed suite fails the harness (exit status 1).
The reference's other suites live elsewhere in the port or have no twin
(ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from benchmarks_torch import (analysis_gate, fig1_degree, fig2_size,
                              fig4_bifurcation, table2_wiki, table3_dos)
from benchmarks_torch.common import device_arg
from repro_torch.kernels.dispatch import resolve_device

SUITES = {
    "fig1": lambda device: fig1_degree.run(device=device),
    "fig2": lambda device: fig2_size.run(device=device),
    "table2": lambda device: table2_wiki.run(device=device),
    "table3": lambda device: table3_dos.run(device=device),
    "fig4": lambda device: fig4_bifurcation.run(device=device),
    "analysis": lambda device: analysis_gate.run(device=device),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated suite names")
    device_arg(ap)
    args = ap.parse_args(argv)
    names = args.only.split(",") if args.only else list(SUITES)
    unknown = sorted(set(names) - set(SUITES))
    if unknown:
        ap.error(f"unknown suite(s) {unknown}; the twins are "
                 f"{sorted(SUITES)}")
    resolve_device(args.device)  # no card and no --device cpu: a named error
    print("name,us_per_call,derived")
    failed = []
    for name in names:
        t0 = time.time()
        try:
            SUITES[name](args.device)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        print(f"# {name} finished in {time.time() - t0:.1f}s",
              file=sys.stderr)
    if failed:
        print(f"# FAILED suites: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
