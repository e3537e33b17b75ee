"""Paper Fig. 4 on the port: bifurcation detection in a dynamic
(Hi-C-like) genomic network via the temporal difference score; FINGER
should place the detected bifurcation at the planted index, VEO should
fail (it is blind to weights).

The twin of `benchmarks/fig4_bifurcation.py`, with its rows, on the
card unless ``--device cpu``:

    PYTHONPATH=src python -m benchmarks_torch.fig4_bifurcation
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks_torch.common import device_arg, emit, start_vector
from repro_torch.baselines import deltacon_distance, lambda_distance, \
    veo_score
from repro_torch.core import jsdist_fast
from repro_torch.graphs.streams import hic_bifurcation_sequence
from repro_torch.kernels.dispatch import resolve_device

BIF = 5  # planted: transition 5 -> 6 (the paper's "6th measurement")
N = 200


def methods(x0=None) -> dict:
    """The scored methods by row name (``x0``: the power iterations'
    start vector)."""
    return {
        "FINGER-JS(Fast)": lambda a, b: jsdist_fast(a, b, power_iters=50,
                                                    x0=x0),
        "DeltaCon": deltacon_distance,
        "lambda(Lap)": lambda a, b: lambda_distance(a, b, matrix="lap"),
        "VEO": veo_score,
    }


def run(device="cuda", start=None) -> list:
    """Print the rows; return them as (name, seconds, derived).
    ``start`` as in `fig1_degree.run`."""
    dev = resolve_device(device)
    seq = hic_bifurcation_sequence(n=N, bifurcation_at=BIF, seed=0)
    graphs = [g.to(dev) for g in seq.graphs]
    rows = []
    for name, fn in methods(start_vector(start, N, dev)).items():
        t0 = time.perf_counter()
        # one score a graph pair, as the reference script takes them
        scores = [float(fn(graphs[t], graphs[t + 1]))  # lint: disable=per-item-host-sync
                  for t in range(len(graphs) - 1)]
        dt = (time.perf_counter() - t0) / len(scores)
        # the detected bifurcation is the highest-scoring transition (the
        # reference also forms the TDS profile, and leaves it unused)
        detected = int(np.argmax(scores))
        contrast = float(max(scores) / (np.median(scores) + 1e-12))
        derived = (f"detected_transition={detected};planted={BIF};"
                   f"correct={detected == BIF};"
                   f"peak_over_median={contrast:.2f}")
        rows.append(emit(f"fig4/{name}", dt, derived))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
