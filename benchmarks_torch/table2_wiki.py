"""Paper Table 2 (+ S1) on the port: anomaly detection on an evolving
hyperlink-style network — PCC and SRCC of each method's scores against
the anomaly proxy, and each method's seconds per graph pair.

The twin of `benchmarks/table2_wiki.py`, with its rows: the bursty churn
stream (the Wikipedia dumps are not available offline), FINGER-JS (Fast)
against the baselines, and FINGER-JS (Inc) over the deltas with exact
s_max; on the card unless ``--device cpu``:

    PYTHONPATH=src python -m benchmarks_torch.table2_wiki
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks_torch.common import device_arg, emit, start_vector
from repro_torch.baselines import (bhattacharyya_distance, cosine_distance,
                                   deltacon_distance, graph_edit_distance,
                                   hellinger_distance, lambda_distance,
                                   rmd_distance, veo_score)
from repro_torch.baselines.vnge_variants import vnge_variant_score
from repro_torch.core import finger_state, jsdist_fast, jsdist_incremental
from repro_torch.graphs.streams import churn_stream
from repro_torch.kernels.dispatch import resolve_device

N = 300


def spearman(a, b) -> float:
    ra = np.argsort(np.argsort(a)).astype(float)
    rb = np.argsort(np.argsort(b)).astype(float)
    return float(np.corrcoef(ra, rb)[0, 1])


def methods(x0=None) -> dict:
    """The 12 scored methods by row name (``x0``: the power iterations'
    start vector)."""
    return {
        "FINGER-JS(Fast)": lambda a, b: jsdist_fast(a, b, power_iters=50,
                                                    x0=x0),
        "DeltaCon": deltacon_distance,
        "RMD": rmd_distance,
        "lambda(Adj)": lambda a, b: lambda_distance(a, b, matrix="adj"),
        "lambda(Lap)": lambda a, b: lambda_distance(a, b, matrix="lap"),
        "GED": graph_edit_distance,
        "VNGE-NL": lambda a, b: vnge_variant_score(a, b, "nl"),
        "VNGE-GL": lambda a, b: vnge_variant_score(a, b, "gl"),
        "VEO": veo_score,
        "cosine(deg)": cosine_distance,
        "Bhattacharyya(deg)": bhattacharyya_distance,
        "Hellinger(deg)": hellinger_distance,
    }


def run(device="cuda", start=None) -> list:
    """Print the rows; return them as (name, seconds, derived).
    ``start`` as in `fig1_degree.run`."""
    dev = resolve_device(device)
    seq = churn_stream(n=N, steps=30, burst_steps=(7, 15, 23),
                       burst_multiplier=10.0, seed=0)
    proxy = seq.anomaly_truth
    graphs = [g.to(dev) for g in seq.graphs]
    pairs = list(zip(graphs[:-1], graphs[1:]))
    rows = []

    def row(name, seconds, scores):
        pcc = float(np.corrcoef(scores, proxy)[0, 1])
        srcc = spearman(scores, proxy)
        rows.append(emit(name, seconds, f"PCC={pcc:.4f};SRCC={srcc:.4f}"))

    for name, fn in methods(start_vector(start, N, dev)).items():
        t0 = time.perf_counter()
        # one score a graph pair, as the reference script takes them
        scores = [float(fn(a, b)) for a, b in pairs]  # lint: disable=per-item-host-sync
        row(f"table2/{name}", (time.perf_counter() - t0) / len(pairs),
            scores)

    # FINGER incremental over the delta stream (Algorithm 2)
    deltas = [d.to(dev) for d in seq.deltas]
    st = finger_state(graphs[0])
    t0 = time.perf_counter()
    scores = []
    for d in deltas:
        dist, st = jsdist_incremental(st, d, exact_smax=True)
        scores.append(float(dist))
    row("table2/FINGER-JS(Inc)", (time.perf_counter() - t0) / len(deltas),
        scores)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
