"""Paper Table 3 / S2 on the port: detection rate of synthesized DoS
events in AS-peering-style dynamic networks, X ∈ {1, 3, 5, 10} % of the
nodes, top-2 ranking criterion, several random instances per X.

The twin of `benchmarks/table3_dos.py`, with its rows; X is an argument
here, not a module global. On the card unless ``--device cpu``:

    PYTHONPATH=src python -m benchmarks_torch.table3_dos
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks_torch.common import device_arg, emit, start_vector
from repro_torch.baselines import (deltacon_distance, graph_edit_distance,
                                   lambda_distance, veo_score)
from repro_torch.baselines.vnge_variants import vnge_variant_score
from repro_torch.core import finger_state, jsdist_fast, jsdist_incremental
from repro_torch.graphs.streams import dos_attack_sequence
from repro_torch.kernels.dispatch import resolve_device

N = 250
INSTANCES = 10
XS = (1, 3, 5, 10)


def methods(x0=None) -> dict:
    """The 6 scored methods by row name (``x0``: the power iterations'
    start vector)."""
    return {
        "FINGER-JS(Fast)": lambda a, b: jsdist_fast(a, b, power_iters=50,
                                                    x0=x0),
        "DeltaCon": deltacon_distance,
        "lambda(Adj)": lambda a, b: lambda_distance(a, b, matrix="adj"),
        "GED": graph_edit_distance,
        "VNGE-NL": lambda a, b: vnge_variant_score(a, b, "nl"),
        "VEO": veo_score,
    }


def detect_rate(method, name: str, x: int, n: int, instances: int, dev
                ) -> tuple:
    """Print the row of ``method`` at X = ``x`` %: the share of instances
    whose attack transition is among the two highest scores."""
    hits = 0
    t0 = time.perf_counter()
    for seed in range(instances):
        seq, attack_at = dos_attack_sequence(n=n, attack_frac=x / 100.0,
                                             seed=seed)
        graphs = [g.to(dev) for g in seq.graphs]
        # one score a graph pair, as the reference script takes them
        scores = [float(method(graphs[t], graphs[t + 1]))  # lint: disable=per-item-host-sync
                  for t in range(len(graphs) - 1)]
        hits += int(attack_at in np.argsort(scores)[-2:])
    return report(f"table3/X{x}%/{name}", t0, hits, instances)


def incremental_rate(x: int, n: int, instances: int, dev) -> tuple:
    """The same criterion for FINGER-JS (Inc) over the deltas."""
    hits = 0
    t0 = time.perf_counter()
    for seed in range(instances):
        seq, attack_at = dos_attack_sequence(n=n, attack_frac=x / 100.0,
                                             seed=seed)
        st = finger_state(seq.graphs[0].to(dev))
        scores = []
        for d in seq.deltas:
            dist, st = jsdist_incremental(st, d.to(dev), exact_smax=True)
            scores.append(float(dist))
        hits += int(attack_at in np.argsort(scores)[-2:])
    return report(f"table3/X{x}%/FINGER-JS(Inc)", t0, hits, instances)


def report(name: str, t0: float, hits: int, instances: int) -> tuple:
    return emit(name, (time.perf_counter() - t0) / instances,
                f"rate={100 * hits / instances:.0f}%")


def run(n: int = N, instances: int = INSTANCES, device="cuda", xs=XS,
        start=None) -> list:
    """Print the rows; return them as (name, seconds, derived).
    ``start`` as in `fig1_degree.run`."""
    dev = resolve_device(device)
    table = methods(start_vector(start, n, dev))
    rows = []
    for x in xs:
        for name, fn in table.items():
            rows.append(detect_rate(fn, name, x, n, instances, dev))
        rows.append(incremental_rate(x, n, instances, dev))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--instances", type=int, default=INSTANCES)
    device_arg(ap)
    args = ap.parse_args()
    run(args.n, args.instances, args.device)


if __name__ == "__main__":
    main()
