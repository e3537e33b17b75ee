"""End-to-end anomaly detection on the port (the paper's Section 4
tasks):

1. DoS-attack detection in an AS-peering-style dynamic network
   (paper Table 3) — FINGER vs DeltaCon vs VEO.
2. Bifurcation detection in a Hi-C-like weighted sequence
   (paper Fig. 4).

The twin of `examples/anomaly_detection.py`, on the card unless
``--device cpu``:

    PYTHONPATH=src python examples_torch/anomaly_detection.py
"""
import argparse

import numpy as np

from repro_torch.baselines import deltacon_distance, veo_score
from repro_torch.core import jsdist_fast
from repro_torch.graphs.streams import dos_attack_sequence, \
    hic_bifurcation_sequence
from repro_torch.kernels.dispatch import resolve_device


def score_sequence(graphs, fn):
    return [float(fn(graphs[t], graphs[t + 1]))
            for t in range(len(graphs) - 1)]


def main(device="cuda", start=None) -> dict:
    """Print the example's lines; return the detected transition of
    each (task, method). ``start``: a callable n ↦ the (n,) start vector
    of the power iterations (default: the port's seeded draw)."""
    dev = resolve_device(device)

    def finger(n):
        x0 = None if start is None else \
            np.array(start(n), np.float32)
        return lambda a, b: jsdist_fast(a, b, power_iters=50, x0=x0)

    detected = {}
    print("=== DoS attack detection (X = 10% of nodes) ===")
    seq, attack_at = dos_attack_sequence(n=300, attack_frac=0.10, seed=7)
    graphs = [g.to(dev) for g in seq.graphs]
    for name, fn in [
        ("FINGER-JS", finger(300)),
        ("DeltaCon ", deltacon_distance),
        ("VEO      ", veo_score),
    ]:
        scores = score_sequence(graphs, fn)
        det = int(np.argmax(scores))
        detected["dos", name.strip()] = det
        mark = "HIT " if det == attack_at else "miss"
        print(f"  {name}: detected transition {det} "
              f"(planted {attack_at}) [{mark}]  scores="
              + " ".join(f"{s:.3f}" for s in scores))

    print("\n=== Hi-C bifurcation detection (planted at transition 5) ===")
    seq = hic_bifurcation_sequence(n=200, bifurcation_at=5, seed=0)
    graphs = [g.to(dev) for g in seq.graphs]
    for name, fn in [
        ("FINGER-JS", finger(200)),
        ("VEO      ", veo_score),
    ]:
        scores = score_sequence(graphs, fn)
        det = int(np.argmax(scores))
        detected["hic", name.strip()] = det
        print(f"  {name}: detected transition {det} "
              f"(weighted-graph sensitivity: "
              f"peak/median = {max(scores)/(np.median(scores)+1e-12):.2f})")
    return detected


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    main(ap.parse_args().device)
