"""Quickstart on the port: FINGER in 60 seconds.

Computes the exact VNGE, the two FINGER approximations, and the
Jensen-Shannon distances on a small random-graph pair, then runs the
incremental (streaming) path over a delta stream. The twin of
`examples/quickstart.py`, on the card unless ``--device cpu``:

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (
    exact_vnge,
    finger_state,
    jsdist_exact,
    jsdist_fast,
    jsdist_incremental,
    quadratic_q,
    vnge_hat,
    vnge_tilde,
)
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.streams import churn_stream
from repro_torch.kernels.dispatch import resolve_device


def main(device="cuda", start=None) -> list:
    """Print the example's lines; return the streaming JSdist scores.
    ``start``: a callable n ↦ the (n,) start vector of the power
    iterations (default: the port's seeded draw)."""
    dev = resolve_device(device)
    x0 = None if start is None else np.array(start(500), np.float32)
    g = erdos_renyi(500, 0.03, seed=0).to(dev)
    print("graph: n=500 ER(p=0.03)")
    print(f"  exact VNGE H        = {float(exact_vnge(g)):.4f}   (O(n^3))")
    print(f"  Lemma-1 proxy Q     = {float(quadratic_q(g)):.4f}   (O(n+m))")
    print(f"  FINGER-Hhat (eq.1)  = {float(vnge_hat(g, x0=x0)):.4f}   "
          "(O(n+m))")
    print(f"  FINGER-Htilde (eq.2)= {float(vnge_tilde(g)):.4f}   (O(n+m))")

    g2 = erdos_renyi(500, 0.03, seed=1).to(dev)
    print("\nJS distance between two independent ER graphs:")
    print(f"  exact      = {float(jsdist_exact(g, g2)):.4f}")
    print(f"  Algorithm 1= {float(jsdist_fast(g, g2, x0=x0)):.4f}")

    print("\nstreaming (Algorithm 2) over 10 churn deltas:")
    seq = churn_stream(n=500, p0=0.03, steps=10, burst_steps=(6,),
                       burst_multiplier=15.0, seed=2)
    state = finger_state(seq.graphs[0].to(dev))
    scores = []
    for t, delta in enumerate(seq.deltas):
        dist, state = jsdist_incremental(state, delta.to(dev),
                                         exact_smax=True)
        scores.append(float(dist))
        bar = "#" * int(scores[-1] * 400)
        flag = "  <-- burst" if t == 6 else ""
        print(f"  step {t:2d}: JSdist = {scores[-1]:.4f} {bar}{flag}")
    return scores


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    main(ap.parse_args().device)
