"""Paper Fig. 2 on the port: scaled approximation error (SAE) of Ĥ vs the
number of nodes n, with the trend row (SAE decays for ER/WS, grows for
BA).

The twin of `benchmarks/fig2_size.py`, with its rows, on the card
unless ``--device cpu``:

    PYTHONPATH=src python -m benchmarks_torch.fig2_size
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import device_arg, emit, start_vector, \
    time_fn
from repro_torch.core import exact_vnge, scaled_approximation_error, \
    vnge_hat
from repro_torch.graphs.generators import (barabasi_albert, erdos_renyi,
                                           watts_strogatz)
from repro_torch.kernels.dispatch import resolve_device

SIZES = (200, 400, 800)
DBAR = 20


def run(device="cuda", sizes=SIZES, start=None) -> list:
    """Print the rows; return them as (name, seconds, derived).
    ``start`` as in `fig1_degree.run`."""
    dev = resolve_device(device)
    rows = []
    for model in ("ER", "BA", "WS"):
        saes = []
        for n in sizes:
            if model == "ER":
                g = erdos_renyi(n, DBAR / (n - 1), seed=n)
            elif model == "BA":
                g = barabasi_albert(n, DBAR // 2, seed=n)
            else:
                g = watts_strogatz(n, DBAR, 0.2, seed=n)
            g = g.to(dev)
            x0 = start_vector(start, n, dev)

            def h_hat(graph):
                return vnge_hat(graph, x0=x0)

            h = exact_vnge(g)
            hh = h_hat(g)
            # one graph's error, pulled as the reference script pulls it
            sae = float(scaled_approximation_error(h, hh, n))  # lint: disable=per-item-host-sync
            saes.append(sae)
            t = time_fn(h_hat, g)
            rows.append(emit(f"fig2/{model}/n{n}", t, f"SAE={sae:.4f}"))
        trend = "decays" if saes[-1] < saes[0] else "grows"
        rows.append(emit(f"fig2/{model}/trend", 0.0, trend))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    run(ap.parse_args().device)


if __name__ == "__main__":
    main()
