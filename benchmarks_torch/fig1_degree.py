"""Paper Fig. 1 on the port: approximation error and computation-time
reduction ratio (CTRR) of Ĥ and H̃ against exact H vs average degree,
for ER / BA / WS graphs.

The twin of `benchmarks/fig1_degree.py`, with its rows. CTRR is like
for like: exact H (`torch.linalg.eigvalsh`), Ĥ and H̃ all run eagerly on
the same device, the card unless ``--device cpu``. ``n`` and ``trials``
default to the reference's N = 600 and TRIALS = 3 (the paper uses
n = 2000):

    PYTHONPATH=src python -m benchmarks_torch.fig1_degree [--n 2000]
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks_torch.common import device_arg, emit, start_vector, \
    time_fn
from repro_torch.core import exact_vnge, vnge_hat, vnge_tilde
from repro_torch.graphs.generators import (barabasi_albert, erdos_renyi,
                                           watts_strogatz)
from repro_torch.kernels.dispatch import resolve_device

N = 600
TRIALS = 3
MODELS = ("ER", "BA", "WS")
DEGREES = (6, 20, 50)


def graph(model: str, dbar: int, seed: int, n: int):
    """The reference's graph of ``model`` at average degree ``dbar``."""
    if model == "ER":
        return erdos_renyi(n, dbar / (n - 1), seed=seed)
    if model == "BA":
        return barabasi_albert(n, max(dbar // 2, 1), seed=seed)
    return watts_strogatz(n, dbar, 0.2, seed=seed)


def run(n: int = N, trials: int = TRIALS, device="cuda",
        start=None) -> list:
    """Print the rows; return them as (name, seconds, derived).
    ``start``: a callable n ↦ the (n,) start vector of every power
    iteration (default: the port's seeded draw)."""
    dev = resolve_device(device)
    x0 = start_vector(start, n, dev)

    def h_hat(g):
        return vnge_hat(g, x0=x0)

    rows = []
    for model in MODELS:
        for dbar in DEGREES:
            aes_hat, aes_til = [], []
            for t in range(trials):
                g = graph(model, dbar, 100 * t + dbar, n).to(dev)
                # one trial's values, pulled as the reference script pulls them
                h = float(exact_vnge(g))  # lint: disable=per-item-host-sync
                aes_hat.append(h - float(h_hat(g)))  # lint: disable=per-item-host-sync
                aes_til.append(h - float(vnge_tilde(g)))  # lint: disable=per-item-host-sync
            g = graph(model, dbar, 0, n).to(dev)
            t_exact = time_fn(exact_vnge, g)
            t_hat = time_fn(h_hat, g)
            t_tilde = time_fn(vnge_tilde, g)
            ctrr_hat = 100.0 * (t_exact - t_hat) / t_exact
            ctrr_til = 100.0 * (t_exact - t_tilde) / t_exact
            rows += [
                emit(f"fig1/{model}/d{dbar}/Hhat", t_hat,
                     f"AE={np.mean(aes_hat):.4f};CTRR={ctrr_hat:.1f}%"),
                emit(f"fig1/{model}/d{dbar}/Htilde", t_tilde,
                     f"AE={np.mean(aes_til):.4f};CTRR={ctrr_til:.1f}%"),
                emit(f"fig1/{model}/d{dbar}/Hexact", t_exact, "reference")]
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--trials", type=int, default=TRIALS)
    device_arg(ap)
    args = ap.parse_args()
    run(args.n, args.trials, args.device)


if __name__ == "__main__":
    main()
