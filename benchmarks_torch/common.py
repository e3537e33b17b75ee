"""Shared utilities of the paper-script twins: timing, CSV rows, the
``--device`` flag and the power iteration's start vector. A twin
resolves its device with `repro_torch.kernels.dispatch.resolve_device`:
``cuda`` without a card raises a RuntimeError naming
`torch.cuda.is_available`."""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch



def ready(x):
    """``x`` once the card has finished it: `torch.cuda.synchronize`
    when it is a tensor there, as `jax.block_until_ready` for the
    reference."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize()
    return x


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall time (seconds) of ``fn(*args)``, each call ended by
    `ready`."""
    for _ in range(warmup):
        ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def emit(name: str, seconds: float, derived: str = "") -> tuple:
    """Print the name,us_per_call,derived CSV row (the reference
    harness's) and return it as (name, seconds, derived)."""
    print(f"{name},{seconds * 1e6:.1f},{derived}")
    return name, seconds, derived


def start_vector(start, n: int, device: torch.device):
    """``start(n)`` as a float32 tensor on ``device``, or None (the
    port's seeded draw) when ``start`` is None. Tests pass the
    reference's threefry vector this way."""
    if start is None:
        return None
    return torch.tensor(np.array(start(n), np.float32), device=device)


def device_arg(ap: argparse.ArgumentParser) -> None:
    """The ``--device`` flag of every twin: the card unless asked."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
