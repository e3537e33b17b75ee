"""Spectral utilities: power iteration for λ_max of L_N, exact eigvals.

The port's copy of `repro.graphs.spectral`. λ_max of the PSD matrix
L_N = L / trace(L) is what FINGER-Ĥ (eq. 1) consumes; each power
iteration is one Laplacian matvec (O(n + m) matrix-free).

Two differences from the reference, both at the loop:

- *The start vector.* The reference draws ``x0`` from JAX's threefry
  (``jax.random.normal(PRNGKey(seed))``), which torch cannot reproduce.
  The port draws it from ``torch.Generator(device="cpu")`` seeded with
  ``seed`` and moves it to the device, so the CPU and the card start from
  the same vector. ``x0=`` takes an explicit start vector instead (the
  tests feed the reference's own, so both iterations follow one
  trajectory).
- *The loop runs on the host.* The reference's ``lax.while_loop`` tests
  the Rayleigh-quotient stop on the device; the port tests
  ``rel > tol`` on the host, one sync per iteration. The stop, the
  iteration cap, the zero-norm keep and ``max(λ, 0)`` are the
  reference's. ``L x_new`` from the end of one iteration is the next
  iteration's ``L x`` (the reference computes it twice), so an iteration
  costs one matvec.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.graphs.laplacian import laplacian_dense, laplacian_matvec, \
    trace_l
from repro_torch.graphs.types import DenseGraph, EdgeList, on_device
from repro_torch.kernels.dispatch import Device

Graph = Union[DenseGraph, EdgeList]


def start_vector(n: int, seed: int = 0, x0=None,
                 device: Optional[torch.device] = None) -> torch.Tensor:
    """The unit start vector of the power iteration on ``device``: ``x0``
    if given, else a standard normal draw of ``torch.Generator("cpu")``
    seeded with ``seed``."""
    if x0 is None:
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        x0 = torch.randn((n,), generator=gen, dtype=torch.float32)
    x0 = torch.as_tensor(x0, dtype=torch.float32).to(device)
    if tuple(x0.shape) != (n,):
        raise ValueError(f"start vector has shape {tuple(x0.shape)}, "
                         f"expected ({n},)")
    return x0 / torch.linalg.norm(x0)


def power_iterate(ln_mv: Callable[[torch.Tensor], torch.Tensor],
                  x0: torch.Tensor, num_iters: int, tol: float,
                  info: Optional[dict] = None) -> torch.Tensor:
    """max(λ, 0) of the PSD operator ``ln_mv`` by power iteration from
    the unit vector ``x0``.

    Stops after ``num_iters`` iterations or once the Rayleigh quotient's
    relative change is at most ``tol``; a collapsed iterate (norm 0, e.g.
    the empty graph) keeps the previous one. ``info``, if given, gets
    ``iterations`` and ``matvecs``.
    """
    y = ln_mv(x0)
    lam = torch.dot(x0, y)
    lam_prev = lam + 1.0
    x, i = x0, 0
    while i < num_iters:
        rel = (lam - lam_prev).abs() / torch.clamp(lam.abs(), min=1e-30)
        if not bool(rel > tol):  # the one host sync of an iteration
            break
        norm = torch.linalg.norm(y)
        x = torch.where(norm > 0, y / torch.clamp(norm, min=1e-30), x)
        y = ln_mv(x)
        lam_prev, lam = lam, torch.dot(x, y)
        i += 1
    if info is not None:
        info.update(iterations=i, matvecs=i + 1)
    return torch.clamp(lam, min=0.0)


def power_iteration_lmax(g: Graph, num_iters: int = 100, tol: float = 1e-7,
                         seed: int = 0, x0=None, device: Device = None,
                         info: Optional[dict] = None) -> torch.Tensor:
    """Largest eigenvalue of L_N via matrix-free power iteration, on
    ``device`` (``None``: where the graph lies)."""
    g = on_device(g, device)
    mv = laplacian_matvec(g)
    s_total = trace_l(g)
    c = torch.where(s_total > 0, 1.0 / s_total, 0.0)
    x0 = start_vector(g.n_nodes, seed, x0, s_total.device)
    return power_iterate(lambda x: c * mv(x), x0, num_iters, tol, info)


def exact_eigvals_ln(g: Graph) -> torch.Tensor:
    """Full eigenspectrum of L_N (the O(n³) object FINGER avoids), by
    ``torch.linalg.eigvalsh``, ascending."""
    if isinstance(g, EdgeList):
        g = g.to_dense()
    lap = laplacian_dense(g)
    tr = torch.trace(lap)
    return torch.linalg.eigvalsh(lap / torch.where(tr > 0, tr, 1.0))


def lmax_lmin_positive(g: Graph, eps: float = 1e-12
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(λ_max, λ_min⁺): largest and smallest *positive* eigenvalue of L_N."""
    ev = exact_eigvals_ln(g)
    inf = torch.full_like(ev, float("inf"))
    return ev[-1], torch.where(ev > eps, ev, inf).min()
