"""Parity discovery: every kernel package of the port ships a parity.py.

A kernel package is a directory under ``repro_torch/kernels/`` that
holds an ``ops.py`` (the wrapper). `discover_parity_modules` imports
each one's ``parity.py`` (the kernel-vs-plain cases for the card) and
raises `ParityRegistrationError` naming any package without one, so a
kernel that is not held against its plain version cannot slip in. The
CPU tests run it, and ``chip_smoke.py`` phase 2 refuses to start unless
it checks every package it returns.
"""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import Dict

KERNELS = Path(__file__).resolve().parent


class ParityRegistrationError(RuntimeError):
    """A kernel package is missing its parity module."""


def discover_kernel_packages(root: Path = KERNELS) -> Dict[str, Path]:
    """Kernel package directories under ``root`` by name, sorted."""
    return {child.name: child for child in sorted(Path(root).iterdir())
            if child.is_dir() and (child / "ops.py").is_file()}


def discover_parity_modules(root: Path = KERNELS) -> Dict[str, ModuleType]:
    """Each kernel package's parity module by package name; raises
    `ParityRegistrationError` for a package without ``parity.py``."""
    pkgs = discover_kernel_packages(root)
    missing = sorted(n for n, p in pkgs.items()
                     if not (p / "parity.py").is_file())
    if missing:
        raise ParityRegistrationError(
            f"kernel package(s) {missing} under {root} have no parity.py; "
            "every kernel ships ref.py / ops.py / parity.py so that it is "
            "held against its plain version on the card")
    return {n: importlib.import_module(f"repro_torch.kernels.{n}.parity")
            for n in pkgs}
