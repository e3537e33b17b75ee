"""Fault tolerance: resume, elastic restore and straggler monitoring.

The port's copy of `repro.train.fault_tolerance`:

- **Resume**: `latest_checkpoint` + deterministic (seed, step) data
  mean a preempted job restarts where it stopped, minus the in-flight
  step.
- **Elastic restore**: a checkpoint holds host arrays by pytree name,
  whatever devices saved it; `elastic_restore` places them on the
  devices it is given (one device, or a tree of devices in the
  template's structure), where the reference places them under a new
  mesh's shardings. A job may resume on other devices than it saved
  from.
- **Straggler mitigation**: a per-step time EWMA with a z-score flag;
  the launcher feeds it each step's time on the card, and a caller
  without one times a step with `start` and `stop()` on the host
  clock, as the reference's launcher does.
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping
from typing import Optional

from repro_torch.kernels.dispatch import resolve_device
from repro_torch.train.checkpoint import latest_checkpoint, restore_checkpoint


def _place(tree, devices):
    """``tree``'s tensors moved to ``devices``: one device for a whole
    (sub)tree, or a tree of devices that mirrors ``tree`` down to where
    a single device covers the rest."""
    if not isinstance(devices, (Mapping, tuple)):
        dev = resolve_device(devices)
        if isinstance(tree, Mapping):
            return {k: _place(v, dev) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(_place(v, dev) for v in tree))
        return tree.to(dev)
    if isinstance(tree, Mapping):
        return {k: _place(v, devices[k]) for k, v in tree.items()}
    return type(tree)(*(_place(getattr(tree, f), getattr(devices, f))
                        for f in tree._fields))


def elastic_restore(ckpt_path: str, template, devices):
    """Restore a checkpoint onto ``devices`` (a device, or a tree of
    devices in ``template``'s structure): (tree, manifest). The
    template only gives the structure and shapes; it may lie anywhere,
    e.g. on the CPU."""
    tree, manifest = restore_checkpoint(ckpt_path, template)
    return _place(tree, devices), manifest


def maybe_resume(ckpt_dir: str, template, devices=None):
    """(tree, step) from the latest checkpoint, or (None, 0); with
    ``devices``, restored there by `elastic_restore`, else onto the
    template's devices."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None, 0
    if devices is not None:
        tree, manifest = elastic_restore(path, template, devices)
    else:
        tree, manifest = restore_checkpoint(path, template)
    return tree, int(manifest["step"])


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flags steps slower than mean + k·std."""

    alpha: float = 0.1
    z_threshold: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: int = 0
    _t0: Optional[float] = None

    def start(self) -> None:
        """Start timing a step on the host clock."""
        self._t0 = time.perf_counter()

    def stop(self, dt: Optional[float] = None) -> bool:
        """Fold in one step's time ``dt`` (seconds; measured by the
        caller, e.g. CUDA events around the step, or, when None, the
        host time since `start`); True if this step is a straggler."""
        if dt is None:
            if self._t0 is None:
                raise RuntimeError("StragglerMonitor.stop() without dt "
                                   "needs a start() first")
            dt = time.perf_counter() - self._t0
        self.n += 1
        if self.n == 1:
            self.mean, self.var = dt, 0.0
            return False
        # score against the PRE-update statistics, then fold the sample in
        std = max(self.var ** 0.5, 1e-9)
        is_straggler = self.n > 3 and (dt - self.mean) / std > self.z_threshold
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        if is_straggler:
            self.flagged += 1
        return is_straggler
