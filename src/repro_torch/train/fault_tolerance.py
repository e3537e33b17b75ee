"""Fault tolerance: resume and straggler monitoring.

The port's copy of `repro.train.fault_tolerance` for one device:

- **Resume**: `latest_checkpoint` + deterministic (seed, step) data
  mean a preempted job restarts where it stopped, minus the in-flight
  step.
- **Straggler mitigation**: a per-step time EWMA with a z-score flag;
  the launcher feeds it each step's time on the card.

The reference's `elastic_restore` re-shards onto a TPU mesh and waits
for the multi-GPU port (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses

from repro_torch.train.checkpoint import latest_checkpoint, restore_checkpoint


def maybe_resume(ckpt_dir: str, template):
    """(tree, step) from the latest checkpoint, or (None, 0)."""
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return None, 0
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

    def stop(self, dt: float) -> bool:
        """Fold in one step's time ``dt`` (seconds, measured by the
        caller: on the card, CUDA events around the step); True if this
        step is a straggler."""
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
