"""Checkpointing: atomic, content-addressed-by-step.

The port's copy of `repro.train.checkpoint`, with the same on-disk
format, so a checkpoint written by either package restores in the
other: tensors are copied to the host and written as one compressed
``arrays.npz`` keyed by the reference's pytree names (`flatten_names`:
``params/blocks/L0/attn/wq``, ``opt/.step``, ``opt/.mu/embed``, ...),
plus a small JSON ``manifest.json`` (step, time, n_arrays, metadata).
Writes are atomic (tmp dir + rename), so a crash mid-write never
corrupts the latest checkpoint. `restore_checkpoint` returns tensors in
the template's structure, each on its template leaf's device.

Pruning is a pluggable policy (``prune_policy`` on `save_checkpoint`):

- ``int k`` / ``("keep_last", k)``   : keep the newest k checkpoints.
- ``("keep_every_n", n, k)``         : keep every step divisible by n
  (the long-horizon archive) plus the newest k regardless (the
  crash-recovery window).
- ``callable(steps) -> keep``        : full control; receives the
  ascending list of on-disk step ints, returns those to keep. The
  newest step always survives — a policy can never prune the
  checkpoint that was just written.

All step ordering (pruning and `latest_checkpoint`) is numeric on the
parsed step int, not lexicographic on the directory name, so steps past
the 8-digit zero-pad (or older checkpoints written with a different
width) order correctly.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.models.params import flatten_names

PrunePolicy = Union[int, Tuple, Callable[[List[int]], Any]]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _list_steps(ckpt_dir: str) -> List[Tuple[int, str]]:
    """On-disk checkpoints as (step int, dirname), ascending by step."""
    out = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.isdir(os.path.join(ckpt_dir, d)):
            out.append((int(m.group(1)), d))
    out.sort()
    return out


def resolve_prune_policy(policy: PrunePolicy) -> Callable[[List[int]], set]:
    """Normalize a prune-policy spec to ``steps -> set(steps to keep)``.

    See the module docstring for the accepted forms. Raises ValueError
    (named) for malformed specs so a bad config fails at save time, not
    by silently keeping everything.
    """
    if callable(policy):
        return lambda steps: set(policy(steps))
    if isinstance(policy, int) and not isinstance(policy, bool):
        if policy <= 0:
            raise ValueError(f"prune_policy keep_last={policy} must be "
                             "positive")
        return lambda steps: set(steps[-policy:])
    if isinstance(policy, tuple) and policy:
        if policy[0] == "keep_last" and len(policy) == 2:
            return resolve_prune_policy(policy[1])
        if policy[0] == "keep_every_n" and len(policy) == 3:
            _, n, k = policy
            if not (isinstance(n, int) and n > 0):
                raise ValueError(f"keep_every_n period must be a "
                                 f"positive int, got {n!r}")
            keep_last = resolve_prune_policy(k)
            return lambda steps: ({s for s in steps if s % n == 0}
                                  | keep_last(steps))
    raise ValueError(
        f"unknown prune_policy {policy!r}; want an int, "
        "('keep_last', k), ('keep_every_n', n, k), or a callable")


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    metadata: Optional[dict] = None,
                    prune_policy: PrunePolicy = 3) -> str:
    """Atomically write checkpoint `step`; prune old ones by policy
    (keep the newest 3 by default). The reference's legacy ``keep_last``
    spelling has no caller in the port and is not copied."""
    keep_fn = resolve_prune_policy(prune_policy)  # fail before writing
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp.{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: v.detach().cpu().numpy()
              for k, v in flatten_names(tree).items()}
    np.savez_compressed(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "time": time.time(),
                "n_arrays": len(arrays),
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        # json.dumps encodes in C; json.dump streams through the Python
        # encoder, 10x slower on a sparse service's SlotMap payloads
        f.write(json.dumps(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _prune(ckpt_dir, keep_fn, just_written=step)
    return final


def _prune(ckpt_dir: str, keep_fn: Callable[[List[int]], set],
           just_written: Optional[int] = None):
    entries = _list_steps(ckpt_dir)
    if not entries:
        return
    steps = [s for s, _ in entries]
    keep = set(keep_fn(steps))
    # The checkpoint this save just wrote always survives — even when a
    # reused directory holds numerically higher steps from an older run.
    keep.add(steps[-1] if just_written is None else just_written)
    for s, d in entries:
        if s not in keep:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Highest-*step* complete checkpoint (numeric ordering)."""
    if not os.path.isdir(ckpt_dir):
        return None
    complete = [(s, d) for s, d in _list_steps(ckpt_dir)
                if os.path.exists(os.path.join(ckpt_dir, d,
                                               "manifest.json"))]
    return os.path.join(ckpt_dir, complete[-1][1]) if complete else None


def load_manifest(path: str) -> dict:
    """The checkpoint's manifest (step, time, metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _rebuild(template, leaf_fn, prefix: str = ""):
    """A tree of `template`'s structure with each leaf ``leaf_fn(name,
    leaf)``, named as `flatten_names` names it."""
    def join(key):
        return f"{prefix}/{key}" if prefix else key

    if isinstance(template, dict):
        return {k: _rebuild(v, leaf_fn, join(str(k)))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), leaf_fn,
                                         join(f".{f}"))
                                for f in template._fields))
    return leaf_fn(prefix, template)


def restore_checkpoint(path: str, template,
                       manifest: Optional[dict] = None) -> Tuple[Any, dict]:
    """Restore into the structure of `template` (a tree of tensors).

    Each leaf comes back as a tensor of the stored dtype on its template
    leaf's device. Callers that already loaded the manifest can pass it
    to avoid a second read.
    """
    if manifest is None:
        manifest = load_manifest(path)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def leaf(name, tpl):
            arr = data[name]
            want = tuple(tpl.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"{name}: checkpoint {arr.shape} != {want}")
            return torch.from_numpy(arr).to(tpl.device)

        return _rebuild(template, leaf), manifest
