"""Shard-failure recovery: rebuild a dead shard's tenants on survivors.

The port's counterpart of `repro.fleet.recovery`, with the same named
`RecoveryError`s. Each tenant is rebuilt as ``base ⊕ replay(wal)``:

- ``base`` is the tenant-space snapshot in its directory entry, or —
  after a fleet save truncated it — the dead shard's *on-disk serving
  checkpoint* (either package's format), walked forward through the
  shard's journaled layout migrations (`migrate.migrate_host_arrays`)
  to the layout at death so the directory's position maps index it
  correctly, then gathered to tenant space;
- ``replay(wal)`` re-applies the tenant's own deltas since the base
  through the exact incremental update (`core.jsdist.jsdist_incremental`,
  ``method="dense"``) on the fleet's device — including any tick that
  was staged when the shard died (the WAL is appended at ingest, before
  the device ever sees the delta). A dead shard's tenants replay
  together, stacked (`replay_tenants`): one batched update a round
  instead of one a tenant.

The rebuilt tenant is then placed on a surviving *dense* shard (same
bucket first, spilling up) and installed at identity positions —
sparse slot-space tenants also land on dense pools, since their edge
store cannot be reconstructed from FINGER statistics. A dead sparse
shard's disk base is gathered to tenant space through the per-stream
`SlotMap` payloads its checkpoint manifest serializes (virtual id →
slot), in place of a dense position map.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.jsdist import jsdist_incremental
from repro_torch.core.state import FingerState
from repro_torch.engine.stream import restore_stacked_state
from repro_torch.fleet.errors import AdmissionError, RecoveryError
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.serving import migrate


@dataclasses.dataclass(frozen=True)
class DeadShard:
    """What the fleet remembers about a killed shard: enough to read
    its last checkpoint and interpret the directory's position maps
    (which are addressed in the layout at death)."""

    pool: int
    shard: int
    layout: NodeLayout
    step: int
    ckpt_dir: Optional[str]
    method: str


def replay_tenant(base: dict, wal: List[Tuple[int, GraphDelta]],
                  base_step: int, exact_smax: bool,
                  device: Device = None) -> Tuple[dict, Optional[float]]:
    """``base ⊕ replay(wal entries past base_step)`` in tenant space, on
    ``device`` (``None`` is CUDA).

    Returns the rebuilt tenant-space snapshot on the host (its node
    space grown to cover every replayed delta) and the last replayed
    JSdist score (None when nothing replayed). The dense incremental
    update is the reference the serving paths are tested against, so
    the rebuilt state matches the lost shard's to float tolerance. One
    tenant of `replay_tenants`.
    """
    return replay_tenants([base], [wal], [base_step], exact_smax,
                          device=device)[0]


def _lanes(d: GraphDelta, k: int, j: int) -> dict:
    """One tenant-space delta's fields as host arrays padded to k edge
    lanes and j node slots (mask and flags 0 on the padding)."""
    out = {}
    for name, width in (("senders", k), ("receivers", k), ("dw", k),
                        ("w_old", k), ("mask", k), ("node_ids", j),
                        ("node_flag", j)):
        x = getattr(d, name)
        row = np.zeros(width, np.int32 if name in ("senders", "receivers",
                                                   "node_ids")
                       else np.float32)
        if x is not None:
            x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)
            row[:x.shape[-1]] = x
        out[name] = row
    return out


def replay_tenants(bases: List[dict],
                   wals: List[List[Tuple[int, GraphDelta]]],
                   base_steps: List[int], exact_smax: bool,
                   device: Device = None
                   ) -> List[Tuple[dict, Optional[float]]]:
    """`replay_tenant` for many tenants at once, on ``device``: their
    states stacked into one (T, N) state (N the largest node space any
    of them reaches, the rest inactive zero padding, which no FINGER
    statistic sees), and round r applies every tenant's r-th WAL entry
    past its base in one batched update. A tenant without an r-th entry
    keeps its row as it was. Tenants are independent rows, so this is
    each tenant's own replay; only the float rounding of a row's sums
    may differ from a replay at the tenant's own size.
    """
    device = resolve_device(device)
    todo = [[d for step, d in wal if step > base_step]
            for wal, base_step in zip(wals, base_steps)]
    sizes = [int(np.asarray(base["strengths"]).shape[0]) for base in bases]
    final = [max([n] + [d.n_nodes for d in t]) for n, t in zip(sizes, todo)]
    t, n = len(bases), max(final)
    strengths = np.zeros((t, n), np.float32)
    mask = np.zeros((t, n), np.float32)
    for i, base in enumerate(bases):
        strengths[i, :sizes[i]] = base["strengths"]
        mask[i, :sizes[i]] = base["node_mask"]

    def scalars(key):
        return torch.tensor([float(b[key]) for b in bases],
                            dtype=torch.float32, device=device)

    state = FingerState(
        q=scalars("q"), s_total=scalars("s_total"), s_max=scalars("s_max"),
        strengths=torch.from_numpy(strengths).to(device),
        node_mask=torch.from_numpy(mask).to(device), layout=NodeLayout(n))
    entries = [d for tt in todo for d in tt]
    k = max([d.dw.shape[-1] for d in entries] + [1])
    j = max([d.node_ids.shape[-1] for d in entries
             if d.node_ids is not None] + [0])
    last = torch.zeros((t,), dtype=torch.float32, device=device)
    for r in range(max([len(tt) for tt in todo] + [0])):
        live = np.array([len(tt) > r for tt in todo])
        empty = GraphDelta.from_arrays([], [], [], [], n_nodes=0, k_pad=k)
        rows = [_lanes(tt[r] if len(tt) > r else empty, k, j)
                for tt in todo]
        fields = {name: torch.from_numpy(np.stack([x[name] for x in rows]))
                  for name in rows[0]}
        if j == 0:
            del fields["node_ids"], fields["node_flag"]
        delta = GraphDelta(n_nodes=n, **fields).to(device)
        dist, new = jsdist_incremental(state, delta, exact_smax=exact_smax,
                                       method="dense")
        keep = torch.from_numpy(live).to(device)
        state = FingerState(**{
            f: torch.where(keep[:, None] if getattr(state, f).dim() > 1
                           else keep, getattr(new, f), getattr(state, f))
            for f in ("q", "s_total", "s_max", "strengths", "node_mask")},
            layout=state.layout)
        last = torch.where(keep, dist, last)
    host = {f: getattr(state, f).cpu().numpy()
            for f in ("q", "s_total", "s_max", "strengths", "node_mask")}
    last = last.cpu().numpy()
    return [({"q": float(host["q"][i]), "s_total": float(host["s_total"][i]),
              "s_max": float(host["s_max"][i]),
              "strengths": host["strengths"][i, :final[i]].copy(),
              "node_mask": host["node_mask"][i, :final[i]].copy()},
             float(last[i]) if todo[i] else None)
            for i in range(t)]


def _load_dead_checkpoint(dead: DeadShard, exact_smax: bool):
    """The dead shard's last checkpoint, walked to the layout at death
    (so directory position maps index it): per-stream scalars plus the
    (B, n_pad_death) strengths/mask, on the host. Sparse checkpoints
    skip the layout walk — slot ids survive capacity growth unchanged —
    and surface the serialized per-stream `SlotMap` payloads instead
    (the gather table sparse tenants are read through)."""
    states, step_saved, meta = restore_stacked_state(
        dead.ckpt_dir, exact_smax=exact_smax, method=dead.method)
    strengths = states.strengths.numpy()
    mask = np.ones_like(strengths) if states.node_mask is None \
        else states.node_mask.numpy()
    slot_maps = None
    if dead.method == "sparse_tick":
        slot_maps = meta.get("slot_maps")
    else:
        gen = int(meta.get("layout_generation", 0))
        if (strengths.shape[-1] != dead.layout.n_pad
                or gen != dead.layout.generation):
            log = migrate.load_layout_log(dead.ckpt_dir)
            strengths, mask, gen, _ = migrate.migrate_host_arrays(
                strengths, mask, log, gen, dead.layout.n_pad)
    return {
        "strengths": strengths, "node_mask": mask,
        "q": states.q.numpy(), "s_total": states.s_total.numpy(),
        "s_max": states.s_max.numpy(),
        "step": int(step_saved),
        "slot_maps": slot_maps,
    }


def recover_shard(fleet, dead: DeadShard) -> List[dict]:
    """Restore every tenant of one dead shard onto survivors (see
    module docstring): every tenant's base first (a gapped WAL or a
    missing base raises before any tenant moves), one batched replay on
    the fleet's device (`replay_tenants`), then placement and
    installation in directory order. Returns one report dict per
    tenant."""
    pool = fleet.config.pools[dead.pool]
    tenants = fleet.directory.tenants_on(dead.pool, dead.shard)
    disk = None
    bases, base_steps = [], []
    for entry in tenants:
        if entry.wal_floor > entry.base_step:
            # The retention policy pruned WAL entries the durable base
            # does not cover: steps (base_step, wal_floor] are gone,
            # so base ⊕ replay(wal) would silently skip them.
            raise RecoveryError(
                f"tenant {entry.name!r}: WAL steps "
                f"({entry.base_step}, {entry.wal_floor}] were "
                f"truncated by the retention policy "
                f"(wal_retention_ticks) before a durable base covered "
                "them — recovery cannot replay a gapped log; lower "
                "the retention window or save() the fleet more often")
        if entry.base_state is not None:
            bases.append(entry.base_state)
            base_steps.append(entry.base_step)
            continue
        if dead.ckpt_dir is None:
            raise RecoveryError(
                f"tenant {entry.name!r}: no in-memory base and "
                f"shard ({pool.name!r}, {dead.shard}) has no "
                "checkpoint directory")
        if disk is None:
            try:
                disk = _load_dead_checkpoint(dead, pool.exact_smax)
            except FileNotFoundError as e:
                raise RecoveryError(f"tenant {entry.name!r}: {e}") from e
        bases.append(_disk_base(disk, entry, pool, dead))
        base_steps.append(disk["step"])
    replayed = replay_tenants(bases, [e.wal for e in tenants], base_steps,
                              pool.exact_smax, device=fleet.device) \
        if tenants else []
    reports = []
    for entry, (new_base, last) in zip(tenants, replayed):
        n_t = int(new_base["strengths"].shape[0])
        try:
            tgt_pool, tgt_shard, tgt_slot = fleet.router.place(
                n_t, fleet.live_shards(),
                min_pool=dead.pool if pool.method != "sparse_tick"
                else 0,
                dense_only=True)
        except AdmissionError as e:
            raise RecoveryError(
                f"tenant {entry.name!r}: no surviving dense shard "
                f"fits its {n_t} node slot(s): {e}") from e
        fleet.install_dense(tgt_pool, tgt_shard, tgt_slot, new_base)
        entry.pool, entry.shard, entry.slot = (tgt_pool, tgt_shard,
                                               tgt_slot)
        entry.n_nodes = n_t
        entry.slot_of_node = np.arange(n_t, dtype=np.int32)
        entry.base_state = new_base
        entry.base_step = fleet.step
        entry.wal = []
        entry.wal_floor = fleet.step
        entry.installed_step = fleet.step
        if last is not None:
            entry.last_score = last
        reports.append({"tenant": entry.name,
                        "to": (tgt_pool, tgt_shard, tgt_slot),
                        "replayed": last is not None})
    return reports


def _disk_base(disk: dict, entry, pool, dead: DeadShard) -> dict:
    """One tenant's tenant-space base out of its dead shard's
    checkpoint row: gathered through its position map, or through the
    checkpoint's serialized `SlotMap` for a sparse tenant."""
    row_s = disk["strengths"][entry.slot]
    row_m = disk["node_mask"][entry.slot]
    strengths = np.zeros((entry.n_nodes,), np.float32)
    mask = np.zeros((entry.n_nodes,), np.float32)
    if pool.method == "sparse_tick":
        if not disk["slot_maps"]:
            raise RecoveryError(
                f"tenant {entry.name!r}: sparse shard "
                f"({pool.name!r}, {dead.shard})'s checkpoint "
                "carries no SlotMap payloads (it predates "
                "sparse persistence) — its slot assignments "
                "are unrecoverable")
        for vid, slot in disk["slot_maps"][entry.slot]["node_slot"]:
            if vid < entry.n_nodes:
                strengths[vid] = row_s[slot]
                mask[vid] = row_m[slot]
    else:
        som = entry.slot_of_node
        valid = np.nonzero(som >= 0)[0]
        strengths[valid] = row_s[som[valid]]
        mask[valid] = row_m[som[valid]]
    return {"q": float(disk["q"][entry.slot]),
            "s_total": float(disk["s_total"][entry.slot]),
            "s_max": float(disk["s_max"][entry.slot]),
            "strengths": strengths, "node_mask": mask}
