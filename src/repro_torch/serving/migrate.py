"""Layout migrations of the serving state.

The port's counterpart of `repro.serving.migrate`. The state transforms
run on the stacked state's own device, as plain PyTorch ops:

- ``grow_stacked`` embeds the stacked (B, n_pad) `FingerState` into a
  larger layout: new slots inactive with zero strength, which is exact
  for every FINGER statistic.
- ``compact_stacked_auto`` drops the slots inactive in every stream and
  renumbers the survivors to a packed prefix. The occupancy reduction,
  the prefix-sum renumbering and the gather all run on the device; the
  old→new ``index_map`` comes back as a small (n_pad,) device tensor,
  the one thing the caller reads back (for the journal and the
  ingestion grace table).
- ``truncate_stacked`` is the tail-only shrink (`repad` downward).
- ``grow_sparse_stacked`` pads a stacked `SparseStreamState` to grown
  capacities; slot ids are kept, so nothing is renumbered.
- ``take_stream`` / ``put_stream`` / ``clear_stream`` read, write and
  zero one stream's row: the fleet's hand-off hooks. ``take_stream``
  returns a copy, never a view of the state the next in-place tick
  overwrites; the other two write the stacked state in place.

Sharded states (the sharded placements' `Sharded` of per-shard
stacked states) go through the same functions: the transforms run shard
by shard on each shard's device, the occupancy is the OR of every
shard's, so a compaction's one index map (computed on the first shard's
device) renumbers every shard alike, and the row hooks address a global
stream slot in its shard.

Deltas: ``remap_delta`` renumbers a delta addressed in an older layout
through an index map, on whatever device the delta lives, and raises
`LayoutMigrationError` when a live lane or node slot addresses a
dropped slot; ``embed_delta`` / ``embed_sparse_delta`` re-address a
delta into a grown layout (a size change only).

The journal: every migration appends a record to ``layout_log.json``
in the checkpoint directory, in the reference's JSON, so either
package reads the other's log. `FingerService.restore` walks an
older-generation checkpoint forward through it
(``migrate_host_arrays``) and rebuilds the ingestion remap tables
(``remaps_from_records``, ``remaps_by_generation``).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparse import SparseLayout, SparseStreamState
from repro_torch.core.state import FingerState
from repro_torch.distributed.sharding import Sharded, each
from repro_torch.graphs.layout import (NodeLayout, compose_index_maps,
                                       identity_index_map)
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving.config import ServiceConfigError

LAYOUT_LOG = "layout_log.json"

State = Union[FingerState, SparseStreamState]
Placed = Union[State, Sharded]


class LayoutMigrationError(ServiceConfigError):
    """A layout migration would lose information (truncating active
    slots, remapping a delta that addresses a dropped slot, restoring a
    checkpoint with no migration chain to the requested layout,
    shrinking a sparse capacity)."""


# -- device-side state transforms -----------------------------------------

def _stacked_mask(states: FingerState) -> torch.Tensor:
    """The node mask, with the legacy mask-less (fully live) default."""
    mask = states.node_mask
    return torch.ones_like(states.strengths) if mask is None else mask


def _occupancy_device(mask: torch.Tensor) -> torch.Tensor:
    """(n_pad,) slot-live-in-any-stream reduction, on the device."""
    if mask.dim() > 1:
        mask = mask.amax(dim=tuple(range(mask.dim() - 1)))
    return mask > 0


def _parts(states: Placed) -> Tuple[State, ...]:
    return states.parts if isinstance(states, Sharded) else (states,)


def _occupancy_placed(states: Placed) -> torch.Tensor:
    """The occupancy of every shard, OR-ed on the first shard's device
    (one (n_pad,) vector a shard moves)."""
    parts = _parts(states)
    dev = parts[0].strengths.device
    occ = None
    for p in parts:
        o = _occupancy_device(_stacked_mask(p)).to(dev)
        occ = o if occ is None else occ | o
    return occ


def per_shard(fn):
    """Apply a stacked-state transform ``fn(states, *args)`` to each
    shard of a `Sharded` state (on its own device), or to the state."""
    @functools.wraps(fn)
    def apply(states, *args, **kwargs):
        return each(lambda st: fn(st, *args, **kwargs), states)
    return apply


@per_shard
def grow_stacked(states: FingerState,
                 new_layout: NodeLayout) -> FingerState:
    """Embed the stacked state into a larger layout on its device. Old
    slots keep their ids; new slots are inactive with zero strength."""
    old_n_pad = int(states.strengths.shape[-1])
    if new_layout.n_pad <= old_n_pad:
        raise LayoutMigrationError(
            f"grow_stacked: new layout n_pad={new_layout.n_pad} does "
            f"not grow the current n_pad={old_n_pad}")
    grow = (0, new_layout.n_pad - old_n_pad)
    pad = torch.nn.functional.pad
    return FingerState(
        q=states.q, s_total=states.s_total, s_max=states.s_max,
        strengths=pad(states.strengths, grow),
        node_mask=pad(_stacked_mask(states), grow), layout=new_layout)


def compact_stacked_auto(states: Placed, new_layout: NodeLayout
                         ) -> Tuple[Placed, torch.Tensor]:
    """Compact to ``new_layout``: occupancy, renumbering and gather on
    the device (each shard's gather on its own; the map from the
    occupancy of all). Returns ``(compacted_states, index_map)``, the
    map an (old_n_pad,) int32 tensor on the first shard's device (old
    slot → new slot, -1 dropped).

    Dropped slots are inactive in every stream (zero strength, zero
    mask), so Q, S and s_max pass through and the gathered strengths
    are the old ones renumbered. The caller must have checked that
    ``new_layout.n_pad`` holds every live slot (`FingerService.compact`
    does, against the live-slot count).
    """
    old_n_pad = int(_parts(states)[0].strengths.shape[-1])
    new_n_pad = new_layout.n_pad
    if new_n_pad > old_n_pad:
        raise LayoutMigrationError(
            f"compact_stacked_auto: new layout n_pad={new_n_pad} "
            f"exceeds the current n_pad={old_n_pad} (grow_stacked "
            "grows)")
    occ = _occupancy_placed(states)
    # Live slot i → the number of live slots before it.
    new_idx = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32) - 1
    index_map = torch.where(occ, new_idx, -1).to(torch.int32)
    # The old slot feeding each new slot: live slots sort by their new
    # ids, dead ones last.
    keys = torch.where(occ, new_idx, old_n_pad)
    old_of = torch.argsort(keys, stable=True)[:new_n_pad]
    valid = torch.arange(new_n_pad, device=occ.device) < occ.sum()

    def one(st: FingerState) -> FingerState:
        dev = st.strengths.device
        src, ok = old_of.to(dev), valid.to(dev)

        def gather(x):
            return torch.where(ok, x[..., src], 0.0)

        return FingerState(
            q=st.q, s_total=st.s_total, s_max=st.s_max,
            strengths=gather(st.strengths),
            node_mask=gather(_stacked_mask(st)), layout=new_layout)

    return each(one, states), index_map


@per_shard
def truncate_stacked(states: FingerState,
                     new_layout: NodeLayout) -> FingerState:
    """Tail-only shrink: slots [0, new_n_pad) keep their ids. The caller
    must have checked that the cut tail is inactive in every stream."""
    old_n_pad = int(states.strengths.shape[-1])
    n_new = new_layout.n_pad
    if n_new >= old_n_pad:
        raise LayoutMigrationError(
            f"truncate_stacked: new layout n_pad={n_new} does not "
            f"shrink the current n_pad={old_n_pad}")
    return FingerState(
        q=states.q, s_total=states.s_total, s_max=states.s_max,
        strengths=states.strengths[..., :n_new].contiguous(),
        node_mask=_stacked_mask(states)[..., :n_new].contiguous(),
        layout=new_layout)


@per_shard
def grow_sparse_stacked(states: SparseStreamState,
                        new_layout: SparseLayout) -> SparseStreamState:
    """A stacked `SparseStreamState` padded to grown capacities, on its
    own device: the (B, n_slots) strengths and mask and the (B, m_pad)
    edge store get inactive zeros. Slot ids are kept (growth only
    appends free slots to each `SlotMap`)."""
    old_n, old_m = states.n_slots, states.m_pad
    if new_layout.n_slots < old_n or new_layout.m_pad < old_m:
        raise LayoutMigrationError(
            f"grow_sparse_stacked: new capacities (n_slots="
            f"{new_layout.n_slots}, m_pad={new_layout.m_pad}) shrink "
            f"the current ({old_n}, {old_m}); sparse capacity only "
            "grows (freed slots are reused by the SlotMap, so there is "
            "nothing to compact)")
    dn, dm = new_layout.n_slots - old_n, new_layout.m_pad - old_m
    pad = torch.nn.functional.pad
    return SparseStreamState(
        q=states.q, s_total=states.s_total, s_max=states.s_max,
        strengths=pad(states.strengths, (0, dn)),
        node_mask=pad(states.node_mask, (0, dn)),
        edge_weights=pad(states.edge_weights, (0, dm)),
        layout=new_layout)


def live_slot_count(states: Placed) -> int:
    """Slots live in any stream: one device reduction (a shard), one
    scalar read."""
    return int(_occupancy_placed(states).sum())


def occupancy(states: Placed) -> np.ndarray:
    """(n_pad,) bool, slot live in any stream: one device reduction (a
    shard) and the read of an (n_pad,) vector, never of the stacked
    state."""
    return _occupancy_placed(states).cpu().numpy()


# -- one stream's row (the fleet's hand-off hooks) ------------------------

def _locate(what: str, states: Placed, slot: int) -> Tuple[State, int]:
    """The stacked state (a shard's, when sharded) holding global stream
    ``slot``, and the slot's row in it."""
    parts = _parts(states)
    rows = int(parts[0].q.shape[0])
    b = rows * len(parts)
    if not 0 <= int(slot) < b:
        raise LayoutMigrationError(
            f"{what}: slot {int(slot)} outside the stacked batch of {b} "
            "stream(s)")
    shard, local = divmod(int(slot), rows)
    return parts[shard], local


def take_stream(states: Placed, slot: int) -> State:
    """One stream's row (slot axis dropped), copied: the stacked state
    is left as it is, and the next in-place tick does not change the
    row."""
    part, local = _locate("take_stream", states, slot)
    return part.map_tensors(lambda x: x[local].clone())


def put_stream(states: Placed, row: State, slot: int) -> Placed:
    """Write ``row`` (a single-stream state, as from `take_stream`;
    tensors on any device, or numpy arrays) into ``slot`` of the stacked
    state, in place. The row must carry the same layout (n_pad and
    generation, or the sparse capacities) and the same fields."""
    part, local = _locate("put_stream", states, slot)
    if type(row) is not type(part) or row.layout != part.layout \
            or row.tensors().keys() != part.tensors().keys():
        raise LayoutMigrationError(
            f"put_stream: row {type(row).__name__}(layout={row.layout}, "
            f"fields={sorted(row.tensors())}) does not match the stacked "
            f"{type(part).__name__}(layout={part.layout}, "
            f"fields={sorted(part.tensors())}) — the row must carry "
            "the same static layout (n_pad + generation) as the target "
            "shard")
    rows = row.tensors()
    for name, x in part.tensors().items():
        r = torch.as_tensor(rows[name], dtype=x.dtype)
        if tuple(r.shape) != tuple(x.shape[1:]):
            raise LayoutMigrationError(
                f"put_stream: row field {name} has shape "
                f"{tuple(r.shape)}, not {tuple(x.shape[1:])}")
        x[local].copy_(r)
    return states


def clear_stream(states: Placed, slot: int) -> Placed:
    """Zero one stream's row in place (the free-slot state: mask 0,
    strength 0, Q/S/s_max 0 — its JSdist against an empty delta is 0)."""
    part, local = _locate("clear_stream", states, slot)
    for x in part.tensors().values():
        x[local].zero_()
    return states


# -- delta re-addressing ---------------------------------------------------

def _remap_ids(ids: torch.Tensor, imap: torch.Tensor,
               new_n_pad: int) -> torch.Tensor:
    """Old ids → new ids through ``imap``; -1 where the old slot was
    dropped, ``new_n_pad`` (outside the layout, so the tick gates the
    lane off as it did before) where the old id was outside the old
    layout."""
    n = imap.shape[0]
    inside = (ids >= 0) & (ids < n)
    mapped = imap[ids.long().clamp(0, n - 1)]
    return torch.where(inside, mapped, new_n_pad)


def remap_delta(delta: GraphDelta, index_map: np.ndarray,
                new_n_pad: int) -> GraphDelta:
    """Renumber a delta addressed in an older layout through
    ``index_map``, on the delta's device.

    A live lane or node join/leave addressing a *dropped* slot is a
    lossy remap and raises `LayoutMigrationError` (a dropped slot was
    inactive in every stream, so only a join, or a stale producer, can
    hit one). Masked lanes that map to a dropped slot get id 0.
    """
    dev = delta.senders.device
    imap = torch.as_tensor(np.asarray(index_map, np.int32), device=dev)
    ms = _remap_ids(delta.senders, imap, new_n_pad)
    mr = _remap_ids(delta.receivers, imap, new_n_pad)
    live = delta.mask > 0
    lost = torch.cat([delta.senders[live & (ms < 0)],
                      delta.receivers[live & (mr < 0)]])
    if lost.numel():
        bad = sorted(set(lost.cpu().tolist()))
        raise LayoutMigrationError(
            f"remap_delta: delta edge(s) address dropped node slot(s) "
            f"{bad[:8]} of the old layout; those slots were reclaimed "
            "by compact() and no longer exist")
    node_ids = delta.node_ids
    if node_ids is not None:
        mi = _remap_ids(node_ids, imap, new_n_pad)
        lost = node_ids[(mi < 0) & (delta.node_flag != 0)]
        if lost.numel():
            bad = sorted(set(lost.cpu().tolist()))
            raise LayoutMigrationError(
                f"remap_delta: node join/leave slot(s) {bad[:8]} "
                "address dropped node slots of the old layout; re-issue "
                "them against the compacted layout (or repad to grow)")
        node_ids = mi.clamp(min=0).to(torch.int32)
    return GraphDelta(
        senders=ms.clamp(min=0).to(torch.int32),
        receivers=mr.clamp(min=0).to(torch.int32),
        dw=delta.dw, w_old=delta.w_old, mask=delta.mask,
        n_nodes=int(new_n_pad), node_ids=node_ids,
        node_flag=delta.node_flag)


def embed_delta(delta: GraphDelta, new_n_pad: int) -> GraphDelta:
    """Re-address a delta into a larger layout: node ids are unchanged
    by a growth, so only the static size changes (no tensor work)."""
    if new_n_pad < delta.n_nodes:
        raise LayoutMigrationError(
            f"embed_delta: new_n_pad={new_n_pad} < delta layout "
            f"{delta.n_nodes}")
    return dataclasses.replace(delta, n_nodes=int(new_n_pad),
                               layout_generation=None)


def embed_sparse_delta(delta: GraphDelta, new_n_slots: int) -> GraphDelta:
    """Re-address a slot-space delta into a grown slot capacity: slot
    ids, and the edge-slot sentinel, are unchanged by a growth, so only
    the static slot-space size changes (no tensor work)."""
    if new_n_slots < delta.n_nodes:
        raise LayoutMigrationError(
            f"embed_sparse_delta: new_n_slots={new_n_slots} < delta "
            f"slot space {delta.n_nodes}")
    return dataclasses.replace(delta, n_nodes=int(new_n_slots))


# -- the on-disk migration journal ----------------------------------------

def migration_record(kind: str, old: NodeLayout, new: NodeLayout,
                     index_map: Optional[np.ndarray]) -> dict:
    return {
        "kind": kind,
        "from_generation": old.generation,
        "to_generation": new.generation,
        "old_n_pad": old.n_pad,
        "new_n_pad": new.n_pad,
        "index_map": None if index_map is None
        else np.asarray(index_map, np.int32).tolist(),
    }


def check_journalable(ckpt_dir: Optional[str], generation: int) -> None:
    """Refuse a migration that would fork the journal (a second record
    from one generation makes the restore walk ambiguous). Called
    before any state is touched, so a refused migration changes
    nothing."""
    if ckpt_dir is None:
        return
    dup = [r for r in load_layout_log(ckpt_dir)
           if r["from_generation"] == generation]
    if dup:
        raise LayoutMigrationError(
            f"layout log in {ckpt_dir!r} already records a migration "
            f"from generation {generation} (n_pad "
            f"{dup[0]['old_n_pad']}→{dup[0]['new_n_pad']}): migrating a "
            "service restored at an older generation in the same "
            "directory would fork the journal and corrupt "
            "cross-generation restores — point "
            "ServiceConfig.checkpoint.directory at a fresh directory "
            "to fork the deployment")


def append_layout_record(ckpt_dir: str, record: dict) -> str:
    """Append one migration record to the directory's layout log
    (atomic tmp + rename, as the checkpoints)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, LAYOUT_LOG)
    check_journalable(ckpt_dir, record["from_generation"])
    log = load_layout_log(ckpt_dir)
    log.append(record)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(log, f)
    os.replace(tmp, path)
    return path


def load_layout_log(ckpt_dir: str) -> List[dict]:
    path = os.path.join(ckpt_dir, LAYOUT_LOG)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f)


def migrate_host_arrays(
    strengths: np.ndarray, node_mask: Optional[np.ndarray],
    log: List[dict], from_generation: int, target_n_pad: int,
) -> Tuple[np.ndarray, np.ndarray, int, List[dict]]:
    """Walk host (B, n_pad) arrays forward through the migration log
    until they reach ``target_n_pad``.

    Returns ``(strengths, node_mask, generation, applied_records)``.
    Raises `LayoutMigrationError` when the log holds no chain from
    ``from_generation`` to a layout of the target size.
    """
    strengths = np.asarray(strengths)
    if node_mask is None:
        node_mask = np.ones_like(strengths)
    node_mask = np.asarray(node_mask)
    by_from = {rec["from_generation"]: rec for rec in log}
    gen = int(from_generation)
    applied: List[dict] = []
    while strengths.shape[-1] != target_n_pad:
        rec = by_from.get(gen)
        if rec is None:
            raise LayoutMigrationError(
                f"restore: checkpoint layout (n_pad="
                f"{strengths.shape[-1]}, generation {gen}) has no "
                f"recorded migration chain to n_pad={target_n_pad}; "
                f"the layout log covers generations "
                f"{sorted(by_from)} — restore with the checkpoint's "
                "own n_pad instead")
        if rec["old_n_pad"] != strengths.shape[-1]:
            raise LayoutMigrationError(
                f"restore: layout log record {gen}→"
                f"{rec['to_generation']} expects n_pad="
                f"{rec['old_n_pad']} but the arrays are "
                f"{strengths.shape[-1]} — corrupt migration journal")
        if rec["index_map"] is None:  # grow
            pad = rec["new_n_pad"] - rec["old_n_pad"]
            widths = [(0, 0)] * (strengths.ndim - 1) + [(0, pad)]
            strengths = np.pad(strengths, widths)
            node_mask = np.pad(node_mask, widths)
        else:  # compact
            keep = np.nonzero(_record_map(rec) >= 0)[0]
            tail = rec["new_n_pad"] - len(keep)
            widths = [(0, 0)] * (strengths.ndim - 1) + [(0, tail)]
            strengths = np.pad(strengths[..., keep], widths)
            node_mask = np.pad(node_mask[..., keep], widths)
        gen = int(rec["to_generation"])
        applied.append(rec)
    return strengths, node_mask, gen, applied


def _record_map(rec: dict) -> np.ndarray:
    return identity_index_map(rec["old_n_pad"]) \
        if rec["index_map"] is None \
        else np.asarray(rec["index_map"], np.int32)


def remaps_from_records(records: List[dict]) -> Dict[int, np.ndarray]:
    """The size-keyed ingestion remap table the applied records give:
    old n_pad → composed old→current map. Grows compose as identity
    injections; a later migration from a reused n_pad shadows the older
    one (a raw delta declares only its layout's size)."""
    table: Dict[int, np.ndarray] = {}
    for rec in records:
        imap = _record_map(rec)
        table = {k: compose_index_maps(m, imap) for k, m in table.items()}
        if rec["index_map"] is not None:
            table[rec["old_n_pad"]] = imap
    return table


def remaps_by_generation(records: List[dict]) -> Dict[int, np.ndarray]:
    """The generation-keyed remap table: past generation → its slot ids
    in the current layout. Nothing shadows, so a size-reusing chain
    (grow 128 → compact 96 → grow 128) keeps distinct exact maps for
    generations 0 and 2; grows contribute identity injections."""
    table: Dict[int, np.ndarray] = {}
    for rec in sorted(records, key=lambda r: r["from_generation"]):
        imap = _record_map(rec)
        table = {g: compose_index_maps(m, imap) for g, m in table.items()}
        table[int(rec["from_generation"])] = imap
    return table


def prune_generation_remaps(table: Dict[int, np.ndarray],
                            current_generation: int,
                            grace_generations: Optional[int]
                            ) -> Dict[int, np.ndarray]:
    """Keep the generations within the last ``grace_generations``
    migrations of ``current_generation`` (``None`` keeps all)."""
    if grace_generations is None:
        return dict(table)
    floor = int(current_generation) - int(grace_generations)
    return {g: m for g, m in table.items() if g >= floor}


@dataclasses.dataclass(frozen=True)
class CompactionReport:
    """What one `FingerService.compact` did."""

    old_n_pad: int
    new_n_pad: int
    n_live: int
    generation: int
    index_map: np.ndarray

    @property
    def reclaimed(self) -> int:
        return self.old_n_pad - self.new_n_pad
