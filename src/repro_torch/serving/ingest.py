"""Host→device delta ingestion for the port's FingerService.

The port's counterpart of `repro.serving.ingest`:

- ``SyncIngestor``: the baseline. Each stacked delta stays on the host
  until the tick that consumes it; `get` copies it to the device (the
  plan's `put_deltas`) and blocks until the copy lands, so the transfer
  sits on the tick's critical path.
- ``DoubleBufferedIngestor``: `put` starts the copy at once. On CUDA it
  copies each shard's rows of the host delta into one slot of that
  shard's ring of pinned host buffers (``max_queue + 1`` slots, one
  flat buffer a slot), starts one asynchronous copy of the slot to a
  fresh buffer on the shard's device, on a side `torch.cuda.Stream` of
  that device, and records an event. `get` makes each device's current
  stream wait on its shard's event (no host sync) and records the
  buffer's use by that stream with the caching allocator, so its block
  is not handed out again while the tick reads it. A slot is written
  again only after its previous copy has landed, and the caller's own
  tensors never feed an asynchronous copy, so the caller may overwrite
  them as soon as `ingest` returns. On the CPU both ingestors only
  queue host tensors.

A staging is three spans (`repro_torch.tracing`): ``finger.ingest.pin``
(the slot's pinned buffer and the copies into it),
``finger.ingest.enqueue`` (the device buffer on the side stream, the
copy's enqueue, the event) and, only when the slot's previous copy has
not landed, ``finger.ingest.slot_wait`` (the host blocked on it).
`counts` sums the stagers' counters (`COUNTERS`) over shards:
``slot_waits / staged`` rising means the producer outruns the copy
engine, and ``staged_bytes / staged`` is a shard's bytes copied a tick.

Both feed the plan through `ExecutionPlan.put_deltas`: the local plan
takes one block, a sharded plan one block a shard (a `Sharded` delta).

Both check every delta against the service layout up front with a
named `IngestError` — a dense delta against ``n_pad``, a slot-space
delta (``method="sparse_tick"``) against ``n_slots`` — and bound the
queue at ``config.max_queue``.

A migration builds a new ingestor for the new plan, which takes over
the old one's stagers (`make_ingestor(..., previous=)`): the side
streams, and with them the caching allocator's blocks of each stream,
the pinned slots and the counters. A fresh side stream would have no
cached blocks, so the first `put` after every migration would pay a
``cudaMalloc`` (and fresh pinned slots a ``cudaHostAlloc``): a
first-use cost that `warm_next_layouts` cannot pay ahead. The delta's
shapes do not depend on the layout, so the slots still fit.

Layout migrations: after a `FingerService.compact` (or any migration),
producers may still send deltas addressed in an older layout for a
grace period. The ingestor holds two old→new index-map tables and
renumbers such deltas on ``put`` (`serving.migrate.remap_delta`)
before validation; a delta that addresses a dropped slot raises:

- **generation-keyed** (exact): a delta stamped with its layout's
  generation (``GraphDelta.from_arrays(..., layout=...)``) goes through
  exactly the journaled migrations since that generation. A generation
  the retention policy (``grace_generations``) pruned raises
  `GraceLapseError`; an unknown one raises `IngestError`.
- **size-keyed** (best effort): a raw delta declares only its layout's
  size; the newest migration from that size wins, and grows reject
  old-size raw deltas.

The stamp is consumed here: queued deltas carry
``layout_generation=None``. ``take_all`` hands the queue back to a
migration, which re-lays it out and ``requeue``s it; ``pop`` hands the
oldest tick over as held (on the device under double buffering).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.distributed.sharding import each
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving.config import ServiceConfig

_ALIGN = 256  # bytes between the fields of a staging buffer
COUNTERS = ("staged", "staged_bytes", "slot_waits")


class IngestError(ValueError):
    """A stacked delta does not fit the service's layout (or the
    ingestion queue overflowed)."""


class GraceLapseError(IngestError):
    """A generation-stamped delta addresses a layout generation whose
    grace window has lapsed: ``ServiceConfig.grace_generations`` has
    pruned that generation's old→new remap. The producer must rebuild
    its deltas against the current layout (`FingerService.layout`)."""


def validate_stacked_delta(config: ServiceConfig,
                           deltas: GraphDelta) -> None:
    """Layout check before anything touches the device."""
    if deltas.dw.dim() != 2:
        raise IngestError(
            f"ingest expects a stacked (B, k_pad) delta, got dw shape "
            f"{tuple(deltas.dw.shape)}; stack per-stream deltas with "
            "engine.stack_deltas (or pass the list and let the service "
            "stack them)")
    b, k_pad = deltas.dw.shape
    if b != config.batch_size:
        raise IngestError(
            f"stacked delta batch {b} != config.batch_size="
            f"{config.batch_size}")
    if k_pad != config.k_pad:
        raise IngestError(
            f"stacked delta k_pad {k_pad} != config.k_pad="
            f"{config.k_pad}")
    if config.method == "sparse_tick":
        if deltas.edge_slots is None:
            raise IngestError(
                "sparse serving queues hold slot-space deltas, but "
                "this one carries no edge_slots (it is still addressed "
                "in the virtual space); pass the B per-stream virtual "
                "deltas to FingerService.ingest as a sequence — the "
                "service translates each through its stream's SlotMap "
                "(stateful, tick-ordered), which a pre-stacked delta "
                "bypasses")
        if deltas.n_nodes != config.n_slots:
            raise IngestError(
                f"slot-space delta n_slots {deltas.n_nodes} != "
                f"config.n_slots={config.n_slots}; after a "
                "grow_capacity(), queued deltas are re-embedded "
                "automatically — a mismatch here means the delta was "
                "translated against a stale capacity")
        if deltas.edge_slots.shape != deltas.dw.shape:
            raise IngestError(
                f"delta edge_slots shape "
                f"{tuple(deltas.edge_slots.shape)} != dw shape "
                f"{tuple(deltas.dw.shape)}")
    elif deltas.edge_slots is not None:
        raise IngestError(
            f"delta carries edge_slots (a sparse slot-space delta) but "
            f"config.method={config.method!r} serves the dense path; "
            "slot-space deltas only make sense under "
            "method='sparse_tick'")
    elif deltas.n_nodes != config.n_pad:
        raise IngestError(
            f"stacked delta n_pad {deltas.n_nodes} != config.n_pad="
            f"{config.n_pad}; after a repad, rebuild deltas with the "
            "new n_pad (deltas in a pre-compact() layout are remapped "
            "automatically while its index map is installed)")
    for name, t in deltas.tensors().items():
        if tuple(t.shape[:1]) != (b,):
            raise IngestError(f"delta field {name} has shape "
                              f"{tuple(t.shape)}, not ({b}, ·)")
    has_slots = deltas.node_ids is not None
    want_slots = config.j_pad is not None
    if has_slots != want_slots:
        raise IngestError(
            f"delta node-slot presence ({has_slots}) != config.j_pad="
            f"{config.j_pad!r}; node join/leave slots must be declared "
            "in the ServiceConfig")
    if want_slots and deltas.node_ids.shape[-1] != config.j_pad:
        raise IngestError(
            f"delta j_pad {deltas.node_ids.shape[-1]} != config.j_pad="
            f"{config.j_pad}")


class SyncIngestor:
    """Transfer-on-consume: `get` copies the delta to the device and
    blocks until the copy lands."""

    def __init__(self, config: ServiceConfig, plan,
                 remaps: Optional[Dict[int, np.ndarray]] = None,
                 remaps_by_gen: Optional[Dict[int, np.ndarray]] = None,
                 generation: int = 0):
        self.config = config
        self.plan = plan
        # old n_pad -> old→current index map (installed by compact()).
        self.remaps: Dict[int, np.ndarray] = dict(remaps or {})
        # old layout generation -> old→current index map.
        self.remaps_by_gen: Dict[int, np.ndarray] = \
            dict(remaps_by_gen or {})
        self.generation = int(generation)
        # (delta, copy event or None, device buffer or None), or a
        # Sharded of such triples, oldest first
        self._queue: deque = deque()

    def __len__(self) -> int:
        return len(self._queue)

    def _maybe_remap(self, deltas: GraphDelta) -> GraphDelta:
        """Renumber a delta still addressed in a pre-migration layout
        (steady-state deltas pass through); consume the generation
        stamp."""
        from repro_torch.serving.migrate import remap_delta

        gen = deltas.layout_generation
        if gen is not None:
            if gen == self.generation:
                if deltas.n_nodes != self.config.n_pad:
                    raise IngestError(
                        f"delta declares layout generation {gen} (the "
                        f"current one) but n_pad={deltas.n_nodes} != "
                        f"the layout's n_pad={self.config.n_pad} — a "
                        "mis-stamped delta")
                return dataclasses.replace(deltas,
                                           layout_generation=None)
            imap = self.remaps_by_gen.get(gen)
            if imap is None:
                if 0 <= gen < self.generation:
                    raise GraceLapseError(
                        f"delta is addressed in layout generation "
                        f"{gen} but the service is at generation "
                        f"{self.generation} and its grace window "
                        f"(grace_generations="
                        f"{self.config.grace_generations}) retains "
                        f"only {sorted(self.remaps_by_gen)} — rebuild "
                        "deltas against the current layout")
                raise IngestError(
                    f"delta declares layout generation {gen} but the "
                    f"service is at generation {self.generation} "
                    f"(known past generations: "
                    f"{sorted(self.remaps_by_gen)}) — a mis-stamped "
                    "delta")
            if deltas.n_nodes != imap.shape[0]:
                raise IngestError(
                    f"delta declares layout generation {gen} but "
                    f"n_pad={deltas.n_nodes} != that generation's "
                    f"n_pad={imap.shape[0]} — a mis-stamped delta")
            return remap_delta(deltas, imap, self.config.n_pad)
        if deltas.n_nodes == self.config.n_pad \
                or deltas.n_nodes not in self.remaps:
            return deltas
        return remap_delta(deltas, self.remaps[deltas.n_nodes],
                           self.config.n_pad)

    def _prepare(self, deltas: GraphDelta):
        """What `put` queues: the delta as given (transfer deferred)."""
        return deltas, None, None

    def put(self, deltas: GraphDelta) -> None:
        deltas = self._maybe_remap(deltas)
        validate_stacked_delta(self.config, deltas)
        if len(self._queue) >= self.config.max_queue:
            raise IngestError(
                f"ingestion queue full ({self.config.max_queue} "
                f"pending tick(s)); poll() before ingesting more")
        self._queue.append(self._prepare(deltas))

    def requeue(self, deltas) -> None:
        """Queue a tick handed out by `take_all` again, as it is (a
        migration has re-laid it out; it was checked at its `put`)."""
        self._queue.append(each(lambda d: (d, None, None), deltas))

    @staticmethod
    def _ready_one(entry: Tuple) -> GraphDelta:
        deltas, event, buf = entry
        if event is not None:
            stream = torch.cuda.current_stream(buf.device)
            stream.wait_event(event)
            buf.record_stream(stream)
        return deltas

    def _ready(self, entry):
        """A queued entry's delta, usable on the current streams: each
        shard's device stream waits on its block's copy, and the
        allocator learns that the stream reads the block's buffer."""
        return each(self._ready_one, entry)

    def take_all(self) -> List:
        """Pop every pending tick, oldest first (a migration re-lays
        them out and requeues them)."""
        out = [self._ready(e) for e in self._queue]
        self._queue.clear()
        return out

    def pop(self):
        """Pop the oldest pending tick as held — on the host for the
        sync ingestor, on the device for the double-buffered one — with
        no copy and no host sync (the pool-tick path's consumer moves
        it itself)."""
        if not self._queue:
            return None
        return self._ready(self._queue.popleft())

    def get(self):
        deltas = self.pop()
        if deltas is None:
            return None
        deltas = self.plan.put_deltas(deltas)
        self.plan.synchronize()
        return deltas

    def drain(self) -> None:
        self._queue.clear()

    def counts(self) -> Dict[str, int]:
        """The staging counters of `COUNTERS`, summed over shards: zero,
        as nothing is staged ahead here."""
        return dict.fromkeys(COUNTERS, 0)


class _Stager:
    """One shard's staging for the double-buffered ingestor: a ring of
    pinned host slots and the side stream of the shard's device, and
    its counters: ``staged`` deltas, ``staged_bytes`` copied (each
    field of a slot 256-B aligned) and ``slot_waits``, the stagings
    that found their slot's previous copy still in flight and blocked
    on it."""

    def __init__(self, device: torch.device, n_slots: int,
                 side: torch.cuda.Stream):
        self.device = device
        self.side = side
        # (field layout, pinned flat buffer) and the event of the copy
        # that last read each slot
        self._slots: List[Optional[Tuple]] = [None] * n_slots
        self._events: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self._next = 0
        self.staged = 0
        self.staged_bytes = 0
        self.slot_waits = 0

    @staticmethod
    def _fields(deltas: GraphDelta) -> Tuple:
        """((name, shape, dtype, byte offset), ...) and the total bytes
        of one flat staging buffer holding the delta's fields."""
        fields, off = [], 0
        for name, t in deltas.tensors().items():
            fields.append((name, tuple(t.shape), t.dtype, off))
            off += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
        return tuple(fields), off

    @staticmethod
    def _views(buf: torch.Tensor, fields: Tuple) -> Dict[str, torch.Tensor]:
        out = {}
        for name, shape, dtype, off in fields:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            out[name] = buf[off:off + n].view(dtype).view(shape)
        return out

    def stage(self, deltas: GraphDelta) -> Tuple:
        """(the delta on the device, the copy's event, its buffer)."""
        fields, nbytes = self._fields(deltas)
        i = self._next
        self._next = (i + 1) % len(self._slots)
        last = self._events[i]
        if last is not None and not last.query():
            self.slot_waits += 1
            with tracing.span("finger.ingest.slot_wait"):
                last.synchronize()  # the slot's last copy lands
        with tracing.span("finger.ingest.pin"):
            if self._slots[i] is None or self._slots[i][0] != fields:
                self._slots[i] = (fields, torch.empty(
                    nbytes, dtype=torch.uint8, pin_memory=True))
            pinned = self._slots[i][1]
            src = deltas.tensors()
            for name, view in self._views(pinned, fields).items():
                view.copy_(src[name])
        with tracing.span("finger.ingest.enqueue"), \
                torch.cuda.stream(self.side):
            buf = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            buf.copy_(pinned, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.side)
        self._events[i] = event
        self.staged += 1
        self.staged_bytes += nbytes
        views = self._views(buf, fields)
        return dataclasses.replace(deltas, **views), event, buf


class DoubleBufferedIngestor(SyncIngestor):
    """Transfer-on-ingest: `put` starts each shard's device copy on a
    side stream at once, so it overlaps the tick in flight; `get` orders
    the current streams after them and hands the delta to the tick."""

    def __init__(self, config: ServiceConfig, plan,
                 remaps: Optional[Dict[int, np.ndarray]] = None,
                 remaps_by_gen: Optional[Dict[int, np.ndarray]] = None,
                 generation: int = 0,
                 previous: Optional["DoubleBufferedIngestor"] = None):
        super().__init__(config, plan, remaps, remaps_by_gen, generation)
        cuda = [d for d in plan.shard_devices if d.type == "cuda"]
        if previous is not None and \
                [st.device for st in previous._stagers] == cuda:
            self._stagers = previous._stagers  # the migrated service's
            return
        sides: Dict[torch.device, torch.cuda.Stream] = {}
        self._stagers: List[_Stager] = []
        for dev in plan.shard_devices:
            if dev.type == "cuda":
                if dev not in sides:
                    sides[dev] = torch.cuda.Stream(dev)
                self._stagers.append(_Stager(dev, config.max_queue + 1,
                                             sides[dev]))

    def _prepare(self, deltas: GraphDelta):
        if not self._stagers:
            return deltas, None, None  # the CPU path
        if deltas.dw.device.type == "cuda":  # already on a card
            return each(lambda d: (d, None, None),
                        self.plan.put_deltas(deltas))
        return self.plan.put_deltas(
            deltas, stage=lambda i, dev, part: self._stagers[i].stage(part))

    def get(self):
        return self.pop()

    def counts(self) -> Dict[str, int]:
        return {c: sum(getattr(st, c) for st in self._stagers)
                for c in COUNTERS}


def make_ingestor(config: ServiceConfig, plan,
                  remaps: Optional[Dict[int, np.ndarray]] = None,
                  remaps_by_gen: Optional[Dict[int, np.ndarray]] = None,
                  generation: int = 0,
                  previous: Optional[SyncIngestor] = None) -> SyncIngestor:
    """The ingestor of ``config.ingestion`` feeding ``plan``; a
    double-buffered one takes over the stagers of ``previous`` (the
    ingestor a migration replaces) when they serve the same devices."""
    if config.ingestion != "double_buffered":
        return SyncIngestor(config, plan, remaps, remaps_by_gen, generation)
    return DoubleBufferedIngestor(
        config, plan, remaps, remaps_by_gen, generation,
        previous=previous if isinstance(previous, DoubleBufferedIngestor)
        else None)
