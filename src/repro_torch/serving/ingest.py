"""Host→device delta ingestion for the port's FingerService.

The port's counterpart of the synchronous half of `repro.serving.ingest`:
`SyncIngestor` keeps each stacked delta on the host until the tick that
consumes it, then copies it to the device and blocks until the copy
lands, so the transfer sits on the tick's critical path. Every delta is
checked against the service layout up front with a named
`IngestError` — a dense delta against ``n_pad``, a slot-space delta
(``method="sparse_tick"``) against ``n_slots`` — and the queue is
bounded by ``config.max_queue``.

Not yet ported: the double-buffered ingestor and the old→new remap
tables that follow layout migrations.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import torch

from repro_torch.graphs.types import GraphDelta
from repro_torch.serving.config import ServiceConfig


class IngestError(ValueError):
    """A stacked delta does not fit the service's layout (or the
    ingestion queue overflowed)."""


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
            f"{config.n_pad}")
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

    def __init__(self, config: ServiceConfig, device: torch.device,
                 generation: int = 0):
        self.config = config
        self.device = device
        self.generation = int(generation)
        self._queue: deque = deque()

    def __len__(self) -> int:
        return len(self._queue)

    def put(self, deltas: GraphDelta) -> None:
        gen = deltas.layout_generation
        if gen is not None:
            if gen != self.generation:
                raise IngestError(
                    f"delta declares layout generation {gen} but the "
                    f"service is at generation {self.generation}; "
                    "remapping deltas across layout migrations is not "
                    "yet ported")
            deltas = dataclasses.replace(deltas, layout_generation=None)
        validate_stacked_delta(self.config, deltas)
        if len(self._queue) >= self.config.max_queue:
            raise IngestError(
                f"ingestion queue full ({self.config.max_queue} "
                f"pending tick(s)); poll() before ingesting more")
        self._queue.append(deltas)

    def take_all(self) -> list:
        """Pop every pending tick, oldest first (a migration re-lays
        them out and puts them back)."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def get(self) -> Optional[GraphDelta]:
        if not self._queue:
            return None
        deltas = self._queue.popleft().map_tensors(
            lambda t: t.to(self.device).contiguous())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return deltas

    def drain(self) -> None:
        self._queue.clear()
