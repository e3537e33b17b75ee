"""FingerService: the declarative serving facade over FINGER streams.

The port's counterpart of `repro.serving.service`, for the local
placement with synchronous ingestion:

    config = ServiceConfig(batch_size=256, n_pad=128, k_pad=32,
                           method="fused_tick", ingestion="sync")
    with FingerService.open(config, graphs) as svc:   # on CUDA
        for tick_deltas in feed:
            svc.ingest(tick_deltas)
            svc.poll()
        worst = svc.top_anomalies(8)

Lifecycle: `open` → `ingest`/`poll` in any interleaving the queue depth
allows → `scores`/`top_anomalies`/`score_at` → `close` (also via the
context manager). The service runs on CUDA unless opened with
``device="cpu"``.

Under ``method="sparse_tick"`` the streams live in slot space: `open`
gives each graph slots in one `SparseLayout` (``n_slots``, ``m_pad``)
and keeps a per-stream `SlotMap`; `ingest` takes the B per-stream
*virtual* deltas and translates them through the maps (atomic over the
batch); `grow_capacity` grows the slot capacities on the device, and
`repad` raises the virtual bound ``n_pad``, which only the host maps
read.

Not yet ported: save/restore, the dense layout migrations (`repad` of
a dense layout, `compact`, grace remaps), warm plan caches and the
fleet hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.sparse import SlotMap, SparseLayout, SparseStreamState
from repro_torch.core.state import FingerState
from repro_torch.engine.stream import StreamEngine, stack_deltas
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.serving import migrate
from repro_torch.serving.config import (ServiceConfig, ServiceConfigError,
                                        _not_yet_ported)
from repro_torch.serving.ingest import IngestError, SyncIngestor
from repro_torch.serving.plans import ExecutionPlan, build_plan

State = Union[FingerState, SparseStreamState]


class ServiceLifecycleError(RuntimeError):
    """An operation was called in a state that cannot honor it (closed
    service, no tick yet, …)."""


@dataclasses.dataclass(frozen=True)
class TickReport:
    """One completed `poll`: the tick index and its (B,) scores, still
    on the device."""

    step: int
    scores: torch.Tensor


class FingerService:
    """Lifecycle facade for one FINGER serving deployment; build it with
    `open`."""

    def __init__(self, config: ServiceConfig, plan: ExecutionPlan,
                 states: State, step: int = 0,
                 slot_maps: Optional[List[SlotMap]] = None):
        self._config = config
        self._plan = plan
        self._states = states
        self._step = step
        if config.method == "sparse_tick":
            # Slot-space serving: the device capacity is the state's
            # SparseLayout; config.n_pad is the virtual addressing bound
            # the per-stream SlotMaps enforce on the host.
            self._capacity = states.layout
            if (self._capacity.n_slots, self._capacity.m_pad) != \
                    (config.n_slots, config.m_pad):
                raise ServiceConfigError(
                    f"FingerService: state capacities (n_slots="
                    f"{self._capacity.n_slots}, m_pad="
                    f"{self._capacity.m_pad}) != config "
                    f"(n_slots={config.n_slots}, m_pad={config.m_pad})")
            if slot_maps is None or len(slot_maps) != config.batch_size:
                raise ServiceConfigError(
                    f"FingerService: sparse serving needs one SlotMap "
                    f"per stream "
                    f"({0 if slot_maps is None else len(slot_maps)} "
                    f"for batch_size={config.batch_size})")
            self._slot_maps = list(slot_maps)
            self._layout = NodeLayout(config.n_pad)
        else:
            if slot_maps is not None:
                raise ServiceConfigError(
                    "FingerService: slot_maps are sparse-only state "
                    f"(method={config.method!r})")
            self._capacity = None
            self._slot_maps = None
            self._layout = states.layout if states.layout is not None \
                else NodeLayout(config.n_pad)
            if self._layout.n_pad != config.n_pad:
                raise ServiceConfigError(
                    f"FingerService: state layout n_pad="
                    f"{self._layout.n_pad} != config.n_pad={config.n_pad}")
        self._ingestor = self._make_ingestor()
        self._last_scores: Optional[torch.Tensor] = None
        self._closed = False

    def _make_ingestor(self) -> SyncIngestor:
        return SyncIngestor(self._config, self._plan.device,
                            generation=self._layout.generation)

    @classmethod
    def open(cls, config: ServiceConfig, graphs: Sequence,
             device: Device = None) -> "FingerService":
        """Validate the config, build its plan, and place the initial
        stacked state from B host graphs (`DenseGraph` or `EdgeList`)
        on ``device`` (``None`` is CUDA).

        Under ``method="sparse_tick"``, ``graphs`` may be any iterable
        and is consumed one graph at a time (a virtual-space graph's
        node mask alone is n_pad floats); its count is checked once it
        is used up."""
        config.validate()
        device = resolve_device(device)
        if config.method != "sparse_tick":
            graphs = list(graphs)
            cls._check_graphs(config, len(graphs),
                              [g.n_nodes for g in graphs])
        plan = build_plan(config, device)
        if config.method == "sparse_tick":
            count = [0]

            def checked() -> Iterator:
                for g in graphs:
                    count[0] += 1
                    cls._check_graphs(config, None, [g.n_nodes])
                    yield g

            capacity = SparseLayout(n_slots=config.n_slots,
                                    m_pad=config.m_pad)
            states, slot_maps = StreamEngine.init_sparse_states(
                checked(), capacity, n_virtual=config.n_pad, device=device)
            cls._check_graphs(config, count[0], [])
            return cls(config, plan, states, slot_maps=slot_maps)
        states = StreamEngine.init_states(graphs, n_pad=config.n_pad,
                                          device=device)
        return cls(config, plan, states)

    @staticmethod
    def _check_graphs(config: ServiceConfig, count: Optional[int],
                      n_nodes: Sequence[int]) -> None:
        if count is not None and count != config.batch_size:
            raise ServiceConfigError(
                f"open: {count} graph(s) != config.batch_size="
                f"{config.batch_size}")
        too_big = [n for n in n_nodes if n > config.n_pad]
        if too_big:
            raise ServiceConfigError(
                f"open: graph node count(s) {sorted(set(too_big))} "
                f"exceed config.n_pad={config.n_pad}; open with a "
                "larger n_pad")

    # -- introspection ---------------------------------------------------
    @property
    def config(self) -> ServiceConfig:
        return self._config

    @property
    def plan(self) -> ExecutionPlan:
        return self._plan

    @property
    def device(self) -> torch.device:
        return self._plan.device

    @property
    def step(self) -> int:
        """Number of completed ticks."""
        return self._step

    @property
    def layout(self) -> NodeLayout:
        """The live `NodeLayout`. Under ``method="sparse_tick"`` its
        n_pad is the virtual addressing bound; `capacity` holds the
        device sizes."""
        return self._layout

    @property
    def capacity(self) -> Optional[SparseLayout]:
        """The live `SparseLayout` (n_slots, m_pad, generation) under
        ``method="sparse_tick"``; None otherwise."""
        return self._capacity

    @property
    def slot_maps(self) -> Optional[List[SlotMap]]:
        """The per-stream virtual→slot `SlotMap`s (sparse only;
        read-only use: ingestion owns their changes)."""
        return self._slot_maps

    @property
    def pending(self) -> int:
        """Ingested ticks not yet consumed by `poll`."""
        return len(self._ingestor)

    def states(self) -> State:
        """The live stacked state (device-resident; read-only use)."""
        return self._states

    # -- serving loop ----------------------------------------------------
    def _check_open(self, what: str) -> None:
        if self._closed:
            raise ServiceLifecycleError(f"{what} on a closed "
                                        "FingerService")

    def ingest(self, deltas: Union[GraphDelta,
                                   Sequence[GraphDelta]]) -> None:
        """Queue one tick's deltas: a stacked (B, k_pad) GraphDelta, or
        a list of B per-stream deltas to stack. Under
        ``method="sparse_tick"``, the list of B per-stream virtual
        deltas only."""
        self._check_open("ingest")
        if self._config.method == "sparse_tick":
            self._ingest_sparse(deltas)
            return
        if not isinstance(deltas, GraphDelta):
            deltas = stack_deltas(list(deltas))
        self._ingestor.put(deltas)

    def _ingest_sparse(self, deltas) -> None:
        """Translate one tick's B per-stream virtual deltas through the
        per-stream `SlotMap`s, queue the stacked slot-space delta, and
        only then commit the maps.

        Atomic over the batch: every stream is staged (no change), the
        staged deltas are stacked and checked against the service by the
        queue, and only a queued tick commits. So a rejection — out of
        capacity (`SparseCapacityError`), out-of-virtual-space ids, a
        duplicate edge lane, a k_pad or j_pad other than the config's,
        node slots in some streams and not in others, a full queue —
        leaves every SlotMap as it was. The queue-depth check also runs
        first, before the translation's host work.
        """
        if isinstance(deltas, GraphDelta):
            raise IngestError(
                "sparse ingestion is per-stream: pass the B per-stream "
                "virtual deltas as a sequence — the service translates "
                "each through its stream's SlotMap (stateful, "
                "tick-ordered) before stacking; a pre-stacked "
                "GraphDelta bypasses that translation")
        deltas = list(deltas)
        if len(deltas) != self._config.batch_size:
            raise IngestError(
                f"sparse ingest got {len(deltas)} per-stream delta(s) "
                f"!= config.batch_size={self._config.batch_size}")
        if self.pending >= self._config.max_queue:
            raise IngestError(
                f"ingestion queue full ({self._config.max_queue} "
                f"pending tick(s)); poll() before ingesting more")
        staged = [sm.stage(d) for sm, d in zip(self._slot_maps, deltas)]
        self._ingestor.put(stack_deltas([st.delta for st in staged]))
        for sm, st in zip(self._slot_maps, staged):
            sm.commit(st)

    def poll(self) -> Optional[TickReport]:
        """Advance one tick if a delta is queued; None otherwise. The
        tick is launched asynchronously; `scores()` waits for it."""
        self._check_open("poll")
        deltas = self._ingestor.get()
        if deltas is None:
            return None
        dists, self._states = self._plan.tick(self._states, deltas)
        self._last_scores = dists
        self._step += 1
        return TickReport(step=self._step, scores=dists)

    def scores(self) -> Optional[np.ndarray]:
        """Latest tick's (B,) JSdist scores on the host; None before
        the first tick."""
        self._check_open("scores")
        if self._last_scores is None:
            return None
        return self._last_scores.cpu().numpy()

    def top_anomalies(self, k: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The k highest-scoring streams of the latest tick:
        ``(values, stream_ids)``, each (k,), descending (lower stream id
        first on ties)."""
        self._check_open("top_anomalies")
        if self._last_scores is None:
            raise ServiceLifecycleError(
                "top_anomalies before the first completed tick")
        k = self._config.topk.k if k is None else k
        vals, ids = self._plan.topk(self._last_scores, k)
        return vals.cpu().numpy(), ids.cpu().numpy()

    def score_at(self, slot: int) -> Optional[float]:
        """The latest tick's score of one stream slot; None before the
        first tick."""
        self._check_open("score_at")
        if not 0 <= int(slot) < self._config.batch_size:
            raise ServiceConfigError(
                f"score_at: slot {slot} outside this service's "
                f"batch_size={self._config.batch_size}")
        if self._last_scores is None:
            return None
        return float(self._last_scores[int(slot)])

    # -- migrations ------------------------------------------------------
    def repad(self, new_n_pad: int) -> None:
        """Raise the sparse virtual bound to ``new_n_pad``.

        Under ``method="sparse_tick"`` n_pad is a host-side addressing
        bound only — no device tensor, no queued slot-space delta
        depends on it — so the migration touches the host maps alone.
        The dense repad (a device-side embed of the layout) is not yet
        ported.
        """
        self._check_open("repad")
        old = self._layout.n_pad
        if new_n_pad == old:
            raise ServiceConfigError(f"repad: already at n_pad={old}")
        if self._config.method != "sparse_tick":
            raise _not_yet_ported(
                f"repad of the dense layout (method="
                f"{self._config.method!r})")
        if new_n_pad < old:
            raise migrate.LayoutMigrationError(
                f"repad: the sparse virtual space only grows "
                f"(new_n_pad={new_n_pad} < {old}); nothing is "
                "sized by n_pad, so shrinking it reclaims nothing")
        self._config = dataclasses.replace(self._config, n_pad=new_n_pad)
        self._plan.config = dataclasses.replace(self._plan.config,
                                                n_pad=new_n_pad)
        self._ingestor.config = self._config
        for sm in self._slot_maps:
            sm.grow_virtual(new_n_pad)
        self._layout = NodeLayout(new_n_pad,
                                  generation=self._layout.generation)

    def grow_capacity(self, n_slots: Optional[int] = None,
                      m_pad: Optional[int] = None) -> SparseLayout:
        """Grow the sparse device capacities (either axis) in place —
        the ``method="sparse_tick"`` counterpart of a growing repad.

        The stacked (B, n_slots) strengths and mask and the (B, m_pad)
        edge store are padded on the device
        (`migrate.grow_sparse_stacked`); slot ids are kept (growth
        appends free slots to every `SlotMap`), so queued ticks are
        re-embedded by a size change only. Returns the new layout.
        """
        self._check_open("grow_capacity")
        if self._config.method != "sparse_tick":
            raise ServiceConfigError(
                f"grow_capacity: a sparse-only migration "
                f"(method={self._config.method!r}); repad() migrates "
                "the dense layout")
        new_capacity = self._capacity.grown(n_slots=n_slots, m_pad=m_pad)
        pending = [migrate.embed_sparse_delta(d, new_capacity.n_slots)
                   for d in self._ingestor.take_all()]
        self._states = migrate.grow_sparse_stacked(self._states,
                                                   new_capacity)
        self._config = dataclasses.replace(
            self._config, n_slots=new_capacity.n_slots,
            m_pad=new_capacity.m_pad)
        self._plan = build_plan(self._config, self.device)
        self._capacity = new_capacity
        for sm in self._slot_maps:
            sm.grow(new_capacity)
        self._ingestor = self._make_ingestor()
        for d in pending:
            self._ingestor.put(d)
        return new_capacity

    def close(self) -> None:
        """Wait for in-flight work and drop the queue. Idempotent; every
        other method raises `ServiceLifecycleError` afterwards."""
        if self._closed:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._ingestor.drain()
        self._closed = True

    def __enter__(self) -> "FingerService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
