"""FingerService: the declarative serving facade over FINGER streams.

The port's counterpart of `repro.serving.service`:

    config = ServiceConfig(batch_size=256, n_pad=128, k_pad=32,
                           method="fused_tick",
                           checkpoint=CheckpointPolicy("ckpts"))
    with FingerService.open(config, graphs) as svc:   # on CUDA
        for tick_deltas in feed:
            svc.ingest(tick_deltas)      # the copy overlaps the tick
            svc.poll()                   # one tick, launched async
        worst = svc.top_anomalies(8)
        svc.save()

Lifecycle: `open` (or `restore`) → `ingest`/`poll` in any interleaving
the queue depth allows → `scores`/`top_anomalies`/`score_at` → `save` →
`close` (also via the context manager). The service runs on CUDA unless
opened with ``device="cpu"``. Two live layout migrations:

- `repad(new_n_pad)` grows the shared `NodeLayout` on the device, or
  truncates an inactive tail; a shrink that would cut an active slot
  raises `LayoutMigrationError`.
- `compact()` drops the slots inactive in every stream and renumbers
  the survivors; the old→new index map stays installed, so ingestion
  keeps accepting deltas addressed in the older layout for a grace
  period (``ServiceConfig.grace_generations``).

Both re-lay-out the ticks still queued (atomically: a queued tick that
cannot be migrated aborts the migration with the service unchanged),
bump the layout generation, and journal themselves in the checkpoint
directory so that `restore` walks an older-generation checkpoint
forward. They install a plan from the warm `PlanCache` when
`warm_next_layouts` predicted the layout.

Under ``method="sparse_tick"`` the streams live in slot space: `open`
gives each graph slots in one `SparseLayout` (``n_slots``, ``m_pad``)
and keeps a per-stream `SlotMap`; `ingest` takes the B per-stream
*virtual* deltas and translates them through the maps (atomic over the
batch); `grow_capacity` grows the slot capacities on the device, and
`repad` raises the virtual bound ``n_pad``, which only the host maps
read. `save` writes the maps' JSON beside the state.

The sharded placements (``placement="sharded"`` / ``"multipod"``, with
``grid=`` a `distributed.sharding.DeviceGrid`) keep this API: one
service ingests the (B,) deltas of every stream, answers one global
top-k (and per-pod top-k under multipod) and writes one checkpoint in
the same on-disk format. Its state is a `Sharded` of per-shard stacked
states, each on its shard's device and owning its tensors; the
migrations and the stream hooks work shard by shard, and `save`
gathers the shards to the host.

The fleet's hooks: `begin_pool_tick` / `finish_pool_tick` let a
pool-stacked launch tick this service's queue, and `extract_stream` /
`install_stream` / `clear_stream` move one stream between services.

While a `torch.profiler` records, the serving loop's calls are spans
on its clock (`repro_torch.tracing`): ``finger.ingest``,
``finger.poll``, ``finger.scores`` and ``finger.top_anomalies``, each
the whole call, and ``finger.scores.wait``, the host blocked until the
last tick's work has ended on the card (`poll` then records an event
a card that `scores` waits on before its copy; with no profiler there
is no event and the copy waits as it would). `ingest_counts` gives the
staging counters, which need no profiler.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.sparse import SlotMap, SparseLayout, SparseStreamState
from repro_torch.core.state import FingerState
from repro_torch.distributed.sharding import DeviceGrid, Sharded, each
from repro_torch.engine.stream import (CKPT_KIND, StreamEngine,
                                       restore_stacked_state, stack_deltas,
                                       state_tree)
from repro_torch.graphs.layout import (NodeLayout, compose_index_maps,
                                       identity_index_map)
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.serving import migrate
from repro_torch.serving.config import ServiceConfig, ServiceConfigError
from repro_torch.serving.ingest import IngestError, make_ingestor
from repro_torch.serving.migrate import CompactionReport, LayoutMigrationError
from repro_torch.serving.plans import (ExecutionPlan, MultiPodPlan,
                                       PlanCache, build_plan)
from repro_torch.train.checkpoint import save_checkpoint

State = Union[FingerState, SparseStreamState]
Placed = Union[State, Sharded]  # one stacked state, or one a shard


def _first(states: Placed) -> State:
    return states.parts[0] if isinstance(states, Sharded) else states


class ServiceLifecycleError(RuntimeError):
    """An operation was called in a state that cannot honor it (closed
    service, no tick yet, a queue that must be empty, …)."""


class WarmupHandle:
    """A `warm_next_layouts(background=True)` warm in flight.

    The warm runs on a thread of its own, on a CUDA stream of its own
    and its own zero-filled state. ``wait()`` joins it and returns the
    warmed targets (re-raising what the thread raised); ``done()``
    polls. The serving thread may keep ticking meanwhile, but must
    ``wait()`` before any migration.
    """

    def __init__(self, fn: Callable[[], list]):
        self._result: Optional[list] = None
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(fn,), daemon=True,
            name="finger-warmup")
        self._thread.start()

    def _run(self, fn) -> None:
        try:
            self._result = fn()
        except BaseException as e:  # re-raised at wait()
            self._exc = e

    def done(self) -> bool:
        return not self._thread.is_alive()

    def wait(self, timeout: Optional[float] = None) -> list:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise ServiceLifecycleError(
                f"WarmupHandle.wait: background warming still running "
                f"after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result or []


@dataclasses.dataclass(frozen=True)
class TickReport:
    """One completed `poll`: the tick index and its (B,) scores, still
    on the device (a `Sharded` of per-shard scores under the sharded
    placements)."""

    step: int
    scores: Union[torch.Tensor, Sharded]


class FingerService:
    """Lifecycle facade for one FINGER serving deployment; build it with
    `open`."""

    def __init__(self, config: ServiceConfig, plan: ExecutionPlan,
                 states: Placed, step: int = 0,
                 remaps: Optional[Dict[int, np.ndarray]] = None,
                 remaps_gen: Optional[Dict[int, np.ndarray]] = None,
                 slot_maps: Optional[List[SlotMap]] = None):
        self._config = config
        self._plan = plan
        self._states = states
        self._step = step
        if config.method == "sparse_tick":
            # Slot-space serving: the device capacity is the state's
            # SparseLayout; config.n_pad is the virtual addressing bound
            # the per-stream SlotMaps enforce on the host.
            self._capacity = _first(states).layout
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
            layout = _first(states).layout
            self._layout = layout if layout is not None \
                else NodeLayout(config.n_pad)
            if self._layout.n_pad != config.n_pad:
                raise ServiceConfigError(
                    f"FingerService: state layout n_pad="
                    f"{self._layout.n_pad} != config.n_pad={config.n_pad}")
        # old n_pad -> composed old→current index map (size-keyed, best
        # effort) and old generation -> old→current map (exact)
        self._remaps: Dict[int, np.ndarray] = dict(remaps or {})
        self._remaps_gen: Dict[int, np.ndarray] = dict(remaps_gen or {})
        self._plan_cache = PlanCache()
        self._ingestor = self._make_ingestor(None)
        self._last_scores: Optional[torch.Tensor] = None
        # the last tick's end on each card, recorded only while a
        # profiler records, for `scores`' wait span
        self._tick_done: Optional[List[torch.cuda.Event]] = None
        self._closed = False

    def _make_ingestor(self, previous):
        """The ingestor of the current config and plan; after a migration
        it takes over ``previous``'s side streams and pinned slots."""
        return make_ingestor(self._config, self._plan, self._remaps,
                             self._remaps_gen,
                             generation=self._layout.generation,
                             previous=previous)

    @staticmethod
    def _build_plan(config: ServiceConfig, device: Device,
                    grid: Optional[DeviceGrid]) -> ExecutionPlan:
        if grid is not None:
            if device is not None:
                raise ServiceConfigError(
                    "pass grid= (the sharded placements) or device=, "
                    "not both: the grid names every shard's device")
            return build_plan(config, grid)
        return build_plan(config, resolve_device(device))

    @classmethod
    def open(cls, config: ServiceConfig, graphs: Sequence,
             device: Device = None,
             grid: Optional[DeviceGrid] = None) -> "FingerService":
        """Validate the config, build its plan, and place the initial
        stacked state from B host graphs (`DenseGraph` or `EdgeList`)
        on ``device`` (``None`` is CUDA), or split over ``grid`` under
        the sharded placements (a sharded placement given only a device
        gets `plans.default_grid`).

        Under ``method="sparse_tick"``, ``graphs`` may be any iterable
        and is consumed one graph at a time (a virtual-space graph's
        node mask alone is n_pad floats); its count is checked once it
        is used up."""
        config.validate()
        if config.method != "sparse_tick":
            graphs = list(graphs)
            cls._check_graphs(config, len(graphs),
                              [g.n_nodes for g in graphs])
        plan = cls._build_plan(config, device, grid)
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
                checked(), capacity, n_virtual=config.n_pad, device="cpu")
            cls._check_graphs(config, count[0], [])
            return cls(config, plan, plan.place(states),
                       slot_maps=slot_maps)
        states = StreamEngine.init_states(graphs, n_pad=config.n_pad,
                                          device="cpu")
        return cls(config, plan, plan.place(states))

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
                "larger n_pad (or repad() a running service)")

    @classmethod
    def restore(cls, config: ServiceConfig, directory: Optional[str] = None,
                device: Device = None,
                grid: Optional[DeviceGrid] = None) -> "FingerService":
        """Resume from the latest checkpoint under ``directory`` (default:
        the config's checkpoint directory) on ``device`` (``None`` is
        CUDA) or over ``grid``, as `open` places. Either package's
        checkpoints restore here, whatever placement saved them.

        A checkpoint taken under an older `NodeLayout` is walked forward
        through the migrations journaled in the directory's layout log
        (pad for grows, index-map gather for compactions) until it
        reaches ``config.n_pad``, and the ingestion grace tables are
        rebuilt from the journal."""
        config.validate()
        ckpt_dir = directory or config.checkpoint.directory
        if ckpt_dir is None:
            raise ServiceConfigError(
                "restore: no checkpoint directory — pass one or set "
                "ServiceConfig.checkpoint.directory")
        plan = cls._build_plan(config, device, grid)
        states, step, meta = restore_stacked_state(
            ckpt_dir, exact_smax=config.exact_smax, method=config.method)
        if config.method == "sparse_tick":
            return cls._restore_sparse(config, plan, states, step, meta)
        b = int(states.q.shape[0])
        n_pad = int(states.strengths.shape[-1])
        if b != config.batch_size:
            raise ServiceConfigError(
                f"restore: checkpoint holds {b} stream(s) but "
                f"config.batch_size={config.batch_size}")
        log = migrate.load_layout_log(ckpt_dir)
        gen = int(meta.get("layout_generation", 0))
        if n_pad != config.n_pad:
            if not log:
                raise ServiceConfigError(
                    f"restore: checkpoint n_pad={n_pad} but config."
                    f"n_pad={config.n_pad} and the directory has no "
                    "layout log; restore with the saved layout, then "
                    "repad()/compact() to migrate it")
            strengths, node_mask, gen, _ = migrate.migrate_host_arrays(
                states.strengths.numpy(),
                None if states.node_mask is None
                else states.node_mask.numpy(),
                log, gen, config.n_pad)
            states = FingerState(
                q=states.q, s_total=states.s_total, s_max=states.s_max,
                strengths=torch.from_numpy(strengths),
                node_mask=torch.from_numpy(node_mask),
                layout=NodeLayout(config.n_pad, generation=gen))
        # the grace tables the live service had at this generation,
        # under the same retention policy
        recs = sorted((r for r in log if r["to_generation"] <= gen),
                      key=lambda r: r["from_generation"])
        remaps = migrate.remaps_from_records(recs)
        remaps_gen = migrate.prune_generation_remaps(
            migrate.remaps_by_generation(recs), gen,
            config.grace_generations)
        return cls(config, plan, plan.place(states), step=step,
                   remaps=remaps, remaps_gen=remaps_gen)

    @classmethod
    def _restore_sparse(cls, config: ServiceConfig, plan, states, step,
                        meta) -> "FingerService":
        """Sparse tail of `restore`: the per-stream `SlotMap`s come back
        from their JSON in the manifest, and the slot capacities are
        checked against the config (they only grow in place, so the
        saved state is the current layout's: no journal walk)."""
        b = int(states.q.shape[0])
        if b != config.batch_size:
            raise ServiceConfigError(
                f"restore: checkpoint holds {b} stream(s) but "
                f"config.batch_size={config.batch_size}")
        cap = states.layout
        if (cap.n_slots, cap.m_pad) != (config.n_slots, config.m_pad):
            raise ServiceConfigError(
                f"restore: checkpoint slot capacities (n_slots="
                f"{cap.n_slots}, m_pad={cap.m_pad}) != config "
                f"(n_slots={config.n_slots}, m_pad={config.m_pad}); "
                "restore with the saved capacities")
        payloads = meta.get("slot_maps")
        if payloads is None or len(payloads) != b:
            raise ServiceConfigError(
                "restore: sparse checkpoint carries "
                f"{0 if payloads is None else len(payloads)} SlotMap "
                f"payload(s) for {b} stream(s); rebuild these streams "
                "from their source graphs with FingerService.open")
        slot_maps = [SlotMap.from_json(p) for p in payloads]
        for slot, sm in enumerate(slot_maps):
            if sm.n_virtual > config.n_pad:
                raise ServiceConfigError(
                    f"restore: stream {slot}'s SlotMap addresses an "
                    f"n_pad={sm.n_virtual} virtual space but "
                    f"config.n_pad={config.n_pad}; virtual bounds "
                    "never shrink")
            if sm.n_virtual < config.n_pad:
                sm.grow_virtual(config.n_pad)  # a host-only repad
        return cls(config, plan, plan.place(states), step=step,
                   slot_maps=slot_maps)

    # -- introspection ---------------------------------------------------
    @property
    def config(self) -> ServiceConfig:
        return self._config

    @property
    def plan(self) -> ExecutionPlan:
        return self._plan

    @property
    def device(self) -> torch.device:
        """The device of the first shard (the only one when local)."""
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

    def states(self) -> Placed:
        """The live stacked state (device-resident; read-only use): a
        `Sharded` of per-shard states under the sharded placements."""
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
        with tracing.span("finger.ingest"):
            if self._config.method == "sparse_tick":
                self._ingest_sparse(deltas)
                return
            if not isinstance(deltas, GraphDelta):
                deltas = stack_deltas(list(deltas))
            self._ingestor.put(deltas)

    def ingest_counts(self) -> Dict[str, int]:
        """The double-buffered ingestor's staging counters, summed over
        shards (zero for the sync ingestor and on the CPU): ``staged``
        deltas, ``staged_bytes`` copied and ``slot_waits``, the
        stagings that blocked on their ring slot's previous copy.
        ``slot_waits / staged`` rising means the producer outruns the
        copy engine; ``staged_bytes / staged`` is a shard's bytes a
        tick. They survive migrations."""
        return self._ingestor.counts()

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
        tick is launched asynchronously; `scores()` waits for it. Saves
        a checkpoint every ``checkpoint.every_ticks`` ticks."""
        self._check_open("poll")
        with tracing.span("finger.poll"):
            deltas = self._ingestor.get()
            if deltas is None:
                return None
            dists, self._states = self._plan.tick(self._states, deltas)
            if tracing.recording():
                self._tick_done = [torch.cuda.current_stream(d).record_event()
                                   for d in self._plan.devices
                                   if d.type == "cuda"]
            return self._finish_tick(dists)

    def _finish_tick(self, scores: torch.Tensor) -> TickReport:
        self._last_scores = scores
        self._step += 1
        every = self._config.checkpoint.every_ticks
        if every is not None and self._step % every == 0:
            self.save()
        return TickReport(step=self._step, scores=scores)

    # -- pool-stacked tick hooks (the fleet's batched poll) --------------
    def begin_pool_tick(self) -> GraphDelta:
        """Hand this service's oldest queued tick to a pool-stacked
        launch as held (on the device under double buffering, ordered
        after its copy on the current stream), with no host sync.

        Raises when the queue is empty: the fleet stages a delta (an
        all-zero one at least) into every live shard before a
        pool-stacked poll."""
        self._check_open("begin_pool_tick")
        deltas = self._ingestor.pop()
        if deltas is None:
            raise ServiceLifecycleError(
                "begin_pool_tick with an empty ingestion queue — the "
                "fleet must stage every live shard (an empty stacked "
                "delta at minimum) before a pool-stacked poll")
        return deltas

    def finish_pool_tick(self, scores: torch.Tensor,
                         states: Placed) -> TickReport:
        """Absorb one pool-stacked launch's result for this service: its
        (B,) scores and updated stacked state. The same bookkeeping as
        `poll`, the periodic checkpoint included."""
        self._check_open("finish_pool_tick")
        self._states = states
        return self._finish_tick(scores)

    def scores(self) -> Optional[np.ndarray]:
        """Latest tick's (B,) JSdist scores on the host; None before
        the first tick."""
        self._check_open("scores")
        if self._last_scores is None:
            return None
        with tracing.span("finger.scores"):
            if self._tick_done:
                with tracing.span("finger.scores.wait"):
                    for event in self._tick_done:
                        event.synchronize()
                self._tick_done = None
            return self._plan.gather(self._last_scores).numpy()

    def top_anomalies(self, k: Optional[int] = None, per_pod: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """The k highest-scoring streams of the latest tick:
        ``(values, stream_ids)``, each (k,), descending (lower stream id
        first on ties) — or (n_pods, k) with ``per_pod=True`` under the
        multipod placement. A sharded plan merges each shard's top k,
        never the (B,) scores."""
        self._check_open("top_anomalies")
        if self._last_scores is None:
            raise ServiceLifecycleError(
                "top_anomalies before the first completed tick")
        k = self._config.topk.k if k is None else k
        with tracing.span("finger.top_anomalies"):
            if per_pod:
                if not isinstance(self._plan, MultiPodPlan):
                    raise ServiceConfigError(
                        "per_pod top-k needs placement='multipod', got "
                        f"{self._config.placement!r}")
                vals, ids = self._plan.pod_topk(self._last_scores, k)
            else:
                vals, ids = self._plan.topk(self._last_scores, k)
            return vals.cpu().numpy(), ids.cpu().numpy()

    def score_at(self, slot: int) -> Optional[float]:
        """The latest tick's score of one stream slot; None before the
        first tick."""
        self._check_open("score_at")
        self._require_slot(slot, "score_at")
        if self._last_scores is None:
            return None
        return self._plan.score_at(self._last_scores, slot)

    # -- stream-slot hooks (the fleet's shard-facing surface) ------------
    def _require_slot(self, slot: int, what: str) -> None:
        if not 0 <= int(slot) < self._config.batch_size:
            raise ServiceConfigError(
                f"{what}: slot {slot} outside this service's "
                f"batch_size={self._config.batch_size}")

    def _require_idle(self, what: str) -> None:
        if self.pending:
            raise ServiceLifecycleError(
                f"{what} with {self.pending} ingested tick(s) still "
                "pending; poll() them first — swapping a stream row "
                "under a queued tick would tear the stream")

    def extract_stream(self, slot: int) -> State:
        """A copy of one stream's state row (slot axis dropped), on the
        device; later ticks do not change it. Requires an empty
        queue."""
        self._check_open("extract_stream")
        self._require_slot(slot, "extract_stream")
        self._require_idle("extract_stream")
        return migrate.take_stream(self._states, slot)

    def install_stream(self, slot: int, row: State,
                       slot_map: Optional[SlotMap] = None) -> None:
        """Write ``row`` (one stream's state in this service's layout,
        e.g. another service's `extract_stream`) into ``slot``. Sparse
        services also take the stream's `SlotMap`. Requires an empty
        queue."""
        self._check_open("install_stream")
        self._require_slot(slot, "install_stream")
        self._require_idle("install_stream")
        if self._config.method == "sparse_tick":
            if slot_map is None:
                raise ServiceConfigError(
                    "install_stream: sparse streams carry a host-side "
                    "SlotMap — pass the row's map")
            if (slot_map.layout.n_slots, slot_map.layout.m_pad) != \
                    (self._capacity.n_slots, self._capacity.m_pad):
                raise ServiceConfigError(
                    f"install_stream: SlotMap capacities "
                    f"(n_slots={slot_map.layout.n_slots}, "
                    f"m_pad={slot_map.layout.m_pad}) != this service's "
                    f"(n_slots={self._capacity.n_slots}, "
                    f"m_pad={self._capacity.m_pad})")
        elif slot_map is not None:
            raise ServiceConfigError(
                "install_stream: slot_maps are sparse-only state "
                f"(method={self._config.method!r})")
        self._states = migrate.put_stream(self._states, row, slot)
        if slot_map is not None:
            slot_map.stream = slot
            self._slot_maps[slot] = slot_map

    def clear_stream(self, slot: int) -> None:
        """Zero one stream's row (inactive everywhere, every statistic 0:
        its score against an empty delta is 0). Requires an empty
        queue."""
        self._check_open("clear_stream")
        self._require_slot(slot, "clear_stream")
        self._require_idle("clear_stream")
        self._states = migrate.clear_stream(self._states, slot)
        if self._config.method == "sparse_tick":
            self._slot_maps[slot] = SlotMap(
                self._capacity, n_virtual=self._config.n_pad, stream=slot)

    # -- persistence -----------------------------------------------------
    def save(self, directory: Optional[str] = None) -> str:
        """Checkpoint the stacked state (atomic write, the config's prune
        policy) in the reference's format; returns its path. Sparse
        services write their `SlotMap`s' JSON into the manifest beside
        the slot capacities. A sharded state is gathered to the host
        first. Waits for the devices' streams first: the ticks update
        the state in place."""
        self._check_open("save")
        ckpt_dir = directory or self._config.checkpoint.directory
        if ckpt_dir is None:
            raise ServiceConfigError(
                "save: ServiceConfig.checkpoint.directory is None and "
                "no directory was passed — declare one in the config")
        self._plan.synchronize()
        states = self._plan.gather(self._states)
        sparse = self._config.method == "sparse_tick"
        meta = {
            "kind": CKPT_KIND,
            "b": int(states.q.shape[0]),
            "n_pad": (self._config.n_pad if sparse
                      else int(states.strengths.shape[-1])),
            "has_node_mask": states.node_mask is not None,
            "layout_generation": self._layout.generation,
            "exact_smax": self._config.exact_smax,
            "method": self._config.method,
            "service": {"placement": self._config.placement,
                        "ingestion": self._config.ingestion,
                        "k_pad": self._config.k_pad},
        }
        if sparse:
            meta["sparse"] = {
                "n_slots": int(self._capacity.n_slots),
                "m_pad": int(self._capacity.m_pad),
                "generation": int(self._capacity.generation),
            }
            meta["slot_maps"] = [sm.to_json() for sm in self._slot_maps]
        return save_checkpoint(ckpt_dir, self._step, state_tree(states),
                               metadata=meta,
                               prune_policy=self._config.checkpoint.prune)

    # -- live migration --------------------------------------------------
    def _journal(self, record: dict) -> None:
        """Append a migration record to the checkpoint directory's
        layout log (nothing for an ephemeral service)."""
        ckpt_dir = self._config.checkpoint.directory
        if ckpt_dir is not None:
            migrate.append_layout_record(ckpt_dir, record)

    def _swap_plan(self, config: ServiceConfig) -> None:
        """Install the plan of ``config``: the warm one when
        `warm_next_layouts` predicted it, a cold one otherwise."""
        where = self._plan.where
        self._config = config
        if config.plan_cache.enabled:
            self._plan = self._plan_cache.get(config, where)
        else:
            self._plan = build_plan(config, where)

    def _install_migration(self, states: Placed,
                           new_layout: NodeLayout, pending) -> None:
        """Common tail of repad/compact: swap config, plan and layout,
        rebuild the ingestor, and queue the ticks again (the caller has
        already migrated them into the new layout)."""
        self._swap_plan(self._config.with_(n_pad=new_layout.n_pad))
        self._layout = new_layout
        self._states = states
        self._ingestor = self._make_ingestor(self._ingestor)
        for deltas in pending:
            self._ingestor.requeue(deltas)

    def _take_pending_migrated(self, transform) -> List[GraphDelta]:
        """Drain the queue through ``transform`` (the migration's delta
        re-layout). Atomic: if a queued tick cannot be migrated (a join
        addressing a slot the compaction would drop), the queue is put
        back and the migration aborts with the service as it was."""
        pending = self._ingestor.take_all()
        try:
            return [each(transform, d) for d in pending]
        except LayoutMigrationError:
            for d in pending:
                self._ingestor.requeue(d)
            raise

    def _commit_shrink(self, new_layout: NodeLayout,
                       states_new: Placed,
                       index_map: np.ndarray) -> None:
        """Commit a shrink (compact or repad truncation) whose new state
        is already computed (the transforms make new tensors, so nothing
        has changed yet): migrate the queue first (the clean abort),
        then install and journal."""
        pending = self._take_pending_migrated(
            lambda d: migrate.remap_delta(d, index_map, new_layout.n_pad))
        record = migrate.migration_record(
            "compact", self._layout, new_layout, index_map)
        self._absorb_index_map(index_map)
        self._install_migration(states_new, new_layout, pending)
        self._journal(record)

    def repad(self, new_n_pad: int) -> None:
        """Migrate the shared node layout to ``new_n_pad`` in place.

        Growth embeds the stacked state on the device (new slots
        inactive with zero strength: exact for every FINGER statistic).
        A shrink is allowed only when every slot at/above ``new_n_pad``
        is inactive in every stream; otherwise it raises
        `LayoutMigrationError` (`compact()` also reclaims interior
        holes). Queued ticks are re-laid-out into the new layout; later
        deltas are built with ``n_pad=new_n_pad`` (or stamped with
        their layout's generation).

        Under ``method="sparse_tick"`` n_pad is a host-side addressing
        bound only, so the repad touches the host maps alone.
        """
        self._check_open("repad")
        old = self._layout.n_pad
        if new_n_pad == old:
            raise ServiceConfigError(f"repad: already at n_pad={old}")
        if self._config.method == "sparse_tick":
            if new_n_pad < old:
                raise LayoutMigrationError(
                    f"repad: the sparse virtual space only grows "
                    f"(new_n_pad={new_n_pad} < {old}); nothing is "
                    "sized by n_pad, so shrinking it reclaims nothing")
            self._config = self._config.with_(n_pad=new_n_pad)
            self._plan.config = self._plan.config.with_(n_pad=new_n_pad)
            self._ingestor.config = self._config
            for sm in self._slot_maps:
                sm.grow_virtual(new_n_pad)
            self._layout = NodeLayout(new_n_pad,
                                      generation=self._layout.generation)
            return
        if new_n_pad > old:
            migrate.check_journalable(self._config.checkpoint.directory,
                                      self._layout.generation)
            pending = self._take_pending_migrated(
                lambda d: migrate.embed_delta(d, new_n_pad))
            new_layout = self._layout.grown(new_n_pad)
            states = migrate.grow_stacked(self._states, new_layout)
            record = migrate.migration_record(
                "grow", self._layout, new_layout, index_map=None)
            # stamped deltas survive a grow (an identity injection); raw
            # old-size deltas stay refused (ambiguous by size alone)
            self._absorb_generation_map(identity_index_map(old))
            self._install_migration(states, new_layout, pending)
            self._journal(record)
            return
        lost = np.nonzero(migrate.occupancy(self._states)[new_n_pad:])[0] \
            + new_n_pad
        if lost.size:
            # before touching the queue: a refused migration leaves the
            # service as it was
            raise LayoutMigrationError(
                f"repad: new_n_pad={new_n_pad} would truncate "
                f"active node slot(s) {lost[:8].tolist()} — a lossy "
                "migration; grow instead, or compact() after the "
                "tenants holding those slots leave")
        migrate.check_journalable(self._config.checkpoint.directory,
                                  self._layout.generation)
        new_layout = self._layout.compacted(new_n_pad)
        states = migrate.truncate_stacked(self._states, new_layout)
        index_map = np.full((old,), -1, np.int32)
        index_map[:new_n_pad] = np.arange(new_n_pad, dtype=np.int32)
        self._commit_shrink(new_layout, states, index_map)

    def _absorb_generation_map(self, index_map: np.ndarray) -> None:
        """Chain the generation-keyed grace table through one more
        migration, give the retiring generation its own entry, and
        prune to ``grace_generations``."""
        self._remaps_gen = {g: compose_index_maps(m, index_map)
                            for g, m in self._remaps_gen.items()}
        self._remaps_gen[self._layout.generation] = \
            np.asarray(index_map, np.int32)
        self._remaps_gen = migrate.prune_generation_remaps(
            self._remaps_gen, self._layout.generation + 1,
            self._config.grace_generations)

    def _absorb_index_map(self, index_map: np.ndarray) -> None:
        """Compose a shrink's old→new map into both grace tables; in the
        size-keyed one the retiring layout gains an entry keyed by its
        n_pad (a later migration from the same size shadows it)."""
        self._remaps = {k: compose_index_maps(m, index_map)
                        for k, m in self._remaps.items()}
        self._remaps[self._layout.n_pad] = np.asarray(index_map, np.int32)
        self._absorb_generation_map(index_map)

    def compact(self, new_n_pad: Optional[int] = None) -> CompactionReport:
        """Drop the node slots inactive in every stream and renumber the
        survivors.

        Such a slot holds zero strength and zero mask, so S, Σs², Σ_E w²
        and s_max are unchanged and only the addressing moves. The
        occupancy, the renumbering and the gather run on the device
        (`migrate.compact_stacked_auto`); the host reads the live-slot
        count and the (n_pad,) index map, never the stacked state. The
        map stays installed for ingestion's grace period, and the
        journal records it.

        ``new_n_pad`` defaults to the live-slot count; a larger value
        leaves headroom, a smaller one raises `LayoutMigrationError`.
        When nothing is reclaimable (and no ``new_n_pad`` asks for a
        resize) the service is left as it is with ``reclaimed == 0``.
        """
        self._check_open("compact")
        if self._config.method == "sparse_tick":
            raise ServiceConfigError(
                "compact: the sparse slot space self-compacts — freed "
                "node/edge slots return to each stream's SlotMap free "
                "list and are reused in place, so there is no "
                "cross-stream layout to renumber (grow_capacity() is "
                "the sparse migration)")
        n_live = migrate.live_slot_count(self._states)
        target = max(n_live, 1) if new_n_pad is None else int(new_n_pad)
        if target < n_live:
            raise LayoutMigrationError(
                f"compact: new_n_pad={target} < {n_live} live slot(s) — "
                "a lossy migration; only permanently-left slots can be "
                "reclaimed")
        if target >= self._layout.n_pad:
            if new_n_pad is None:
                return CompactionReport(
                    old_n_pad=self._layout.n_pad,
                    new_n_pad=self._layout.n_pad, n_live=n_live,
                    generation=self._layout.generation,
                    index_map=identity_index_map(self._layout.n_pad))
            raise LayoutMigrationError(
                f"compact: new_n_pad={target} does not shrink the "
                f"current n_pad={self._layout.n_pad} (repad() grows)")
        migrate.check_journalable(self._config.checkpoint.directory,
                                  self._layout.generation)
        new_layout = self._layout.compacted(target)
        states, imap_device = migrate.compact_stacked_auto(self._states,
                                                           new_layout)
        index_map = imap_device.cpu().numpy()
        self._commit_shrink(new_layout, states, index_map)
        return CompactionReport(
            old_n_pad=int(index_map.shape[0]), new_n_pad=new_layout.n_pad,
            n_live=n_live, generation=new_layout.generation,
            index_map=index_map)

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
        pending = self._take_pending_migrated(
            lambda d: migrate.embed_sparse_delta(d, new_capacity.n_slots))
        states = migrate.grow_sparse_stacked(self._states, new_capacity)
        self._swap_plan(self._config.with_(n_slots=new_capacity.n_slots,
                                           m_pad=new_capacity.m_pad))
        self._capacity = new_capacity
        for sm in self._slot_maps:
            sm.grow(new_capacity)
        self._states = states
        self._ingestor = self._make_ingestor(self._ingestor)
        for d in pending:
            self._ingestor.requeue(d)
        return new_capacity

    # -- warm plans ------------------------------------------------------
    def warm_next_layouts(self, targets: Optional[Sequence] = None,
                          background: bool = False
                          ) -> Union[list, WarmupHandle]:
        """Make plans ready for predicted next layouts, so that a later
        `repad` / `compact` / `grow_capacity` installs one whose first
        tick pays no first-use cost (the kernel's load, its ctypes
        binding, the allocator's first blocks of those shapes).

        For each target it runs the post-migration tick and default
        top-k once on zero-filled state and delta (`ExecutionPlan.
        warm_tick`), then the migration's state transform on a
        zero-filled copy of the live state's shapes. ``targets`` are
        n_pad values (``(n_slots, m_pad)`` pairs under
        ``method="sparse_tick"``); the default prediction comes from
        ``ServiceConfig.plan_cache``: the grow target
        ``round(n_pad * growth_factor)`` and, with ``warm_compact``, the
        live-slot count. Returns the warmed targets. With
        ``background=True`` the warm runs on a thread of its own, on its
        own CUDA streams and dummy state, and a `WarmupHandle` is
        returned; ``wait()`` on it before any migration.
        """
        self._check_open("warm_next_layouts")
        policy = self._config.plan_cache
        if not policy.enabled:
            targets = []
        elif targets is None:
            targets = self._default_warm_targets(policy)
        else:
            targets = list(targets)
        if not background:
            return self._warm_targets(targets)

        def run() -> list:
            cuda = [d for d in self._plan.devices if d.type == "cuda"]
            if not cuda:
                return self._warm_targets(targets)
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.cuda.device(self.device))
                # a side stream of each device made current: the warm's
                # ticks and its waits run there, never on the serving
                # streams
                streams = [torch.cuda.Stream(d) for d in cuda]
                for stream in streams:
                    stack.enter_context(torch.cuda.stream(stream))
                warmed = self._warm_targets(targets)
                for stream in streams:
                    stream.synchronize()
                return warmed

        return WarmupHandle(run)

    def _default_warm_targets(self, policy) -> list:
        """The `PlanCachePolicy` prediction (reads the live state, so it
        runs on the calling thread)."""
        if self._config.method == "sparse_tick":
            cap = self._capacity
            return [(int(round(cap.n_slots * policy.growth_factor)),
                     int(round(cap.m_pad * policy.growth_factor)))]
        n_pad = self._layout.n_pad
        targets = []
        grow = int(round(n_pad * policy.growth_factor))
        if grow > n_pad:
            targets.append(grow)
        if policy.warm_compact:
            n_live = migrate.live_slot_count(self._states)
            if 0 < n_live < n_pad:
                targets.append(n_live)
        return targets

    def _warm_targets(self, targets: Sequence) -> list:
        """The loop of `warm_next_layouts` (inline, or on the warming
        thread with its streams current)."""
        dummy = each(lambda st: st.map_tensors(torch.zeros_like),
                     self._states)
        warmed = []
        if self._config.method == "sparse_tick":
            cap = self._capacity
            for n_slots, m_pad in targets:
                n_slots, m_pad = int(n_slots), int(m_pad)
                if (n_slots, m_pad) == (cap.n_slots, cap.m_pad) \
                        or n_slots < cap.n_slots or m_pad < cap.m_pad:
                    continue
                new_capacity = cap.grown(n_slots=n_slots, m_pad=m_pad)
                cfg = self._config.with_(n_slots=n_slots, m_pad=m_pad)
                self._plan_cache.warm(cfg, self._plan.where, new_capacity)
                migrate.grow_sparse_stacked(dummy, new_capacity)
                warmed.append((n_slots, m_pad))
            return warmed
        n_pad = self._layout.n_pad
        for target in targets:
            target = int(target)
            if target == n_pad or target <= 0:
                continue
            new_layout = self._layout.grown(target) if target > n_pad \
                else self._layout.compacted(target)
            self._plan_cache.warm(self._config.with_(n_pad=target),
                                  self._plan.where, new_layout)
            if target > n_pad:
                migrate.grow_stacked(dummy, new_layout)
            else:
                migrate.compact_stacked_auto(dummy, new_layout)
            warmed.append(target)
        return warmed

    @property
    def plan_cache(self) -> PlanCache:
        """The warm plan pool (`len`, `warmed_layouts`)."""
        return self._plan_cache

    # -- teardown --------------------------------------------------------
    def close(self) -> None:
        """Wait for in-flight work and drop the queue. Idempotent; every
        other method raises `ServiceLifecycleError` afterwards."""
        if self._closed:
            return
        self._plan.synchronize()
        self._ingestor.drain()
        self._closed = True

    def __enter__(self) -> "FingerService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
