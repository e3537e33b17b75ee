"""ExecutionPlan: how one ServiceConfig ticks and answers queries.

The port's counterpart of `repro.serving.plans`. A plan owns what is
placement-shaped: the tick, where the stacked state and each tick's
delta live, and how `top_anomalies` runs. `FingerService` builds one
from ``config.placement``:

- ``LocalPlan``: the `StreamEngine` tick on one device, on a stacked
  `FingerState` (or `SparseStreamState` under ``method="sparse_tick"``).
- ``ShardedPlan``: the streams split over the ``data_axis`` of a
  `DeviceGrid`; each shard's B/p streams tick on its device
  (`StreamEngine.make_sharded_tick`: one kernel launch a shard, all
  enqueued before anything waits). Independent streams need no
  collective. The state is a `Sharded` of per-shard stacked states,
  each owning its tensors.
- ``MultiPodPlan``: the streams split over ``(pod_axis, data_axis)``;
  adds per-pod top-k queries merged over the data axis only.

One process drives every shard (the reference's single controller);
shards may share a device (logical shards on one card, or CPU grids).

Top-k order. Each shard sorts its scores with a stable descending sort
and keeps its first k; its local ids become global ids by the shard's
mixed-radix offset, the p·k candidates move to the first shard's
device and a stable sort merges them. That gives `jax.lax.top_k`'s
order on ties (the lower stream id first), the `LocalPlan`'s order.
Unchanged streams score exactly 0, so ties are common. The (B,) score
vector is never gathered for a query.

`PlanCache` is the warm pool behind the migrations: it holds plans
made ready (`ExecutionPlan.warm_tick`) for predicted next layouts, so
that `FingerService.repad` / `compact` / `grow_capacity` install a plan
whose first tick pays no first-use cost. The port compiles nothing a
layout at a time, so warming a layout means running the tick and the
default top-k once on zero-filled state and delta at that layout's
shapes: that loads the kernel's library and module, binds its ctypes
signature and gives the caching allocator the blocks of those shapes.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.sparse import (EDGE_SLOT_SENTINEL, SparseLayout,
                                     SparseStreamState)
from repro_torch.core.state import FingerState
from repro_torch.distributed.sharding import (DeviceGrid, Sharded,
                                              concat_rows, make_grid)
from repro_torch.engine.stream import StreamEngine
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels import dispatch
from repro_torch.serving.config import ServiceConfig, ServiceConfigError

Layout = Union[NodeLayout, SparseLayout]
State = Union[FingerState, SparseStreamState]
Where = Union[torch.device, DeviceGrid]


def dummy_tick_args(config: ServiceConfig, layout: Layout,
                    device: torch.device
                    ) -> Tuple[Union[FingerState, SparseStreamState],
                               GraphDelta]:
    """Zero-filled (states, deltas) on ``device`` of exactly the shapes
    the serving tick runs at under ``config`` at ``layout`` (a
    `NodeLayout` for the dense methods, a `SparseLayout` under
    ``method="sparse_tick"``, whose deltas carry ``edge_slots`` and are
    addressed in n_slots)."""
    c = config
    b, k, j = c.batch_size, c.k_pad, c.j_pad

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    if c.method == "sparse_tick":
        if not isinstance(layout, SparseLayout):
            raise ServiceConfigError(
                f"method='sparse_tick' ticks over a SparseLayout, got "
                f"{type(layout).__name__}")
        if layout.n_slots != c.n_slots or layout.m_pad != c.m_pad:
            raise ServiceConfigError(
                f"layout capacities (n_slots={layout.n_slots}, "
                f"m_pad={layout.m_pad}) disagree with the config "
                f"(n_slots={c.n_slots}, m_pad={c.m_pad})")
        n = layout.n_slots
        states = SparseStreamState(
            q=zeros(b), s_total=zeros(b), s_max=zeros(b),
            strengths=zeros(b, n), node_mask=zeros(b, n),
            edge_weights=zeros(b, layout.m_pad), layout=layout)
        edge_slots = torch.full((b, k), int(EDGE_SLOT_SENTINEL),
                                dtype=torch.int32, device=device)
    else:
        if layout.n_pad != c.n_pad:
            raise ServiceConfigError(
                f"warm_tick: layout n_pad={layout.n_pad} != this "
                f"plan's config.n_pad={c.n_pad}")
        n = layout.n_pad
        states = FingerState(
            q=zeros(b), s_total=zeros(b), s_max=zeros(b),
            strengths=zeros(b, n), node_mask=zeros(b, n), layout=layout)
        edge_slots = None
    i32 = torch.int32
    deltas = GraphDelta(
        senders=zeros(b, k, dtype=i32), receivers=zeros(b, k, dtype=i32),
        dw=zeros(b, k), w_old=zeros(b, k), mask=zeros(b, k), n_nodes=n,
        node_ids=None if j is None else zeros(b, j, dtype=i32),
        node_flag=None if j is None else zeros(b, j),
        edge_slots=edge_slots)
    return states, deltas


class ExecutionPlan:
    """Tick + placement policy for one ServiceConfig.

    Subclasses fill in ``axes`` (the grid axes the stream axis is split
    over; none for the local plan), ``grid`` and ``shard_devices`` (the
    device of each shard, in shard order). ``device`` is the first
    shard's: the one that answers queries.
    """

    axes: Tuple[str, ...] = ()
    grid: Optional[DeviceGrid] = None

    def __init__(self, config: ServiceConfig, device: torch.device):
        self.config = config
        self.device = device
        self.engine = StreamEngine(exact_smax=config.exact_smax,
                                   method=config.method, device=device)

    # -- placement geometry ---------------------------------------------
    @property
    def shard_devices(self) -> List[torch.device]:
        return [self.device]

    @property
    def num_shards(self) -> int:
        return len(self.shard_devices)

    @property
    def streams_per_shard(self) -> int:
        return self.config.batch_size // self.num_shards

    @property
    def devices(self) -> List[torch.device]:
        """Each distinct device of the plan once."""
        out: List[torch.device] = []
        for d in self.shard_devices:
            if d not in out:
                out.append(d)
        return out

    @property
    def where(self) -> Where:
        """What the plan was built on: its device, or its grid."""
        return self.device if self.grid is None else self.grid

    def synchronize(self) -> None:
        """Wait for every CUDA device of the plan."""
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- data movement ---------------------------------------------------
    def place(self, states: State) -> Union[State, Sharded]:
        """A whole stacked state laid out as this plan keeps it."""
        return states.to(self.device)

    def gather(self, x, device="cpu"):
        """A stacked value this plan holds (state or scores), whole on
        ``device``."""
        return concat_rows(x, device)

    def put_deltas(self, deltas: GraphDelta,
                   stage: Optional[Callable] = None):
        """One tick's stacked host delta moved to where the tick reads
        it: each shard's rows to its device. ``stage(shard, device,
        rows)``, if given, moves one shard's rows instead (the
        double-buffered ingestor's side-stream copy) and its results
        are returned in the plan's layout (`Sharded` for a sharded
        plan)."""
        if stage is not None:
            return stage(0, self.device, deltas)
        return deltas.map_tensors(lambda t: t.to(self.device).contiguous())

    # -- the tick --------------------------------------------------------
    def tick(self, states, deltas: GraphDelta):
        """(B,) JSdist scores + updated stacked state (``states`` may be
        updated in place — rebind to the returned one). A sharded plan
        returns both as `Sharded`."""
        raise NotImplementedError

    def warm_tick(self, layout: Layout) -> None:
        """Run this plan's tick and default top-k once on zero-filled
        state and delta at ``layout`` and wait for them, on each
        device's current stream (a background warm makes streams of its
        own current). Called by `PlanCache.warm` with the predicted
        post-migration layout."""
        dists, _ = self.tick(*self._dummies(layout))
        self.topk(dists, self.config.topk.k)
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()

    def _dummies(self, layout: Layout):
        return dummy_tick_args(self.config, layout, self.device)

    # -- queries ---------------------------------------------------------
    def _validate_k(self, k: int) -> None:
        if k <= 0:
            raise ServiceConfigError(f"top_anomalies k={k} must be "
                                     f"positive")
        if k > self.streams_per_shard:
            raise ServiceConfigError(
                f"top_anomalies k={k} exceeds the per-shard stream "
                f"count {self.streams_per_shard} "
                f"(batch_size={self.config.batch_size} over "
                f"{self.num_shards} shard(s)); shrink k or re-open with "
                f"a coarser placement")

    def topk(self, scores, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global top-k: ((k,) values, (k,) int32 stream ids),
        descending, on ``device``."""
        raise NotImplementedError

    def score_at(self, scores, slot: int) -> float:
        """One stream's score of a (B,) score vector this plan holds."""
        return float(scores[int(slot)])


def _stable_topk(scores: torch.Tensor, k: int, offset: int = 0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first k of a stable descending sort, ids shifted by
    ``offset`` (ties keep the lower id first)."""
    vals, ids = torch.sort(scores, descending=True, stable=True)
    return vals[:k], (ids[:k] + offset).to(torch.int32)


class LocalPlan(ExecutionPlan):
    """Single-device tick — `StreamEngine.tick` verbatim."""

    def tick(self, states, deltas):
        return self.engine.tick(states, deltas)

    def topk(self, scores, k):
        self._validate_k(k)
        return _stable_topk(scores, k)


def _require_axis(grid: DeviceGrid, axis: str) -> None:
    if axis not in grid.axis_names:
        raise ServiceConfigError(
            f"grid axes {tuple(grid.axis_names)} carry no {axis!r} axis "
            f"required by the placement")


class _ShardedPlanBase(ExecutionPlan):
    """The sharded and multipod placements: the stream axis split over
    the grid's ``axes`` in mixed-radix order."""

    def __init__(self, config: ServiceConfig, grid: DeviceGrid):
        for ax in self.axes:
            _require_axis(grid, ax)  # a named error before anything
        self.grid = grid
        self._shard_devices = grid.shard_devices(self.axes)
        config.validate(num_shards=len(self._shard_devices))
        super().__init__(config, self._shard_devices[0])
        self._tick = self.engine.make_sharded_tick(grid, self.axes)

    @property
    def shard_devices(self) -> List[torch.device]:
        return list(self._shard_devices)

    def place(self, states):
        return self.engine.shard_states(states, self.grid, self.axes)

    def put_deltas(self, deltas, stage=None):
        rows = self.streams_per_shard
        parts = []
        for i, dev in enumerate(self._shard_devices):
            part = deltas.map_tensors(
                lambda t, lo=i * rows: t[lo:lo + rows])
            parts.append(stage(i, dev, part) if stage is not None else
                         part.map_tensors(lambda t, d=dev:
                                          t.to(d).contiguous()))
        return Sharded(tuple(parts), rows)

    def tick(self, states, deltas):
        return self._tick(states, deltas)

    def _dummies(self, layout):
        c = self.config.with_(batch_size=self.streams_per_shard)
        states, deltas = zip(*(dummy_tick_args(c, layout, d)
                               for d in self._shard_devices))
        rows = self.streams_per_shard
        return Sharded(states, rows), Sharded(deltas, rows)

    def _candidates(self, scores: Sharded, k: int, shards
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The stable top-k of each shard in ``shards`` with global ids,
        concatenated in shard order on the first shard's device."""
        rows, vals, ids = self.streams_per_shard, [], []
        for i in shards:
            v, g = _stable_topk(scores.parts[i], k, i * rows)
            vals.append(v.to(self.device))
            ids.append(g.to(self.device))
        return torch.cat(vals), torch.cat(ids)

    def topk(self, scores, k):
        self._validate_k(k)
        cand_vals, cand_ids = self._candidates(scores, k,
                                               range(self.num_shards))
        vals, pos = torch.sort(cand_vals, descending=True, stable=True)
        return vals[:k], cand_ids[pos[:k]]

    def score_at(self, scores, slot):
        shard, local = scores.locate(slot)
        return float(scores.parts[shard][local])


class ShardedPlan(_ShardedPlanBase):
    """Streams split over ``(data_axis,)`` of a grid."""

    def __init__(self, config: ServiceConfig, grid: DeviceGrid):
        self.axes = (config.data_axis,)
        super().__init__(config, grid)


class MultiPodPlan(_ShardedPlanBase):
    """Streams split over ``(pod_axis, data_axis)``; per-pod top-k
    queries merge candidates over the data axis only."""

    def __init__(self, config: ServiceConfig, grid: DeviceGrid):
        self.axes = (config.pod_axis, config.data_axis)
        super().__init__(config, grid)

    @property
    def n_pods(self) -> int:
        return self.grid.axis_size(self.config.pod_axis)

    def pod_topk(self, scores: Sharded, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-pod top-k: ((n_pods, k) values, (n_pods, k) stream ids).
        Each pod merges the n_data·k candidates of its own shards."""
        self._validate_k(k)
        n_data = self.num_shards // self.n_pods
        vals, ids = [], []
        for pod in range(self.n_pods):
            cv, ci = self._candidates(
                scores, k, range(pod * n_data, (pod + 1) * n_data))
            v, pos = torch.sort(cv, descending=True, stable=True)
            vals.append(v[:k])
            ids.append(ci[pos[:k]])
        return torch.stack(vals), torch.stack(ids)


class PlanCache:
    """Warm pool of ready `ExecutionPlan`s for layout migrations.

    Keyed by the `ServiceConfig` fields a plan's tick depends on and the
    device or grid. ``warm`` builds a plan for a predicted next config
    and warms it at the predicted layout; ``get`` is what
    `FingerService` swaps through: a hit returns the warm plan (popped:
    one migration consumes one warm plan), a miss builds a cold one. The
    lock covers the dict only, never a warm, so a background warming
    thread may insert while the serving thread pops.
    """

    def __init__(self):
        self._plans: Dict[tuple, Tuple[ExecutionPlan, Layout]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(config: ServiceConfig, where: Where) -> tuple:
        # Under the sparse method n_pad is the virtual addressing bound,
        # which no device tensor depends on, so a free virtual repad
        # between warm() and get() keeps a warm plan valid.
        n_pad = None if config.method == "sparse_tick" else config.n_pad
        return (config.batch_size, n_pad, config.k_pad, config.j_pad,
                config.n_slots, config.m_pad, config.method,
                config.exact_smax, config.placement, config.data_axis,
                config.pod_axis,
                where.key if isinstance(where, DeviceGrid) else str(where))

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    @property
    def warmed_layouts(self) -> Tuple[Layout, ...]:
        """The layouts held warm."""
        with self._lock:
            return tuple(layout for _, layout in self._plans.values())

    def warm(self, config: ServiceConfig, where: Where,
             layout: Layout) -> ExecutionPlan:
        """Build a plan for ``config`` and warm it at ``layout``."""
        plan = build_plan(config, where)
        plan.warm_tick(layout)
        with self._lock:
            self._plans[self._key(config, where)] = (plan, layout)
        return plan

    def get(self, config: ServiceConfig, where: Where) -> ExecutionPlan:
        """The plan to install for ``config``: the warm one if it was
        predicted, a cold `build_plan` otherwise."""
        with self._lock:
            hit = self._plans.pop(self._key(config, where), None)
        if hit is not None:
            cached = hit[0].config
            if config.method == "sparse_tick":
                # a plan warmed before a virtual repad: n_pad is
                # host-side only, so align it
                cached = cached.with_(n_pad=config.n_pad)
            if cached == config:
                hit[0].config = cached
                return hit[0]
        return build_plan(config, where)


def default_grid(config: ServiceConfig, device: torch.device) -> DeviceGrid:
    """The grid a sharded placement gets when the caller names only a
    device: one shard on a CPU device, one per visible card on CUDA
    (``(1, n)`` over ``(pod_axis, data_axis)`` for multipod)."""
    devices = [device] if device.type == "cpu" else None
    n = 1 if device.type == "cpu" else torch.cuda.device_count()
    if config.placement == "multipod":
        return make_grid((1, n), (config.pod_axis, config.data_axis),
                         devices)
    return make_grid((n,), (config.data_axis,), devices)


def build_plan(config: ServiceConfig, where: Where) -> ExecutionPlan:
    """The plan of ``config.placement`` on a device (a sharded placement
    then gets `default_grid`) or a `DeviceGrid` (sharded placements
    only). Each call counts as a first use (`dispatch.FIRST_USE`): a
    warmed migration takes its plan from the `PlanCache` instead."""
    dispatch.note_first_use("build_plan")
    if config.placement == "local":
        if isinstance(where, DeviceGrid):
            raise ServiceConfigError(
                "placement='local' takes no grid; use 'sharded' or "
                "'multipod' to place streams on a grid")
        config.validate(num_shards=1)
        return LocalPlan(config, where)
    if config.placement not in ("sharded", "multipod"):
        raise ServiceConfigError(
            f"unknown placement {config.placement!r}")
    grid = where if isinstance(where, DeviceGrid) \
        else default_grid(config, where)
    if config.placement == "sharded":
        return ShardedPlan(config, grid)
    return MultiPodPlan(config, grid)
