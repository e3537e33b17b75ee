"""ExecutionPlan: how one ServiceConfig ticks and answers queries.

The port's counterpart of `repro.serving.plans`, for the local
placement only: `LocalPlan` runs the `StreamEngine` tick on one device
— on a stacked `FingerState`, or on a stacked `SparseStreamState` under
``method="sparse_tick"`` — and answers global top-k queries. The
sharded and multipod plans are not yet ported.

Top-k order. `top_anomalies` sorts the scores with a stable descending
sort and keeps the first k, which gives `jax.lax.top_k`'s order on ties
(the lower stream id first). Unchanged streams score exactly 0, so ties
are common.

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
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.sparse import (EDGE_SLOT_SENTINEL, SparseLayout,
                                     SparseStreamState)
from repro_torch.core.state import FingerState
from repro_torch.engine.stream import StreamEngine
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving.config import ServiceConfig, ServiceConfigError

Layout = Union[NodeLayout, SparseLayout]


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
    """Tick + placement policy for one ServiceConfig on one device."""

    num_shards = 1

    def __init__(self, config: ServiceConfig, device: torch.device):
        self.config = config
        self.device = device
        self.engine = StreamEngine(exact_smax=config.exact_smax,
                                   method=config.method, device=device)

    @property
    def streams_per_shard(self) -> int:
        return self.config.batch_size // self.num_shards

    def tick(self, states: Union[FingerState, SparseStreamState],
             deltas: GraphDelta
             ) -> Tuple[torch.Tensor, Union[FingerState, SparseStreamState]]:
        """(B,) JSdist scores + updated stacked state (``states`` may be
        updated in place — rebind to the returned one)."""
        raise NotImplementedError

    def warm_tick(self, layout: Layout,
                  stream: Optional[torch.cuda.Stream] = None) -> None:
        """Run this plan's tick and default top-k once on zero-filled
        state and delta at ``layout`` and wait for them, on ``stream``
        (a background warm passes its own) or the current stream. Called
        by `PlanCache.warm` with the predicted post-migration layout."""
        if self.device.type != "cuda":
            self._warm(layout)
            return
        stream = stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            self._warm(layout)
        stream.synchronize()

    def _warm(self, layout: Layout) -> None:
        states, deltas = dummy_tick_args(self.config, layout, self.device)
        dists, _ = self.tick(states, deltas)
        self.topk(dists, self.config.topk.k)

    def _validate_k(self, k: int) -> None:
        if k <= 0:
            raise ServiceConfigError(f"top_anomalies k={k} must be "
                                     f"positive")
        if k > self.streams_per_shard:
            raise ServiceConfigError(
                f"top_anomalies k={k} exceeds the per-shard stream "
                f"count {self.streams_per_shard} "
                f"(batch_size={self.config.batch_size} over "
                f"{self.num_shards} shard(s))")

    def topk(self, scores: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Global top-k: ((k,) values, (k,) int32 stream ids), descending."""
        raise NotImplementedError


class LocalPlan(ExecutionPlan):
    """Single-device tick — `StreamEngine.tick` verbatim."""

    def tick(self, states, deltas):
        return self.engine.tick(states, deltas)

    def topk(self, scores, k):
        self._validate_k(k)
        vals, ids = torch.sort(scores, descending=True, stable=True)
        return vals[:k], ids[:k].to(torch.int32)


class PlanCache:
    """Warm pool of ready `ExecutionPlan`s for layout migrations.

    Keyed by the `ServiceConfig` fields a plan's tick depends on and the
    device. ``warm`` builds a plan for a predicted next config and warms
    it at the predicted layout; ``get`` is what `FingerService` swaps
    through: a hit returns the warm plan (popped: one migration
    consumes one warm plan), a miss builds a cold one. The lock covers
    the dict only, never a warm, so a background warming thread may
    insert while the serving thread pops.
    """

    def __init__(self):
        self._plans: Dict[tuple, Tuple[ExecutionPlan, Layout]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(config: ServiceConfig, device: torch.device) -> tuple:
        # Under the sparse method n_pad is the virtual addressing bound,
        # which no device tensor depends on, so a free virtual repad
        # between warm() and get() keeps a warm plan valid.
        n_pad = None if config.method == "sparse_tick" else config.n_pad
        return (config.batch_size, n_pad, config.k_pad, config.j_pad,
                config.n_slots, config.m_pad, config.method,
                config.exact_smax, config.placement, str(device))

    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    @property
    def warmed_layouts(self) -> Tuple[Layout, ...]:
        """The layouts held warm."""
        with self._lock:
            return tuple(layout for _, layout in self._plans.values())

    def warm(self, config: ServiceConfig, device: torch.device,
             layout: Layout,
             stream: Optional[torch.cuda.Stream] = None) -> ExecutionPlan:
        """Build a plan for ``config`` and warm it at ``layout``."""
        plan = build_plan(config, device)
        plan.warm_tick(layout, stream)
        with self._lock:
            self._plans[self._key(config, device)] = (plan, layout)
        return plan

    def get(self, config: ServiceConfig,
            device: torch.device) -> ExecutionPlan:
        """The plan to install for ``config``: the warm one if it was
        predicted, a cold `build_plan` otherwise."""
        with self._lock:
            hit = self._plans.pop(self._key(config, device), None)
        if hit is not None:
            cached = hit[0].config
            if config.method == "sparse_tick":
                # a plan warmed before a virtual repad: n_pad is
                # host-side only, so align it
                cached = cached.with_(n_pad=config.n_pad)
            if cached == config:
                hit[0].config = cached
                return hit[0]
        return build_plan(config, device)


def build_plan(config: ServiceConfig, device: torch.device) -> ExecutionPlan:
    """The plan of ``config.placement`` (only ``local`` is ported)."""
    config.validate(num_shards=1)
    return LocalPlan(config, device)
