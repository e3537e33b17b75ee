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

Not yet ported: save/restore, the layout migrations (`repad`,
`compact`, grace remaps), warm plan caches and the fleet hooks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.state import FingerState
from repro_torch.engine.stream import StreamEngine, stack_deltas
from repro_torch.graphs.layout import NodeLayout
from repro_torch.graphs.types import GraphDelta
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.serving.config import ServiceConfig, ServiceConfigError
from repro_torch.serving.ingest import SyncIngestor
from repro_torch.serving.plans import ExecutionPlan, build_plan


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
                 states: FingerState, step: int = 0):
        self._config = config
        self._plan = plan
        self._states = states
        self._step = step
        self._layout = states.layout if states.layout is not None \
            else NodeLayout(config.n_pad)
        if self._layout.n_pad != config.n_pad:
            raise ServiceConfigError(
                f"FingerService: state layout n_pad={self._layout.n_pad} "
                f"!= config.n_pad={config.n_pad}")
        self._ingestor = SyncIngestor(config, plan.device,
                                      generation=self._layout.generation)
        self._last_scores: Optional[torch.Tensor] = None
        self._closed = False

    @classmethod
    def open(cls, config: ServiceConfig, graphs: Sequence,
             device: Device = None) -> "FingerService":
        """Validate the config, build its plan, and place the initial
        stacked state from B host graphs (`DenseGraph` or `EdgeList`)
        on ``device`` (``None`` is CUDA)."""
        config.validate()
        device = resolve_device(device)
        graphs = list(graphs)
        if len(graphs) != config.batch_size:
            raise ServiceConfigError(
                f"open: {len(graphs)} graph(s) != config.batch_size="
                f"{config.batch_size}")
        too_big = [g.n_nodes for g in graphs if g.n_nodes > config.n_pad]
        if too_big:
            raise ServiceConfigError(
                f"open: graph node count(s) {sorted(set(too_big))} "
                f"exceed config.n_pad={config.n_pad}; open with a "
                "larger n_pad")
        plan = build_plan(config, device)
        states = StreamEngine.init_states(graphs, n_pad=config.n_pad,
                                          device=device)
        return cls(config, plan, states)

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
        return self._layout

    @property
    def pending(self) -> int:
        """Ingested ticks not yet consumed by `poll`."""
        return len(self._ingestor)

    def states(self) -> FingerState:
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
        a list of B per-stream deltas to stack."""
        self._check_open("ingest")
        if not isinstance(deltas, GraphDelta):
            deltas = stack_deltas(list(deltas))
        self._ingestor.put(deltas)

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
