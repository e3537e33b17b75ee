"""ExecutionPlan: how one ServiceConfig ticks and answers queries.

The port's counterpart of `repro.serving.plans`, for the local
placement only: `LocalPlan` runs the `StreamEngine` tick on one device
— on a stacked `FingerState`, or on a stacked `SparseStreamState` under
``method="sparse_tick"`` — and answers global top-k queries. The
sharded and multipod plans and the warm `PlanCache` are not yet ported.

Top-k order. `top_anomalies` sorts the scores with a stable descending
sort and keeps the first k, which gives `jax.lax.top_k`'s order on ties
(the lower stream id first). Unchanged streams score exactly 0, so ties
are common.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.core.sparse import SparseStreamState
from repro_torch.core.state import FingerState
from repro_torch.engine.stream import StreamEngine
from repro_torch.graphs.types import GraphDelta
from repro_torch.serving.config import ServiceConfig, ServiceConfigError


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


def build_plan(config: ServiceConfig, device: torch.device) -> ExecutionPlan:
    """The plan of ``config.placement`` (only ``local`` is ported)."""
    config.validate(num_shards=1)
    return LocalPlan(config, device)
