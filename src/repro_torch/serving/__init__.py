"""repro_torch.serving: declarative FINGER stream serving.

`ServiceConfig` states the serving decisions once, `FingerService.open`
(or `restore`) builds its plan and stacked state, and `ingest`/`poll`/
`scores`/`top_anomalies`/`save`/`close` run the lifecycle, on dense or
sparse (``method="sparse_tick"``) streams, with double-buffered or
synchronous ingestion. `repad`, `compact` and `grow_capacity` migrate
the layout while serving, through the warm `PlanCache` of
`warm_next_layouts`. The local placement runs on one device; the
sharded and multipod placements split the streams over a
`distributed.DeviceGrid` under one controller.
"""
from repro_torch.serving.config import (
    CheckpointPolicy,
    PlanCachePolicy,
    ServiceConfig,
    ServiceConfigError,
    TopKSpec,
)
from repro_torch.serving.ingest import GraceLapseError, IngestError
from repro_torch.serving.migrate import CompactionReport, LayoutMigrationError
from repro_torch.serving.plans import (
    ExecutionPlan,
    LocalPlan,
    MultiPodPlan,
    PlanCache,
    ShardedPlan,
    build_plan,
)
from repro_torch.serving.service import (
    FingerService,
    ServiceLifecycleError,
    TickReport,
    WarmupHandle,
)

__all__ = [
    "CheckpointPolicy", "CompactionReport", "ExecutionPlan",
    "FingerService", "GraceLapseError", "IngestError",
    "LayoutMigrationError", "LocalPlan", "MultiPodPlan", "PlanCache",
    "PlanCachePolicy", "ServiceConfig", "ServiceConfigError",
    "ServiceLifecycleError", "ShardedPlan",
    "TickReport", "TopKSpec", "WarmupHandle", "build_plan",
]
