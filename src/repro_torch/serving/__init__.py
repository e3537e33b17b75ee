"""repro_torch.serving: declarative FINGER stream serving on one device.

`ServiceConfig` states the serving decisions once, `FingerService.open`
builds its plan and stacked state, and `ingest`/`poll`/`scores`/
`top_anomalies`/`close` run the lifecycle, on dense or sparse
(``method="sparse_tick"``) streams; `grow_capacity` and the virtual
`repad` migrate a sparse service. Only the local placement with
synchronous ingestion is ported so far.
"""
from repro_torch.serving.config import (
    CheckpointPolicy,
    ServiceConfig,
    ServiceConfigError,
    TopKSpec,
)
from repro_torch.serving.ingest import IngestError
from repro_torch.serving.migrate import LayoutMigrationError
from repro_torch.serving.plans import ExecutionPlan, LocalPlan, build_plan
from repro_torch.serving.service import (
    FingerService,
    ServiceLifecycleError,
    TickReport,
)

__all__ = [
    "CheckpointPolicy", "ExecutionPlan", "FingerService", "IngestError",
    "LayoutMigrationError", "LocalPlan", "ServiceConfig",
    "ServiceConfigError",
    "ServiceLifecycleError", "TickReport", "TopKSpec", "build_plan",
]
