"""repro_torch.fleet — the multi-tenant FINGER serving fleet.

The port's counterpart of `repro.fleet`, with the same modules and
public names: bucketed shard pools (`FleetConfig`/`PoolSpec`), best-fit
tenant routing (`FleetRouter`), live cross-shard migration
(`Rebalancer`), shard-failure recovery (`recovery`), whole-fleet
persistence read by both packages, and the pool-stacked tick
(`pooltick`: one launch of the stacked `stream_tick` / `sparse_tick`
kernel per layout group) — all on top of `repro_torch.serving`'s
`FingerService`. Every failure mode has a named exception exported
here.
"""
from repro_torch.fleet.config import FleetConfig, PoolSpec
from repro_torch.fleet.directory import TenantDirectory, TenantEntry
from repro_torch.fleet.errors import (AdmissionError, FleetConfigError,
                                      FleetError, FleetIngestError,
                                      FleetLifecycleError, PoolGroupError,
                                      RebalanceError, RecoveryError,
                                      ShardUnavailableError,
                                      UnknownTenantError)
from repro_torch.fleet.fleet import FingerFleet
from repro_torch.fleet.rebalance import Rebalancer
from repro_torch.fleet.recovery import DeadShard, recover_shard, replay_tenant
from repro_torch.fleet.router import FleetRouter

__all__ = [
    "AdmissionError",
    "DeadShard",
    "FingerFleet",
    "FleetConfig",
    "FleetConfigError",
    "FleetError",
    "FleetIngestError",
    "FleetLifecycleError",
    "FleetRouter",
    "PoolGroupError",
    "PoolSpec",
    "Rebalancer",
    "RebalanceError",
    "RecoveryError",
    "ShardUnavailableError",
    "TenantDirectory",
    "TenantEntry",
    "UnknownTenantError",
    "recover_shard",
    "replay_tenant",
]
