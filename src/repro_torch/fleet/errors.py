"""Named exceptions of the multi-tenant fleet layer.

The port's copy of `repro.fleet.errors`, the same class tree. Every
failure mode a fleet caller can hit has a class here, exported by name
from `repro_torch.fleet` (a discovery test guards it): fleet operators
branch on exception identity, never on message text.
"""
from __future__ import annotations


class FleetError(RuntimeError):
    """Base class of every fleet-layer error."""


class FleetConfigError(FleetError, ValueError):
    """A `FleetConfig`/`PoolSpec` field (or combination) is invalid, or
    names an option the port refuses.

    Raised at `validate()` / `FingerFleet.open` time, before any shard
    service exists.
    """


class AdmissionError(FleetError):
    """No pool can host the tenant: every bucket whose ``n_pad`` covers
    the tenant's node space is full (or none is large enough). Raised
    by `FleetRouter.place` — admission control, not a crash."""


class UnknownTenantError(FleetError, KeyError):
    """The named tenant is not in the fleet's directory."""


class FleetLifecycleError(FleetError):
    """A fleet method was called out of phase: on a closed fleet, or an
    operation that needs the ingest/poll cycle quiesced (admission,
    migration, kill/recover, save) while a staged tick is pending."""


class ShardUnavailableError(FleetError):
    """The addressed shard is dead (killed and not yet recovered) or
    outside the pool's shard range."""


class RebalanceError(FleetError):
    """A live tenant migration (promotion / shard rebalance) cannot be
    performed — e.g. promoting a tenant into a pool that cannot hold
    its node space, or rebalancing against a staged tick."""


class PoolGroupError(FleetError, ValueError):
    """A pool-stacked tick group mixes incompatible shards: the entries
    handed to one stacked warm or launch disagree on their tick method
    or layout. Shards of one stacked launch share one tick body and one
    layout — group by pool (and layout/capacity) before stacking."""


class RecoveryError(FleetError):
    """Shard-failure recovery cannot restore a tenant: no surviving
    shard fits it, or neither an in-memory base nor an on-disk
    checkpoint covers its state."""


class FleetIngestError(FleetError, ValueError):
    """A tenant delta cannot be translated onto its shard: an edge
    touches a node the tenant never joined, a join overflows the
    pool's ``j_pad`` lanes, or the pool carries no join slots at all."""
