"""Declarative fleet topology: bucketed pools of FINGER serving shards.

The port's counterpart of `repro.fleet.config`, with the same fields,
checks and error texts. A `FleetConfig` is to `FingerFleet` what
`ServiceConfig` is to `FingerService`: one frozen description of every
static decision — how many pools (buckets), each bucket's node-space
size and method, how many shards per bucket, how many tenant stream
slots per shard — validated up front with named errors. Everything
dynamic (which tenant lives where) lives in the `TenantDirectory`.

Bucket sizing rule: pools are ordered by strictly ascending ``n_pad``;
a tenant is admitted into the smallest bucket whose ``n_pad`` covers
its node space (best fit, spilling upward when a bucket is full), and
is *promoted* to the next bucket when it outgrows its current one.

``compilation_cache_dir`` forwards to every shard's `ServiceConfig`,
which refuses it by name in the port (it compiles nothing per layout);
`FleetConfig.validate` surfaces that refusal as a `FleetConfigError`
naming the option.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from repro_torch.fleet.errors import FleetConfigError
from repro_torch.serving.config import (CheckpointPolicy, ServiceConfig,
                                        ServiceConfigError, TopKSpec)

# Per-shard top-k candidate width: the fleet merge never needs more
# than min(this, streams_per_shard) rows from any one shard.
_TOPK_DEFAULT = 8


@dataclasses.dataclass(frozen=True)
class PoolSpec:
    """One bucket: N identical `FingerService` shards of one layout.

    ``n_pad`` is the bucket's node-space bound — the largest tenant the
    bucket admits (for ``method="sparse_tick"`` it is the *virtual*
    bound; the device capacities are ``n_slots``/``m_pad``).
    """

    name: str
    n_pad: int
    shards: int = 1
    streams_per_shard: int = 4
    k_pad: int = 8
    j_pad: Optional[int] = None
    method: str = "dense"
    n_slots: Optional[int] = None
    m_pad: Optional[int] = None
    exact_smax: bool = False

    def validate(self) -> None:
        if not self.name or not str(self.name).strip():
            raise FleetConfigError("PoolSpec.name must be non-empty")
        if self.shards <= 0:
            raise FleetConfigError(
                f"pool {self.name!r}: shards must be positive, got "
                f"{self.shards}")
        # Everything else is a ServiceConfig constraint — validate the
        # exact config the shards will open with, so a bad pool fails
        # here with the serving layer's own named diagnostics.
        try:
            self.service_config().validate(num_shards=1)
        except ServiceConfigError as e:
            raise FleetConfigError(f"pool {self.name!r}: {e}") from e

    def service_config(self, fleet_dir: Optional[str] = None,
                       shard: int = 0,
                       compilation_cache_dir: Optional[str] = None,
                       ) -> ServiceConfig:
        """The `ServiceConfig` of one shard of this pool.

        Shards of a persistent fleet checkpoint under
        ``<fleet_dir>/<pool>/shard<i>`` — the serving layer's checkpoint
        format, which both packages read (dense shards with the layout
        journal, sparse shards with their per-stream SlotMaps in the
        manifest).
        """
        ckpt = CheckpointPolicy()
        if fleet_dir is not None:
            ckpt = CheckpointPolicy(directory=os.path.join(
                str(fleet_dir), self.name, f"shard{int(shard)}"))
        return ServiceConfig(
            batch_size=self.streams_per_shard,
            n_pad=self.n_pad, k_pad=self.k_pad, j_pad=self.j_pad,
            n_slots=self.n_slots, m_pad=self.m_pad,
            method=self.method, exact_smax=self.exact_smax,
            placement="local",
            topk=TopKSpec(k=min(_TOPK_DEFAULT, self.streams_per_shard)),
            checkpoint=ckpt,
            compilation_cache_dir=compilation_cache_dir)

    @property
    def capacity(self) -> int:
        """Tenant stream slots in the whole pool."""
        return self.shards * self.streams_per_shard


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """The whole fleet: ordered buckets + fleet-wide policies.

    ``directory`` roots the fleet's persistence (per-shard serving
    checkpoints + the ``fleet.json`` tenant manifest); every method
    persists — sparse shards serialize their per-stream SlotMaps into
    the shard checkpoint manifest, and the fleet manifest records each
    sparse shard's live slot capacities.
    ``compact_occupancy`` drives the rebalancer's auto-compaction: a
    dense shard whose live-slot occupancy falls below it is compacted
    to its live count.
    ``compilation_cache_dir`` must be None (see the module docstring).
    """

    pools: Tuple[PoolSpec, ...]
    directory: Optional[str] = None
    compact_occupancy: float = 0.5
    save_every_ticks: Optional[int] = None
    compilation_cache_dir: Optional[str] = None
    # Steady-state tick path: True advances each pool's live shards —
    # every method — as ONE stacked launch per layout group
    # (`fleet.pooltick`) and leaves the per-pool (S, B) score matrix on
    # the device for the score plane; False ticks shard by shard with
    # each shard's `poll()` (the parity baseline and the bench's
    # comparator). A group whose S-stacked operands exceed the
    # residency budget ticks shard by shard regardless
    # (`pooltick.group_fits`).
    stacked_ticks: bool = True
    # WAL growth cap: prune per-tenant WAL entries older than
    # ``fleet_step - wal_retention_ticks`` at ingest time. Entries at
    # or before the tenant's durable base are free to drop; pruning
    # *past* the base advances the tenant's `wal_floor`, and a later
    # `recover()` that needs the truncated range raises RecoveryError
    # by name. None = unbounded (pruned only by save()).
    wal_retention_ticks: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "pools", tuple(self.pools))

    def validate(self) -> None:
        if not self.pools:
            raise FleetConfigError("FleetConfig needs at least one pool")
        names = [p.name for p in self.pools]
        if len(set(names)) != len(names):
            raise FleetConfigError(
                f"pool names must be unique, got {names}")
        sizes = [p.n_pad for p in self.pools]
        if any(b <= a for a, b in zip(sizes, sizes[1:])):
            raise FleetConfigError(
                f"pools must be ordered by strictly ascending n_pad "
                f"(the bucket ladder), got {sizes}")
        for p in self.pools:
            p.validate()
        if self.compilation_cache_dir is not None:
            try:
                self.pools[0].service_config(
                    compilation_cache_dir=self.compilation_cache_dir
                ).validate(num_shards=1)
            except ServiceConfigError as e:
                raise FleetConfigError(
                    f"compilation_cache_dir: {e}") from e
        if not 0.0 < self.compact_occupancy <= 1.0:
            raise FleetConfigError(
                f"compact_occupancy must be in (0, 1], got "
                f"{self.compact_occupancy}")
        if self.save_every_ticks is not None:
            if self.save_every_ticks <= 0:
                raise FleetConfigError(
                    f"save_every_ticks must be positive, got "
                    f"{self.save_every_ticks}")
            if self.directory is None:
                raise FleetConfigError(
                    "save_every_ticks set but directory is None; "
                    "periodic fleet saves need somewhere to go")
        if self.wal_retention_ticks is not None \
                and self.wal_retention_ticks <= 0:
            raise FleetConfigError(
                f"wal_retention_ticks must be positive (None = "
                f"unbounded), got {self.wal_retention_ticks}")

    def pool_index(self, name: str) -> int:
        for i, p in enumerate(self.pools):
            if p.name == name:
                return i
        raise FleetConfigError(
            f"no pool named {name!r} "
            f"(have {[p.name for p in self.pools]})")
