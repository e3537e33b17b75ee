"""ServiceConfig: the one declarative description of a FINGER service.

The port's counterpart of `repro.serving.config`. It keeps every field
and every check of the reference, and rejects by name, as "not yet
ported", the one option whose code the port does not have:
``compilation_cache_dir``. The reference points JAX's persistent
compilation cache there, so that a restarted replica reads its compiled
ticks from disk. The port compiles nothing a layout at a time (its
kernels are built once per source), so there is no such cache to point
anywhere.

``ingestion`` defaults to ``"double_buffered"``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple, Union

PLACEMENTS = ("local", "sharded", "multipod")
INGESTIONS = ("sync", "double_buffered")
METHODS = ("dense", "compact", "fused_tick", "sparse_tick")

PrunePolicy = Union[int, Tuple, Callable[[List[int]], Any]]


class ServiceConfigError(ValueError):
    """A ServiceConfig field (or combination) is invalid, or names an
    option the port has not ported yet."""


def _not_yet_ported(what: str) -> ServiceConfigError:
    return ServiceConfigError(
        f"{what} is not yet ported to repro_torch; its kernels are built "
        "once per source, so there is no compilation cache to point "
        "anywhere")


def _validate_prune_policy(policy: PrunePolicy) -> None:
    """The accepted prune-policy forms of `repro.train.checkpoint`: an
    int k > 0, ('keep_last', k), ('keep_every_n', n, k), or a callable."""
    if callable(policy):
        return
    if isinstance(policy, int) and not isinstance(policy, bool):
        if policy <= 0:
            raise ServiceConfigError(
                f"prune policy: prune_policy keep_last={policy} must be "
                "positive")
        return
    if isinstance(policy, tuple) and policy:
        if policy[0] == "keep_last" and len(policy) == 2:
            return _validate_prune_policy(policy[1])
        if policy[0] == "keep_every_n" and len(policy) == 3:
            _, n, k = policy
            if not (isinstance(n, int) and n > 0):
                raise ServiceConfigError(
                    f"prune policy: keep_every_n period must be a "
                    f"positive int, got {n!r}")
            return _validate_prune_policy(k)
    raise ServiceConfigError(
        f"prune policy: unknown prune_policy {policy!r}; want an int, "
        "('keep_last', k), ('keep_every_n', n, k), or a callable")


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Where and how the stacked serving state persists
    (``directory=None``: the service is ephemeral)."""

    directory: Optional[str] = None
    prune: PrunePolicy = 3
    every_ticks: Optional[int] = None

    def validate(self) -> None:
        if self.every_ticks is not None and self.every_ticks <= 0:
            raise ServiceConfigError(
                f"CheckpointPolicy.every_ticks must be positive, got "
                f"{self.every_ticks}")
        if self.every_ticks is not None and self.directory is None:
            raise ServiceConfigError(
                "CheckpointPolicy.every_ticks set but directory is None; "
                "periodic saves need somewhere to go")
        _validate_prune_policy(self.prune)


@dataclasses.dataclass(frozen=True)
class PlanCachePolicy:
    """Knobs of the warm `serving.plans.PlanCache`: plans made ready for
    predicted next layouts, so that `repad`/`compact` swap without a
    cold first tick.

    ``enabled``       : migrations consult the cache at all.
    ``growth_factor`` : the predicted next grow target is
        ``round(n_pad * growth_factor)``.
    ``warm_compact``  : also warm the pending compaction target (the
        current live-slot count).
    """

    enabled: bool = True
    growth_factor: float = 2.0
    warm_compact: bool = True

    def validate(self) -> None:
        if self.growth_factor <= 1.0:
            raise ServiceConfigError(
                f"PlanCachePolicy.growth_factor must exceed 1.0 "
                f"(a grow prediction must grow), got "
                f"{self.growth_factor}")


@dataclasses.dataclass(frozen=True)
class TopKSpec:
    """Default width of `top_anomalies` queries."""

    k: int = 8

    def validate(self) -> None:
        if self.k <= 0:
            raise ServiceConfigError(f"TopKSpec.k must be positive, "
                                     f"got {self.k}")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Declarative FINGER serving configuration.

    Parameters
    ----------
    batch_size : number of concurrent streams B.
    n_pad : shared static node layout size.
    k_pad : delta-edge slots per stream per tick.
    j_pad : node join/leave slots per delta (None = no node slots).
    method : ``"dense"`` / ``"compact"`` Δ-statistics on the stacked
        tensors, ``"fused_tick"`` — one `stream_tick` kernel launch per
        tick — or ``"sparse_tick"`` — slot-space streams, one
        `sparse_tick` launch per tick. Under ``sparse_tick``, ``n_pad``
        is the virtual id bound the per-stream `SlotMap`s enforce on the
        host; no device tensor is sized by it.
    n_slots : sparse only — node-slot capacity per stream (device
        tensors are (B, n_slots); grown by `FingerService.grow_capacity`).
        Must be None for the dense methods.
    m_pad : sparse only — edge-store capacity per stream. Must be None
        for the dense methods.
    exact_smax : recompute s_max exactly after deletions.
    placement : ``"local"`` (one device), ``"sharded"`` (streams split
        over the ``data_axis`` of a `DeviceGrid`) or ``"multipod"``
        (over ``(pod_axis, data_axis)``; adds per-pod top-k queries).
    ingestion : ``"double_buffered"`` (default) — `ingest` starts the
        delta's copy to the device on a side stream, so it overlaps the
        tick in flight — or ``"sync"`` — deltas stay on the host until
        the tick that consumes them, and the copy to the device blocks
        (the baseline of an overlap measurement).
    max_queue : ingestion queue depth before `ingest` raises.
    checkpoint : CheckpointPolicy (directory, prune policy, cadence).
    topk : TopKSpec for `top_anomalies` queries.
    plan_cache : PlanCachePolicy for `FingerService.warm_next_layouts`.
    grace_generations : how many past migration generations keep an
        old→new remap for deltas stamped with an older layout; older
        ones raise `serving.ingest.GraceLapseError`. ``None`` keeps
        every journaled generation.
    compilation_cache_dir : must be None (see the module docstring).
    data_axis / pod_axis : the `DeviceGrid` axis names the sharded
        placements bind.
    """

    batch_size: int
    n_pad: int
    k_pad: int
    j_pad: Optional[int] = None
    n_slots: Optional[int] = None
    m_pad: Optional[int] = None
    method: str = "dense"
    exact_smax: bool = False
    placement: str = "local"
    ingestion: str = "double_buffered"
    max_queue: int = 2
    checkpoint: CheckpointPolicy = CheckpointPolicy()
    topk: TopKSpec = TopKSpec()
    plan_cache: PlanCachePolicy = PlanCachePolicy()
    grace_generations: Optional[int] = 3
    compilation_cache_dir: Optional[str] = None
    data_axis: str = "data"
    pod_axis: str = "pod"

    def validate(self, num_shards: Optional[int] = None) -> None:
        """Fail fast with a named error; ``num_shards`` adds the
        divisibility and top-k-width checks of a placement."""
        if self.batch_size <= 0:
            raise ServiceConfigError(
                f"batch_size must be positive, got {self.batch_size}")
        if self.n_pad <= 0:
            raise ServiceConfigError(
                f"n_pad must be positive, got {self.n_pad}")
        if self.k_pad <= 0:
            raise ServiceConfigError(
                f"k_pad must be positive, got {self.k_pad}")
        if self.j_pad is not None and self.j_pad <= 0:
            raise ServiceConfigError(
                f"j_pad must be positive (or None), got {self.j_pad}")
        if self.method not in METHODS:
            raise ServiceConfigError(
                f"method {self.method!r} not in {METHODS}")
        if self.method == "sparse_tick":
            if self.n_slots is None or self.n_slots <= 0:
                raise ServiceConfigError(
                    f"method='sparse_tick' needs a positive n_slots "
                    f"slot capacity, got {self.n_slots}")
            if self.m_pad is None or self.m_pad <= 0:
                raise ServiceConfigError(
                    f"method='sparse_tick' needs a positive m_pad "
                    f"edge-store capacity, got {self.m_pad}")
        elif self.n_slots is not None or self.m_pad is not None:
            raise ServiceConfigError(
                f"n_slots/m_pad are sparse-only capacities; "
                f"method={self.method!r} sizes its state by n_pad "
                f"alone (got n_slots={self.n_slots}, m_pad={self.m_pad})")
        if self.placement not in PLACEMENTS:
            raise ServiceConfigError(
                f"placement {self.placement!r} not in {PLACEMENTS}")
        if self.ingestion not in INGESTIONS:
            raise ServiceConfigError(
                f"ingestion {self.ingestion!r} not in {INGESTIONS}")
        if self.max_queue <= 0:
            raise ServiceConfigError(
                f"max_queue must be positive, got {self.max_queue}")
        if self.placement == "multipod" and self.pod_axis == self.data_axis:
            raise ServiceConfigError(
                f"multipod placement needs distinct pod/data axes, got "
                f"{self.pod_axis!r} for both")
        if self.grace_generations is not None \
                and self.grace_generations < 0:
            raise ServiceConfigError(
                f"grace_generations must be >= 0 (or None for "
                f"unbounded retention), got {self.grace_generations}")
        if self.compilation_cache_dir is not None:
            if not str(self.compilation_cache_dir).strip():
                raise ServiceConfigError(
                    "compilation_cache_dir must be a non-empty path "
                    "(or None)")
            raise _not_yet_ported("compilation_cache_dir")
        self.checkpoint.validate()
        self.topk.validate()
        self.plan_cache.validate()
        if num_shards is not None:
            if self.batch_size % num_shards != 0:
                raise ServiceConfigError(
                    f"batch_size={self.batch_size} must divide evenly "
                    f"over {num_shards} shard(s) of the "
                    f"{self.placement!r} placement")
            per_shard = self.batch_size // num_shards
            if self.topk.k > per_shard:
                raise ServiceConfigError(
                    f"topk.k={self.topk.k} exceeds the per-shard stream "
                    f"count {per_shard} (batch_size={self.batch_size} "
                    f"over {num_shards} shards); the sharded top-k "
                    f"merge needs k ≤ B/shards")

    def with_(self, **updates) -> "ServiceConfig":
        """`dataclasses.replace` spelled as a method (repad uses it)."""
        return dataclasses.replace(self, **updates)
