"""Pool-stacked shard ticks: one device launch per layout group per
fleet tick.

The port's counterpart of `repro.fleet.pooltick`. Shard by shard, a
fleet tick costs one launch per live shard, although every shard of a
pool runs the *same* tick over identically shaped (B, …) state. Here a
layout group of shards ticks as one launch: the per-shard states and
queued deltas are stacked along a leading shard axis into (S, B, ·)
tensors, advanced as one (S, B) tick, and each shard gets back its
(B,) score row and its state as views of the stacked result.

- ``"fused_tick"`` and ``"sparse_tick"`` groups make one launch of the
  stacked kernel (`kernels.stream_tick.ops.stream_tick_fused_stacked`,
  `kernels.sparse_tick.ops.sparse_tick_fused_stacked`, in place on the
  stacked copy). Each warp ticks one stream whatever the grid, so the
  stacked launch is bit-equal to S per-shard launches.
- ``"dense"`` and ``"compact"`` groups run the engine's batched tick
  over the S·B rows, reshaped — exact for the same reason the
  reference's outer shard `vmap` is: every op of the tick is per row.

There is nothing to compile: `pool_tick_fn` is a plain function, and
`warm_pool_tick` runs the stacked tick once on zero dummies at a
predicted grouping (the first use of its shapes: the kernel's load and
binding, the allocator's blocks), as `PlanCache.warm` does for a shard.

Stacking requires every shard of a group to share its tick: the same
`NodeLayout` (n_pad and generation), the same sparse capacity, the same
per-shard delta shapes. The fleet groups live shards by layout first
(`group_by_layout`); a mixed group raises `PoolGroupError`.
`group_fits` is the admission guard: a group whose S-stacked operands
exceed the residency budget (`kernels.dispatch.stacked_budget_bytes`),
or whose block does not fit the card's shared memory, ticks shard by
shard instead.

The shards' states are views of the last stacked result. That is safe
for the service's own in-place paths: a view of shard i is contiguous
and disjoint from every other shard's, `install_stream` /
`clear_stream` write into it, a migration (`repad`, `compact`,
`grow_capacity`) builds new tensors, and the next stacked tick copies
it into a new stacked buffer before anything writes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import torch

from repro_torch.engine.stream import StreamEngine
from repro_torch.fleet.errors import PoolGroupError
from repro_torch.kernels.dispatch import Device, resolve_device
from repro_torch.kernels.sparse_tick import ops as sp_ops
from repro_torch.kernels.stream_tick import ops as st_ops
from repro_torch.serving.plans import dummy_tick_args

#: Every serving method ticks as one stacked launch per layout group.
_STACKABLE_METHODS = ("dense", "compact", "fused_tick", "sparse_tick")


def stackable(method: str) -> bool:
    """True when ``method``'s pool can tick as one stacked launch."""
    return method in _STACKABLE_METHODS


def group_fits(configs: Sequence, device: Device = None) -> bool:
    """Whether one layout group is admissible as a single stacked launch
    on ``device`` (``None`` is CUDA).

    ``configs`` are the group members' live `ServiceConfig`s (len = S).
    Dense/compact groups always fit (their stacked operands are the
    same tensors the shard-by-shard path keeps resident). Kernel groups
    ask the kernel packages' stacked admission checks: a block's shared
    memory fits the card (stacking leaves it unchanged), and the whole
    S-stacked operand set fits `dispatch.stacked_budget_bytes()`. The
    fleet ticks a failing group shard by shard.
    """
    configs = list(configs)
    if not configs:
        return True
    cfg = configs[0]
    s = len(configs)
    if cfg.method == "fused_tick":
        return st_ops.fits_fused_tick_stacked(
            s, cfg.batch_size, cfg.n_pad, cfg.k_pad, cfg.j_pad,
            device=device)
    if cfg.method == "sparse_tick":
        return sp_ops.fits_sparse_tick_stacked(
            s, cfg.batch_size, cfg.n_slots, cfg.m_pad, cfg.k_pad,
            cfg.j_pad, device=device)
    return True


def stack_states(states_seq: Sequence):
    """S per-shard stacked (B, ·) states of one layout → one (S, B, ·)
    state (a new contiguous tensor a field)."""
    first = states_seq[0]
    for st in states_seq[1:]:
        if type(st) is not type(first) or st.layout != first.layout:
            raise PoolGroupError(
                f"stack_states: shard state {type(st).__name__}"
                f"(layout={st.layout}) does not share the group's "
                f"{type(first).__name__}(layout={first.layout}); group "
                "shards by layout before stacking")
    return dataclasses.replace(first, **{
        k: torch.stack([getattr(st, k) for st in states_seq])
        for k in first.tensors()})


def stack_deltas(deltas_seq: Sequence, device: torch.device):
    """S queued (B, k_pad) shard deltas → one (S, B, k_pad) delta on
    ``device``. Deltas held on the device (double buffering) are
    stacked there; host deltas (sync ingestion) are stacked on the host
    and copied once."""
    first = deltas_seq[0]
    for d in deltas_seq[1:]:
        if d.n_nodes != first.n_nodes \
                or d.tensors().keys() != first.tensors().keys():
            raise PoolGroupError(
                f"stack_deltas: a shard delta (n_nodes={d.n_nodes}, "
                f"fields={sorted(d.tensors())}) does not match the "
                f"group's (n_nodes={first.n_nodes}, "
                f"fields={sorted(first.tensors())})")

    def stack(name):
        ts = [getattr(d, name) for d in deltas_seq]
        if all(t.device == device for t in ts):
            return torch.stack(ts)
        return torch.stack([t.cpu() for t in ts]).to(device)

    return dataclasses.replace(first, layout_generation=None, **{
        k: stack(k) for k in first.tensors()})


def unstack(dists: torch.Tensor, new_states, s: int
            ) -> Tuple[tuple, tuple]:
    """The (S, B) scores and (S, B, ·) state → S per-shard (B,) rows and
    (B, ·) states, as views."""
    rows = tuple(dists[i] for i in range(s))
    states = tuple(new_states.map_tensors(lambda x, _i=i: x[_i])
                   for i in range(s))
    return rows, states


def stacked_body(exact_smax: bool, method: str) -> Callable:
    """The (S, B) tick of one method: ``(stacked, sdeltas) -> (dists,
    new_stacked)``, in place on ``stacked`` for the kernel methods."""
    if not stackable(method):
        raise ValueError(
            f"pool_tick_fn: method {method!r} is not stackable; gate "
            "with stackable() and fall back to per-shard poll()")
    if method == "fused_tick":
        return lambda st, d: st_ops.stream_tick_fused_stacked(
            st, d, exact_smax=exact_smax, inplace=True)
    if method == "sparse_tick":
        return lambda st, d: sp_ops.sparse_tick_fused_stacked(
            st, d, exact_smax=exact_smax, inplace=True)

    def body(stacked, sdeltas):
        s, b = stacked.q.shape
        engine = StreamEngine(exact_smax=exact_smax, method=method,
                              device=stacked.q.device)
        dist, new = engine.tick(
            stacked.map_tensors(lambda x: x.reshape(s * b, *x.shape[2:])),
            sdeltas.map_tensors(lambda x: x.reshape(s * b, *x.shape[2:])))
        return dist.reshape(s, b), new.map_tensors(
            lambda x: x.reshape(s, b, *x.shape[1:]))

    return body


def pool_tick_fn(exact_smax: bool, method: str) -> Callable:
    """The stacked pool tick of one engine config.

    Signature: ``(states_seq, deltas_seq) -> (dists, rows,
    shard_states)``: the inputs are same-length sequences of per-shard
    stacked (B, …) states and queued deltas sharing one layout;
    ``dists`` is the (S, B) score matrix on the device (the fleet's
    score plane), ``rows`` its S per-shard (B,) rows and
    ``shard_states`` the S updated per-shard states, views of the
    stacked result (see the module docstring).
    """
    body = stacked_body(exact_smax, method)

    def run(states_seq, deltas_seq):
        stacked = stack_states(states_seq)
        sdeltas = stack_deltas(deltas_seq, stacked.q.device)
        dists, new_states = body(stacked, sdeltas)
        rows, shard_states = unstack(dists, new_states, len(states_seq))
        return dists, rows, shard_states

    return run


def tick_pool(services: Sequence) -> torch.Tensor:
    """Advance one layout group of live shards as a single launch.

    ``services`` are `FingerService`s sharing one `ServiceConfig` shape
    and one current `NodeLayout` (and sparse capacity — the fleet
    groups by layout first). Each shard's queued stacked delta is
    popped as held (`begin_pool_tick`: on the device, ordered after its
    side-stream copy, under double buffering), the group runs through
    `pool_tick_fn`, and each shard absorbs its row and updated state
    (`finish_pool_tick`). Returns the (S, B) score matrix on the device
    in ``services`` order — the fleet's per-pool score plane.
    """
    svcs = list(services)
    first = svcs[0].config
    fn = pool_tick_fn(first.exact_smax, first.method)
    states = [svc.states() for svc in svcs]
    deltas = [svc.begin_pool_tick() for svc in svcs]
    dists, rows, shard_states = fn(states, deltas)
    for svc, row, st in zip(svcs, rows, shard_states):
        svc.finish_pool_tick(row, st)
    return dists


def warm_pool_tick(entries: Sequence[Tuple[object, object]],
                   device: Device = None) -> None:
    """Run the stacked tick once for one predicted shard grouping on
    ``device`` (``None`` is CUDA).

    ``entries`` is the group as (ServiceConfig, layout) pairs — a
    `NodeLayout` for the dense methods, a `SparseLayout` capacity for
    ``"sparse_tick"`` — the same prediction surface `PlanCache.warm`
    uses. Runs the stacked tick on zero dummies and waits for it.

    Every entry must share one tick method: a stacked launch runs ONE
    body, so a mixed-method entry list cannot be a real group — it
    raises `PoolGroupError` by name. A group failing `group_fits` is
    skipped (the fleet ticks it shard by shard).
    """
    entries = list(entries)
    if not entries:
        return
    methods = sorted({cfg.method for cfg, _ in entries})
    if len(methods) > 1:
        raise PoolGroupError(
            f"warm_pool_tick: mixed-method entry list {methods} — a "
            "stacked launch runs one tick body; group shards by pool "
            "(method) before warming")
    device = resolve_device(device)
    first = entries[0][0]
    if not stackable(first.method):
        return
    if not group_fits([cfg for cfg, _ in entries], device=device):
        return
    fn = pool_tick_fn(first.exact_smax, first.method)
    args = [dummy_tick_args(cfg, layout, device) for cfg, layout in entries]
    fn([a[0] for a in args], [a[1] for a in args])
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def group_by_layout(services: Sequence) -> List[List]:
    """Split a pool's live shards into stackable layout groups.

    Shards of one pool share a `ServiceConfig` at open time, but
    compaction gives individual shards private layouts (smaller n_pad,
    bumped generation) — those tick in their own (possibly singleton)
    group. Sparse shards additionally key on their live `SparseLayout`
    capacity (n_slots, m_pad, generation): a shard whose capacity grew
    (`grow_capacity`) no longer stacks with its siblings. Order within
    each group follows ``services`` order, and group order follows
    first appearance, so the fleet's shard→row bookkeeping is
    deterministic.
    """
    groups: dict = {}
    for svc in services:
        key = (svc.layout, svc.config.n_pad, svc.capacity)
        groups.setdefault(key, []).append(svc)
    return list(groups.values())
