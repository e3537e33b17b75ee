"""Tick auditor: forbidden work in the serving tick and the migrations.

The port's counterpart of `repro.analysis.hlo_audit`. The reference
audits the optimized HLO of every compiled tick; the port has no HLO, so
this audits what one tick of a warmed plan does, op by op: it runs the
tick on zero-filled state and delta of the plan's own shapes under a
recording `TorchDispatchMode`, the wrappers' launch counters, a spy on
``torch.distributed`` and, on the card, `sanitize.no_transfers`. The
rules, mapped from the reference's:

- ``host-transfer-in-tick`` — no host materialization and, on the card,
  no device sync inside the tick;
- ``not-in-place`` — the counterpart of ``missing-donation``: every
  stacked-state tensor keeps its ``data_ptr()`` across the tick (the
  engine's contract: `StreamEngine.tick` updates the state in place
  under ``fused_tick`` and ``sparse_tick``); an out-of-place tick would
  keep two copies of the stacked state on the card. Migrations are
  exempt: every tensor changes shape there;
- ``unexpected-collective`` — no ``torch.distributed`` call and no c10d
  op inside a tick: the streams are independent, and cross-shard work
  belongs in the top-k query;
- ``dtype-upcast`` — no op makes a float64 or complex tensor (the
  serving stack is float32/int32 end to end);
- ``launch-count`` — exactly one kernel launch a shard on the card and
  none on the CPU (where the wrappers run their plain versions); a
  migration transform launches no kernel.

`audit_plan_tick` covers one (placement, method): ``local``,
``sharded`` over 4 logical shards and ``multipod`` over 2 × 2, for
``fused_tick`` and ``sparse_tick``; `audit_migrations` covers the grow,
compact and truncate transforms of `serving.migrate` and the sparse
`grow_sparse_stacked`. `audit_repo` runs both at the reference's small
shapes and, on the card, at ``chip_smoke.py``'s phase 3 and phase 5
shapes too.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.sanitize import (TransferBudgetExceeded,
                                           host_materialization,
                                           launch_counts, no_transfers)
from repro_torch.core.sparse import SparseLayout, SparseStreamState
from repro_torch.core.state import FingerState
from repro_torch.distributed.sharding import Sharded, make_grid
from repro_torch.graphs.layout import NodeLayout
from repro_torch.kernels import dispatch
from repro_torch.serving.config import ServiceConfig, TopKSpec

PLACEMENTS = ("local", "sharded", "multipod")
METHODS = ("fused_tick", "sparse_tick")
SHARDS, PODS = 4, (2, 2)
KERNEL = {"fused_tick": "stream_tick", "sparse_tick": "sparse_tick"}
_UPCAST = (torch.float64, torch.complex64, torch.complex128)
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter", "reduce_scatter_tensor", "broadcast",
                "reduce", "all_to_all", "all_to_all_single", "scatter",
                "gather", "send", "recv", "isend", "irecv", "barrier")
# (label, batch_size, n_pad, k_pad, j_pad, n_slots, m_pad) of an audit
# by method: the reference's small shapes (two streams a shard, n_pad
# 16, k_pad 3; the sparse tick over a 2^20-id virtual space), and on the
# card chip_smoke.py's phase 3 (dense) and phase 5 (sparse) shapes
SHAPES = {"fused_tick": (("small", 8, 16, 3, None, None, None),),
          "sparse_tick": (("small", 8, 1 << 20, 3, None, 16, 32),)}
CARD_SHAPES = {"fused_tick": (("phase 3", 32768, 1024, 128, 8, None, None),),
               "sparse_tick": (("phase 5", 1024, 1 << 20, 128, 8, 1024,
                                8192),)}


@dataclasses.dataclass
class AuditViolation:
    rule: str
    target: str
    message: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TargetAudit:
    """Audit result for one tick or migration transform."""
    target: str
    placement: Optional[str]
    shards: int
    launches: Dict[str, int]
    host_transfers: List[str]
    collectives: List[str]
    upcasts: List[str]
    moved: List[str]
    violations: List[AuditViolation]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict[str, Any]:
        return dict(dataclasses.asdict(self), ok=self.ok)


@dataclasses.dataclass
class AuditReport:
    targets: List[TargetAudit]

    @property
    def violations(self) -> List[AuditViolation]:
        return [v for t in self.targets for v in t.violations]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> Dict[str, Any]:
        return {"ok": self.ok,
                "targets": [t.to_dict() for t in self.targets]}


class _Recorder(TorchDispatchMode):
    """Records host materializations, float64/complex outputs and c10d
    ops of every aten op in the block."""

    def __init__(self):
        super().__init__()
        self.transfers: List[str] = []
        self.upcasts: List[str] = []
        self.collectives: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = host_materialization(func, args, kwargs)
        if op is not None:
            self.transfers.append(op)
        if "c10d" in func.namespace:
            self.collectives.append(f"{func.namespace}.{func.__name__}")
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype in _UPCAST:
                self.upcasts.append(f"aten.{func.__name__} -> {t.dtype}")
        return out


@contextlib.contextmanager
def _collective_spy(calls: List[str]) -> Iterator[None]:
    """Count every ``torch.distributed`` collective called in the block."""
    dist = torch.distributed
    saved = {n: getattr(dist, n) for n in _COLLECTIVES if hasattr(dist, n)}

    def spy(name, fn):
        def call(*args, **kwargs):
            calls.append(f"torch.distributed.{name}")
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, spy(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _watched(target: str, device: torch.device, fn):
    """Run ``fn()`` under the recorder, the collective spy, the launch
    counters and, on the card, `no_transfers`: (result or None, launches,
    recorder, collectives, host transfers and syncs)."""
    rec, calls, refused = _Recorder(), [], []
    _sync(device)
    before = launch_counts()
    guard = no_transfers(device, target) if device.type == "cuda" \
        else contextlib.nullcontext()
    result = None
    try:
        with guard, _collective_spy(calls), rec:
            result = fn()
    except TransferBudgetExceeded as exc:
        refused.append(str(exc))
    except RuntimeError as exc:  # set_sync_debug_mode("error") refused
        if "synchroniz" not in str(exc):
            raise
        refused.append(f"a device sync: {exc}")
    _sync(device)
    after = launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    # on the card the refusal names the op the recorder saw too
    transfers = refused or rec.transfers
    return result, launches, rec, calls, transfers


def _common_rules(target: str, rec: _Recorder, calls: List[str],
                  transfers: List[str]) -> List[AuditViolation]:
    out = [AuditViolation("host-transfer-in-tick", target,
                          f"{t} — the tick must stay on the device")
           for t in transfers]
    out += [AuditViolation("unexpected-collective", target,
                           f"{c} inside the tick — the streams are "
                           "independent; collectives belong in the query "
                           "path") for c in rec.collectives + calls]
    out += [AuditViolation("dtype-upcast", target,
                           f"{u} — the serving stack is float32/int32 end "
                           "to end") for u in rec.upcasts]
    return out


def _parts(states) -> list:
    return list(states.parts) if isinstance(states, Sharded) else [states]


def _pointers(states) -> Dict[str, int]:
    return {f"shard {i} {name}": t.data_ptr()
            for i, part in enumerate(_parts(states))
            for name, t in part.tensors().items()}


def service_config(placement: str, method: str,
                   shape: Optional[tuple] = None) -> ServiceConfig:
    """The audit's config of one (placement, method) at ``shape`` (an
    entry of ``SHAPES`` or ``CARD_SHAPES``; the small one by default)."""
    _, b, n_pad, k_pad, j_pad, n_slots, m_pad = shape or SHAPES[method][0]
    return ServiceConfig(batch_size=b, n_pad=n_pad, k_pad=k_pad,
                         j_pad=j_pad, method=method, n_slots=n_slots,
                         m_pad=m_pad, placement=placement, ingestion="sync",
                         topk=TopKSpec(k=2))


def where_for(placement: str, device: torch.device):
    """The device, or the grid of logical shards on it, of a placement."""
    if placement == "local":
        return device
    if placement == "sharded":
        return make_grid((SHARDS,), ("data",), device)
    return make_grid(PODS, ("pod", "data"), device)


def _layout(config: ServiceConfig):
    if config.method == "sparse_tick":
        return SparseLayout(n_slots=config.n_slots, m_pad=config.m_pad)
    return NodeLayout(n_pad=config.n_pad, generation=0)


def audit_plan_tick(config: ServiceConfig, where, plan=None,
                    label: str = "") -> TargetAudit:
    """Warm ``config``'s plan on ``where`` (a device or a `DeviceGrid`),
    then audit one tick of it on zero-filled state and delta of its
    shapes. ``plan`` audits a plan built by the caller instead."""
    from repro_torch.serving.plans import build_plan

    plan = build_plan(config, where) if plan is None else plan
    layout = _layout(config)
    target = f"{config.method}[{config.placement}]" + \
        (f" {label}" if label else "")
    plan.warm_tick(layout)
    states, deltas = plan._dummies(layout)
    before = _pointers(states)
    out, launches, rec, calls, transfers = _watched(
        target, plan.device, lambda: plan.tick(states, deltas))
    violations = _common_rules(target, rec, calls, transfers)
    moved = []
    if out is not None:
        after = _pointers(out[1])
        moved = sorted(k for k in before if after.get(k) != before[k])
        violations += [AuditViolation(
            "not-in-place", target,
            f"{k} has a new data_ptr after the tick — the tick must update "
            "the stacked state in place (two copies of it would be live)")
            for k in moved]
    kernel, shards = KERNEL[config.method], plan.num_shards
    want = {kernel: shards} if plan.device.type == "cuda" else {}
    if launches != want:
        violations.append(AuditViolation(
            "launch-count", target,
            f"launches {launches or '{}'} — expected {want or 'none'}: one "
            f"{kernel} launch a shard on the card, none on the CPU"))
    return TargetAudit(target, config.placement, shards, launches,
                       transfers, rec.collectives + calls, rec.upcasts,
                       moved, violations)


def _zero_states(b: int, n_pad: int, device: torch.device,
                 live: int) -> FingerState:
    """A stacked zero state whose first ``live`` slots are live."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    mask = z(b, n_pad)
    mask[:, :live] = 1.0
    return FingerState(q=z(b), s_total=z(b), s_max=z(b),
                       strengths=z(b, n_pad), node_mask=mask,
                       layout=NodeLayout(n_pad=n_pad, generation=0))


def audit_migrations(device: dispatch.Device = None, n_pad: int = 16,
                     batch_size: int = 4) -> List[TargetAudit]:
    """Audit the device-side migration transforms (grow / compact /
    truncate, and the sparse capacity growth): no host transfer, no
    collective, no upcast, no kernel launch. Not in place by nature."""
    from repro_torch.serving import migrate

    dev = dispatch.resolve_device(device)
    small = _zero_states(batch_size, n_pad, dev, n_pad // 2)
    big = _zero_states(batch_size, 2 * n_pad, dev, n_pad // 2)
    grown, shrunk = NodeLayout(2 * n_pad, 1), NodeLayout(n_pad, 1)
    cap = SparseLayout(n_slots=n_pad, m_pad=2 * n_pad)
    sparse = SparseStreamState(
        q=small.q, s_total=small.s_total, s_max=small.s_max,
        strengths=small.strengths, node_mask=small.node_mask,
        edge_weights=torch.zeros((batch_size, 2 * n_pad), device=dev),
        layout=cap)
    transforms = {
        "migrate.grow": lambda: migrate.grow_stacked(small, grown),
        "migrate.compact": lambda: migrate.compact_stacked_auto(big, shrunk),
        "migrate.truncate": lambda: migrate.truncate_stacked(big, shrunk),
        "migrate.grow_sparse": lambda: migrate.grow_sparse_stacked(
            sparse, cap.grown(n_slots=2 * n_pad, m_pad=4 * n_pad)),
    }
    targets = []
    for name, fn in transforms.items():
        _, launches, rec, calls, transfers = _watched(name, dev, fn)
        violations = _common_rules(name, rec, calls, transfers)
        if launches:
            violations.append(AuditViolation(
                "launch-count", name,
                f"launches {launches} — a migration transform launches no "
                "kernel"))
        targets.append(TargetAudit(name, None, 1, launches, transfers,
                                   rec.collectives + calls, rec.upcasts, [],
                                   violations))
    return targets


def audit_repo(device: dispatch.Device = None) -> AuditReport:
    """Every placement's tick for both kernel methods at the small
    shapes (and on the card at phase 3's and phase 5's), then the
    migration transforms."""
    dev = dispatch.resolve_device(device)
    targets: List[TargetAudit] = []
    for method in METHODS:
        shapes = SHAPES[method] + (CARD_SHAPES[method]
                                   if dev.type == "cuda" else ())
        for shape in shapes:
            for placement in PLACEMENTS:
                config = service_config(placement, method, shape)
                targets.append(audit_plan_tick(
                    config, where_for(placement, dev), label=shape[0]))
    targets.extend(audit_migrations(dev))
    return AuditReport(targets)
