"""Runtime sanitizers: host-transfer budgets, first-use budgets, NaN mode.

The port's counterpart of `repro.analysis.sanitize`: reusable context
managers for the invariants the serving stack's speed rests on, in
place of the checks the tests used to write out by hand.

- `transfer_budget(n)` — a device→host materialization sentinel. A
  `TorchDispatchMode` counts every ``aten._local_scalar_dense`` (the op
  behind ``.item()``, ``float(t)``, ``int(t)``, ``bool(t)`` and indexing
  with a 0-dim tensor) and every copy from a CUDA tensor into a CPU one
  (``aten._to_copy`` to the CPU, ``copy_`` into a CPU tensor), and
  raises `TransferBudgetExceeded` past ``n`` — e.g. "`fleet.scores()`
  pulls at most one score plane a pool".
- `no_transfers()` — the hot-path contract: the dispatch mode refuses
  the first host materialization by the name of its op, and on the card
  the block also runs under ``torch.cuda.set_sync_debug_mode("error")``,
  which refuses an implicit device sync (a data-dependent shape, a
  blocking copy).
- `first_use_budget(n)` — the counterpart of the reference's
  ``compile_budget``. The port compiles nothing a layout at a time; its
  first-use costs are what `serving.plans.PlanCache.warm` pays ahead of
  time: a cold `serving.plans.build_plan`, a load of the kernel
  libraries (both counted in `kernels.dispatch.FIRST_USE`) and, on the
  card, a new segment of PyTorch's caching allocator (a ``cudaMalloc``
  pause, read from ``torch.cuda.memory_stats()``). Once the tick is
  captured as a CUDA graph, a capture joins the count.
- `debug_nan_checks()` — a dispatch mode that raises at the first aten
  op whose floating output holds a NaN, naming the op.

All of them nest with each other and with user code: a mode pushed
inside another passes every op on to it, and each restores the
previous state on exit, on an exception too.

What the dispatch mode cannot see:

- ``np.asarray`` and ``.tolist()`` of a CPU tensor, and ``.numpy()``,
  do not dispatch (a CUDA tensor has to be copied to the CPU first,
  which is counted);
- a kernel launched through ``ctypes`` never reaches the mode, so
  launches are counted by the wrappers' ``LAUNCHES`` and what a kernel
  writes is seen only when an aten op reads it;
- modes are thread-local: work on another thread (a background
  `warm_next_layouts`) is not seen. The ``set_sync_debug_mode`` of
  `no_transfers` and the first-use counters are process-wide, so they
  do see it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Dict, Iterator, List, Optional

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.kernels import dispatch

_aten = torch.ops.aten
_SCALAR = _aten._local_scalar_dense.default
# ops whose output is uninitialised memory: never checked for NaN
_UNINITIALISED = ("empty", "empty_like", "new_empty", "empty_strided",
                  "new_empty_strided", "resize_", "set_")
_SEGMENTS = "segment.all.allocated"


class TransferBudgetExceeded(AssertionError):
    """More device→host materializations happened than budgeted."""


class FirstUseBudgetExceeded(AssertionError):
    """A block paid more first-use costs than its budget."""


class NanCheckError(FloatingPointError):
    """`debug_nan_checks` found a NaN."""


def host_materialization(func, args, kwargs) -> Optional[str]:
    """What ``func(*args, **kwargs)`` brings to the host, or None."""
    if func is _SCALAR:
        return ("aten._local_scalar_dense (.item(), float(), int() or "
                "bool() of a tensor)")
    if func is _aten._to_copy.default:
        src, dst = args[0], kwargs.get("device")
        if src.is_cuda and dst is not None \
                and torch.device(dst).type == "cpu":
            return "aten._to_copy of a CUDA tensor to the CPU"
    elif func in (_aten.copy_.default, _aten._copy_from.default):
        dst, src = (args[0], args[1]) if func is _aten.copy_.default \
            else (args[1], args[0])
        if getattr(src, "is_cuda", False) and dst.device.type == "cpu":
            return f"aten.{func.__name__.split('.')[0]} of a CUDA tensor " \
                   "into a CPU tensor"
    return None


@dataclasses.dataclass
class TransferCount:
    """Live view of a transfer sentinel's counter (yielded by
    `transfer_budget` and `no_transfers`); ``count`` keeps updating
    inside the block and ``ops`` names what was pulled."""
    budget: Optional[int]
    what: str = ""
    count: int = 0
    ops: List[str] = dataclasses.field(default_factory=list)
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def _bump(self, op: str) -> None:
        with self._lock:
            self.count += 1
            self.ops.append(op)


class _TransferMode(TorchDispatchMode):
    """Counts host materializations; with ``refuse`` raises at the first."""

    def __init__(self, counter: TransferCount, refuse: bool):
        super().__init__()
        self.counter = counter
        self.refuse = refuse

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = host_materialization(func, args, kwargs)
        if op is not None:
            self.counter._bump(op)
            if self.refuse:
                label = f" ({self.counter.what})" if self.counter.what \
                    else ""
                raise TransferBudgetExceeded(
                    f"host transfer refused{label}: {op} — the hot path "
                    "must leave its values on the device")
        return func(*args, **kwargs)


@contextlib.contextmanager
def transfer_budget(max_transfers: Optional[int],
                    what: str = "") -> Iterator[TransferCount]:
    """Assert at most ``max_transfers`` device→host materializations.

    ``max_transfers=None`` only counts (never raises) — useful for
    calibrating a budget before pinning it. The check runs when the
    block ends; `no_transfers` refuses at the op instead.
    """
    counter = TransferCount(budget=max_transfers, what=what)
    with _TransferMode(counter, refuse=False):
        yield counter
    if max_transfers is not None and counter.count > max_transfers:
        label = f" ({what})" if what else ""
        raise TransferBudgetExceeded(
            f"transfer budget exceeded{label}: {counter.count} "
            f"device→host materializations > budget {max_transfers} "
            f"({'; '.join(counter.ops)}) — a hot path is syncing per item "
            "instead of batching one pull per plane")


@contextlib.contextmanager
def no_transfers(device: dispatch.Device = None,
                 what: str = "") -> Iterator[TransferCount]:
    """Refuse any host materialization inside the block, by the name of
    its op; on a CUDA ``device`` (``None`` is CUDA, as everywhere in the
    port) refuse any implicit device sync too, through
    ``torch.cuda.set_sync_debug_mode("error")``. That setting is global
    and does not nest, so the one in force is saved and put back."""
    on_card = dispatch.resolve_device(device).type == "cuda"
    counter = TransferCount(budget=0, what=what)
    prev = torch.cuda.get_sync_debug_mode() if on_card else None
    if on_card:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with _TransferMode(counter, refuse=True):
            yield counter
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(prev)


@dataclasses.dataclass
class FirstUseCount:
    """Live view of a first-use sentinel (yielded by `first_use_budget`):
    ``events`` by kind since the block began (``library_load``,
    ``build_plan``, ``allocator_segment``), ``count`` their sum."""
    budget: Optional[int]
    what: str
    device: torch.device
    _start: Dict[str, int] = dataclasses.field(repr=False)
    _final: Optional[Dict[str, int]] = dataclasses.field(default=None,
                                                         repr=False)

    @property
    def events(self) -> Dict[str, int]:
        if self._final is not None:
            return dict(self._final)
        now = _first_use_now(self.device)
        return {k: now[k] - self._start[k] for k in now}

    @property
    def count(self) -> int:
        return sum(self.events.values())


def _first_use_now(device: torch.device) -> Dict[str, int]:
    out = dict(dispatch.FIRST_USE)
    out["allocator_segment"] = int(torch.cuda.memory_stats(device).get(
        _SEGMENTS, 0)) if device.type == "cuda" else 0
    return out


@contextlib.contextmanager
def first_use_budget(max_events: Optional[int], what: str = "",
                     device: dispatch.Device = None
                     ) -> Iterator[FirstUseCount]:
    """Assert at most ``max_events`` first-use costs inside the block:
    cold `build_plan` calls and kernel-library loads anywhere in the
    process, and on a CUDA ``device`` (``None`` is CUDA) new segments of
    its caching allocator. ``None`` only counts."""
    dev = dispatch.resolve_device(device)
    counter = FirstUseCount(budget=max_events, what=what, device=dev,
                            _start=_first_use_now(dev))
    yield counter
    counter._final = counter.events
    if max_events is not None and counter.count > max_events:
        label = f" ({what})" if what else ""
        got = ", ".join(f"{k}={v}" for k, v in counter._final.items() if v)
        raise FirstUseBudgetExceeded(
            f"first-use budget exceeded{label}: {counter.count} event(s) "
            f"({got}) > budget {max_events} — a migration installed a "
            "cold plan, the kernels loaded late, or the allocator grew: "
            "warm the next layouts first (warm_next_layouts)")


def assert_first_use_at_most(fn, max_events: int, *args, what: str = "",
                             device: dispatch.Device = None, **kwargs):
    """One-shot form: run ``fn(*args, **kwargs)`` under a first-use
    budget; returns fn's result."""
    with first_use_budget(max_events, what or getattr(fn, "__name__", "fn"),
                          device=device):
        return fn(*args, **kwargs)


def _ops_modules() -> dict:
    from repro_torch.kernels.parity import discover_kernel_packages

    return {name: importlib.import_module(f"repro_torch.kernels.{name}.ops")
            for name in discover_kernel_packages()}


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's ``LAUNCHES`` by entry point (a package
    whose count is one integer under the package's name)."""
    out: Dict[str, int] = {}
    for name, mod in _ops_modules().items():
        if isinstance(mod.LAUNCHES, dict):
            out.update(mod.LAUNCHES)
        else:
            out[name] = mod.LAUNCHES
    return out


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the wrappers' ``LAUNCHES`` back to ``counts`` (from
    `launch_counts`): launches made only to compare a kernel with its
    plain version do not count toward a path's."""
    for name, mod in _ops_modules().items():
        if isinstance(mod.LAUNCHES, dict):
            mod.LAUNCHES.update({k: counts[k] for k in mod.LAUNCHES})
        else:
            mod.LAUNCHES = counts[name]


def _has_nan(tree) -> bool:
    with _disable_current_modes():
        return any(bool(torch.isnan(t).any())
                   for t in _pytree.tree_leaves(tree)
                   if isinstance(t, torch.Tensor)
                   and (t.is_floating_point() or t.is_complex()))


def _read_inputs(func, args, kwargs) -> list:
    """The arguments ``func`` reads: all but those its schema writes
    (the ``self`` of an in-place op, an ``out=``), which may hold
    uninitialised memory before the op."""
    written = {a.name for a in func._schema.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    names = [a.name for a in func._schema.arguments]
    return [v for n, v in zip(names, args) if n not in written] + \
        [v for n, v in kwargs.items() if n not in written]


class _NanMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = f"aten.{func.__name__}"
        if _has_nan(_read_inputs(func, args, kwargs)):
            raise NanCheckError(
                f"NaN in an input of {name}, made by no aten op before "
                f"it: by a kernel launch before {name} (a ctypes launch is "
                "invisible to the mode) or passed into the block")
        out = func(*args, **kwargs)
        if func.__name__.split(".")[0] not in _UNINITIALISED \
                and _has_nan(out):
            raise NanCheckError(f"NaN produced by {name}")
        return out


@contextlib.contextmanager
def debug_nan_checks(enable: bool = True) -> Iterator[None]:
    """Debug-NaN mode: the first aten op whose floating output holds a
    NaN raises `NanCheckError` naming the op, instead of the NaN
    surfacing ticks later in a score. Every check reads its tensor on
    the host: a debugging mode, never a serving one."""
    if not enable:
        yield
        return
    with _NanMode():
        yield
