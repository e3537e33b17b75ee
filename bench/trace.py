"""Reading a `torch.profiler` trace of a bounded run of ticks.

The profiler's Chrome trace holds the device's intervals (``kernel``,
``gpu_memcpy``, ``gpu_memset``) and the host's spans (``user_annotation``
from ``record_function``), on one clock in microseconds. The window is
the span that encloses the traced ticks; the device is busy where any
device interval lies, counted once where several overlap (the union),
and idle elsewhere in the window.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Interval = Tuple[float, float]


@dataclasses.dataclass(frozen=True)
class Trace:
    """One traced window: device intervals ``(start, end, cat, name)``,
    host spans ``(start, end, name)``, the window ``(start, end)`` (all
    in microseconds), the ticks it holds and the bytes they need."""

    device: List[Tuple[float, float, str, str]]
    host: List[Tuple[float, float, str]]
    window: Interval
    ticks: int
    bytes_needed: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def clipped(self, cats: Sequence[str] = DEVICE_CATS,
                contains: str = "") -> List[Interval]:
        """Device intervals of ``cats`` (whose name holds ``contains``)
        clipped to the window."""
        t0, t1 = self.window
        return [(max(a, t0), min(b, t1)) for a, b, cat, name in self.device
                if cat in cats and contains in name and b > t0 and a < t1]

    def busy_s(self) -> float:
        return covered(self.clipped()) / 1e6


def union(intervals: Sequence[Interval]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(intervals: Sequence[Interval]) -> float:
    """The length of the union of ``intervals``."""
    return sum(b - a for a, b in union(intervals))


def gaps(busy: Sequence[Interval], window: Interval) -> List[Interval]:
    """The idle intervals of the window between the busy ones."""
    out, at = [], window[0]
    for a, b in union(busy):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if window[1] > at:
        out.append((at, window[1]))
    return out


def load(path: Path, window_span: str, ticks: int,
         bytes_needed: int) -> Optional[Trace]:
    """The traced window of an exported Chrome trace; None where the
    trace holds no window span or no device interval."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((a, b, cat, name))
        elif cat == "user_annotation":
            if name == window_span:
                window = (a, b)
            else:
                host.append((a, b, name))
    if window is None or not device:
        return None
    return Trace(sorted(device), sorted(host), window, ticks, bytes_needed)


def top_ops(tr: Trace, n: int = 10) -> List[List]:
    """The device operations that took most time in the window:
    ``[name, seconds]``, most first."""
    t0, t1 = tr.window
    total: Dict[str, float] = {}
    for a, b, _, name in tr.device:
        d = min(b, t1) - max(a, t0)
        if d > 0:
            total[name] = total.get(name, 0.0) + d
    return [[k, v / 1e6] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def labelled_gaps(tr: Trace, n: int = 10) -> List[List]:
    """The longest idle gaps of the window, each ``[label, seconds]``,
    labelled by the host span its midpoint falls in (``host`` where no
    span of the benchmark holds it)."""
    out = []
    for a, b in gaps(tr.clipped(), tr.window):
        mid = 0.5 * (a + b)
        label = "host"
        for c, d, name in tr.host:
            if c <= mid <= d:
                label = name
        out.append((b - a, label))
    out.sort(key=lambda x: -x[0])
    return [[label, d / 1e6] for d, label in out[:n]]
