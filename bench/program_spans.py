"""Reading the program's own spans (`repro_torch.tracing`, the
``finger.*`` names) out of a traced window (`bench.trace.Trace`).

The spans sit on the profiler's clock beside the device's intervals, so
a span's time and the card's idle time inside it are read from the same
trace. A trace of a program without spans holds none of these names:
both functions then return None, and so do the readers built on them.
"""
from __future__ import annotations

from typing import Iterable, List, Optional

from bench.trace import Interval, Trace, covered, gaps, union


def _clipped(tr: Trace, names: Iterable[str]) -> List[Interval]:
    """The host spans named in ``names``, clipped to the window (those
    wholly outside it dropped)."""
    names = set(names)
    t0, t1 = tr.window
    return [(max(a, t0), min(b, t1)) for a, b, name in tr.host
            if name in names and b > t0 and a < t1]


def has(tr: Optional[Trace], name: str) -> bool:
    """Whether the trace holds any span named ``name``."""
    return tr is not None and any(n == name for _, _, n in tr.host)


def mean_ms(tr: Optional[Trace], name: str) -> Optional[float]:
    """The summed duration of ``name``'s spans clipped to the window,
    over the window's ticks, in ms; None without such spans."""
    if not has(tr, name) or not tr.ticks:
        return None
    return sum(b - a for a, b in _clipped(tr, (name,))) / 1e3 / tr.ticks


def idle_within_pct(tr: Optional[Trace], names: Iterable[str]
                    ) -> Optional[float]:
    """The window's idle time (no kernel, copy or set on the device, as
    `bench.trace.gaps` finds it) that lies inside the union of the
    spans of ``names``, as a percentage of the window; overlapping and
    nested spans count once. None without such spans."""
    names = tuple(names)
    if not any(has(tr, n) for n in names):
        return None
    width = tr.window[1] - tr.window[0]
    if width <= 0:
        return None
    inside = union(_clipped(tr, names))
    idle = gaps(tr.clipped(), tr.window)
    overlap = [(max(a, c), min(b, d)) for a, b in idle for c, d in inside
               if min(b, d) > max(a, c)]
    return 100.0 * covered(overlap) / width
