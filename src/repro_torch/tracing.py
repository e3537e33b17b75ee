"""Spans on the profiler's clock.

`span(name)` marks a stretch of host work in the serving path. While a
`torch.profiler` session records, it is `torch.profiler.record_function`,
so the span lands in the profiler's Chrome trace as a
``user_annotation`` event, on the same clock as the device's kernel,
copy and set intervals: an idle gap of the card is named by the span the
host was in. Otherwise it is one shared null context, and the only cost
is the check of the profiler's flag (`record_function` itself costs
about as much as a kernel launch even with no profiler recording).

There is no other switch: a span records exactly when a profiler does.
`record_function`'s ``args`` do not reach the exported trace, so a span
carries its name alone; the n-th span of a name in a window belongs to
the n-th call of that window.
"""
from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a `torch.profiler` session records in this process."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A context manager over the host work of ``name``: the profiler's
    `record_function` while one records, a shared no-op otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
