"""Device time a tick of every kernel the traced ticks launch, whatever
its name (the tick kernel, the top-k's sort), in ms, from the
profiler's trace."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ticks:
        return None
    spans = tr.clipped(("kernel",))
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / tr.ticks
