"""Device time a tick of the host-to-device copies (the ingestor's
side-stream copy of each delta), in ms, from the profiler's trace."""


def read(rec):
    tr = rec.trace
    if tr is None or not tr.ticks:
        return None
    spans = tr.clipped(("gpu_memcpy",), "HtoD")
    return sum(b - a for a, b in spans) / 1e3 / tr.ticks
