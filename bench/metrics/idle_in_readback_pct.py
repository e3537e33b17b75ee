"""The share of the traced window in which the device was idle while
the host was inside `FingerService.scores` or `top_anomalies` (spans
``finger.scores`` and ``finger.top_anomalies``, their union), in %."""
from bench import program_spans


def read(rec):
    return program_spans.idle_within_pct(
        rec.trace, ("finger.scores", "finger.top_anomalies"))
