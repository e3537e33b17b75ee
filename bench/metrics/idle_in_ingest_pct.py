"""The share of the traced window in which the device was idle while
the host was inside `FingerService.ingest` (span ``finger.ingest``),
in %."""
from bench import program_spans


def read(rec):
    return program_spans.idle_within_pct(rec.trace, ("finger.ingest",))
