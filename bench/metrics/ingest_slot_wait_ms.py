"""Mean host time a tick that `FingerService.ingest` blocked on a ring
slot whose previous copy had not landed (span
``finger.ingest.slot_wait``), in ms: 0.0 where the ingest spans are
there and no staging blocked."""
from bench import program_spans


def read(rec):
    got = program_spans.mean_ms(rec.trace, "finger.ingest.slot_wait")
    if got is None and program_spans.has(rec.trace, "finger.ingest"):
        return 0.0
    return got
