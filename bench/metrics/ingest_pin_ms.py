"""Mean host time a tick of the ingest's pinned staging (span
``finger.ingest.pin``): the pinned slot's allocation, if any, and the
copies of the delta's fields from pageable into pinned memory, in ms."""
from bench import program_spans


def read(rec):
    return program_spans.mean_ms(rec.trace, "finger.ingest.pin")
