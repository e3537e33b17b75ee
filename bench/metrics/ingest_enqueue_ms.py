"""Mean host time a tick of the ingest's side-stream enqueue (span
``finger.ingest.enqueue``): the device buffer's allocation on the side
stream, the asynchronous copy's enqueue and its event, in ms."""
from bench import program_spans


def read(rec):
    return program_spans.mean_ms(rec.trace, "finger.ingest.enqueue")
