"""Mean host time a tick of `FingerService.ingest`, in ms: the front
door's checks, the pinned staging and the side-stream copy's enqueue,
from the benchmark's own spans over the traced run's window."""


def read(rec):
    return rec.mean_span_ms("ingest")
