"""Mean host time a tick of `FingerService.scores` and `top_anomalies`,
in ms: mostly the wait for the tick on the device, then the copies to
the host, from the benchmark's own spans over the traced run's
window."""


def read(rec):
    return rec.mean_span_ms("readback")
