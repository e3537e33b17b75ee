"""Mean host time a tick of `FingerService.poll`, in ms: `LocalPlan.tick`,
the engine's tick and the kernel wrapper's enqueue, from the
benchmark's own spans over the traced run's window."""


def read(rec):
    return rec.mean_span_ms("poll")
