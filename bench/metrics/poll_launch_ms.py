"""Mean host time a tick of the tick kernel's launch (span
``finger.tick.launch``): the ctypes call into the launcher and its
error check, in ms. The operand checks and set-up before it are
`finger.poll`'s own time."""
from bench import program_spans


def read(rec):
    return program_spans.mean_ms(rec.trace, "finger.tick.launch")
