"""Seconds from the process's start to the first timed tick: the kernel
library loaded (built in a cold checkout), the state and the deltas
made, the warm ticks run."""


def read(rec):
    return rec.setup_s
