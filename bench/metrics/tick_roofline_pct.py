"""The traced ticks' least time at the card's memory bandwidth (the
bytes their inputs need, `bench.roofline.bytes_needed`, over the peak)
as a share of the device's busy time in the same window (the union of
every kernel, copy and set interval), in %."""
from bench.roofline import PEAK


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    busy = tr.busy_s()
    if busy <= 0:
        return None
    return 100.0 * tr.bytes_needed / PEAK["hbm_bytes_per_s"] / busy
