"""The 95th percentile, over every tick whose results reached the host
inside the window, of the time from the call of ``ingest`` with the
tick's deltas to the return of its ``top_anomalies``, in ms. The loop is
closed and always at capacity, so this tail swings with the host's
stalls: it is the end-to-end latency, read in the traced run without a
bound (an open-loop cell below capacity would judge it)."""
import numpy as np


def read(rec):
    t0, t1 = rec.window
    inside = (rec.t_done >= t0) & (rec.t_done <= t1)
    if not inside.any():
        return None
    lat = rec.t_done[inside] - rec.t_in[inside]
    return float(np.percentile(lat, 95)) * 1e3
