"""Stream-ticks scored a second: B × the ticks whose scores and top-k
reached the host inside the window, over the window's seconds."""
import numpy as np


def read(rec):
    t0, t1 = rec.window
    done = np.sum((rec.t_done >= t0) & (rec.t_done <= t1))
    return rec.batch * float(done) / (t1 - t0)
