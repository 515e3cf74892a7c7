"""latency_p95_ms: the 95th percentile, linearly interpolated, of every
request of the window, each timed on the host clock from the call of
``execute`` to the synchronisation after it (a list of 100 is one
request)."""
import numpy as np


def read(ctx):
    lat = ctx.window.latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
