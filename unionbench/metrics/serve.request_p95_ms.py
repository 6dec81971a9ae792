"""95th percentile of the latency, issue to return, of the window's
requests (failed ones at the time they failed), leaving out those that
overlap the traced slice and its profiler switches."""

import numpy as np


def read(run):
    lat = [r.done - r.issued for r in run.counted(run.window.records)]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
