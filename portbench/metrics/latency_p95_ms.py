"""95th percentile over all requests of the window, call to JSON string."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 95) * 1e3) if lat else None
