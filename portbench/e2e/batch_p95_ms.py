"""batch_p95_ms: the 95th percentile, over every batch of the window, of
the time from the call that sends a batch to its answers in host memory
(numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run["window"].lat_s, 95)) * 1e3
