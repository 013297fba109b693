"""The 95th percentile, over every request of the window, of the seconds
from when its batch was due to its last token (numpy's linear
interpolation)."""

import numpy as np


def read(rec):
    if rec["kind"] != "serve" or not rec["latency_s"]:
        return None
    return float(np.percentile(rec["latency_s"], 95))
