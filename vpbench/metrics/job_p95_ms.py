"""The 95th percentile, over every job finished in the window, of the time
from its submission to its result on the host (linear between ranks)."""
import numpy as np


def read(rec):
    if not rec.latencies:
        return None
    return float(np.percentile(np.asarray(rec.latencies), 95)) * 1e3
