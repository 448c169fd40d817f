"""95th percentile of submit-to-result latency over every update committed
in the window (a failed update fails the run's check)."""

import numpy as np


def read(window):
    return float(np.percentile(window.latencies, 95)) * 1e3 if window.latencies else None
