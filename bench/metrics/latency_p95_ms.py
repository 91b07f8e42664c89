"""latency_p95_ms (host clock): the 95th percentile (linear between order
statistics) of completion minus submission of every request of the
window; the requests of one batch share its ``generate`` call."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s(), 95)) * 1e3
