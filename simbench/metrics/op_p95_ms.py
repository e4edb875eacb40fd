"""op_p95_ms: the 95th percentile of every window op's latency, from when
the harness hands the op to the program to when its answer is readable."""
import numpy as np


def read(run):
    if not run.latencies_s.size:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
