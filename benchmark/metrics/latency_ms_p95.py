"""The 95th percentile of every call's latency in the window: from handing
the program the host voxels to holding its frames and flows on the host."""

import numpy as np

KIND = "end_to_end"
UNIT = "ms"


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3 if run.calls else None
