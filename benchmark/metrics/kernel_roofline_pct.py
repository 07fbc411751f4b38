"""The least time the traced slice's K1-K5 calls need (``kernels/*.py``:
the larger of their bytes at the HBM rate and their operations at the
dtype's peak) over the device time of every kernel launched inside those
calls."""

import peaks

KIND = "per_layer"
UNIT = "%"


def read(run):
    tr = run.trace
    if not tr or not tr.kernel_calls:
        return None
    spent = tr.kernel_seconds_in_ranges()
    if spent <= 0:
        return None
    least = sum(peaks.least_seconds(b, o, dt) for _, b, o, dt in tr.kernel_calls)
    return 100.0 * least / spent
