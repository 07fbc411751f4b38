"""The share of the traced slice in which no kernel and no copy ran: the
union of the device's intervals, from the same trace."""

KIND = "per_layer"
UNIT = "%"


def read(run):
    tr = run.trace
    if not tr or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
