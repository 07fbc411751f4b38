"""The main thread's host time per step in the traced slice: all of its
time less its waits on the card (synchronisations and blocking copies),
so the Python and the operations that issue the step."""

KIND = "per_layer"
UNIT = "ms"


def read(run):
    tr = run.trace
    return tr.host_busy_s() * 1e3 / run.traced_steps if tr and run.traced_steps else None
