"""Share of the runner's host bytes that went through page-locked memory:
100 × the program's counter ``runner.bytes_staged`` over its
``runner.bytes_up`` + ``runner.bytes_down`` (the host arrays' bytes, up
and down, of the slice's calls).

The program counts only while a torch profiler records
(``cista_flow_torch/utils/profiling.count``), and a run's only profiler is
its traced slice, so the counters of the loaded program after the run are
the slice's. A program without the counter (a version before it, or a
run off the card) reads nothing."""

import sys

KIND = "per_layer"
UNIT = "%"
PROFILING = "cista_flow_torch.utils.profiling"


def read(run):
    counters = getattr(sys.modules.get(PROFILING), "counters", None)
    if counters is None or run.trace is None or not run.traced_steps:
        return None
    c = counters()
    staged = c.get("runner.bytes_staged")
    moved = c.get("runner.bytes_up", 0) + c.get("runner.bytes_down", 0)
    if staged is None or not moved:
        return None
    return 100 * staged / moved
