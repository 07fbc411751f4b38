"""New device allocations per step: the program's counter
``runner.device_allocs`` (each call's change in the caching allocator's
``num_device_alloc``, a ``cudaMalloc`` each) over the slice's steps.

The program counts only while a torch profiler records
(``cista_flow_torch/utils/profiling.count``), and a run's only profiler is
its traced slice, so the counters of the loaded program after the run are
the slice's. A program without the counter (a version before it, or a
run off the card) reads nothing."""

import sys

KIND = "per_layer"
UNIT = "allocs"
PROFILING = "cista_flow_torch.utils.profiling"


def read(run):
    counters = getattr(sys.modules.get(PROFILING), "counters", None)
    if counters is None or run.trace is None or not run.traced_steps:
        return None
    n = counters().get("runner.device_allocs")
    return None if n is None else n / run.traced_steps
