"""Profiling: ``trace``, ``annotate``, ``count`` and ``StepTimer``.

Counterpart of cista_flow_tpu/utils/profiling.py:
* ``trace(logdir)``: a ``torch.profiler`` capture of the host and, where
  there is a card, the device, written as a chrome trace
  (``<logdir>/trace_<ns>.pt.trace.json``) that ``utils/trace_tools.py``
  reads, with the counters beside it (``counters_<ns>.json``);
  ``with trace('build/tb'): run_steps()``.
* ``annotate(name)``: the program's span at a layer boundary. While a torch
  profiler records (any: ``trace``, a benchmark's, ``profile_step``'s) it
  is a ``record_function`` range named ``cista.<name>``, which the profiler
  stamps on the clock of the device's kernels and copies, on the thread
  that opened it, inside the span that encloses it. Otherwise it is one
  shared no-op context: no range, no clock read.
* ``count(name, n)``: adds ``n`` to the counter ``name`` while a profiler
  records, else does nothing; ``counters()`` reads the counters, ``trace``
  zeroes them at its start.
* ``StepTimer``: host-side wall time per step, with the JAX class's warmup
  and summary fields. ``stop(result)`` waits for the result's device first
  (``torch.cuda.synchronize`` where a CUDA tensor is in it; the JAX
  package calls ``block_until_ready``), so a step's time includes its
  device work.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time

import numpy as np
import torch

PREFIX = "cista."
enabled = torch._C._autograd._profiler_enabled      # whether a torch profiler records
_COUNTERS = collections.Counter()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture the block's host operations and device kernels; the chrome
    trace and the counters are written to ``logdir`` when the block ends.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _COUNTERS.clear()
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        ns = time.time_ns()
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{ns}.pt.trace.json"))
        with open(os.path.join(logdir, f"counters_{ns}.json"), "w") as f:
            json.dump(counters(), f, indent=1, sort_keys=True)


class _Off:
    """``annotate``'s span while no profiler records: nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def annotate(name: str):
    """The span ``cista.<name>`` while a profiler records, else a no-op:
    ``with annotate('flownet'): ...``."""
    if not enabled():
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if enabled():
        _COUNTERS[name] += n


def counters() -> dict:
    """{name: count} of what was counted while a profiler recorded, since
    the process began or the last ``trace`` began."""
    return dict(_COUNTERS)


def _cuda_devices(result) -> set:
    """The CUDA devices of a tensor or a (nested) tuple or list of them."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result))
    return set()


class StepTimer:
    """Accumulates per-step wall times after ``warmup`` steps; waits for
    the device of a result passed to ``stop``."""

    def __init__(self, name: str = "step", warmup: int = 1):
        self.name = name
        self.warmup = warmup
        self.times: list[float] = []
        self._count = 0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        for dev in _cuda_devices(result):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {"name": self.name, "steps": 0}
        t = np.array(self.times)
        return {
            "name": self.name,
            "steps": len(t),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "max_ms": float(t.max() * 1e3),
        }

    def __str__(self):
        s = self.summary()
        if s.get("steps", 0) == 0:
            return f"[{self.name}] no samples"
        return (f"[{s['name']}] {s['steps']} steps: mean {s['mean_ms']:.2f}ms "
                f"p50 {s['p50_ms']:.2f}ms p90 {s['p90_ms']:.2f}ms "
                f"max {s['max_ms']:.2f}ms")
