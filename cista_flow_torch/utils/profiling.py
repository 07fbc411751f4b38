"""Profiling: ``trace``, ``annotate`` and ``StepTimer``.

Counterpart of cista_flow_tpu/utils/profiling.py:
* ``trace(logdir)``: a ``torch.profiler`` capture of the host and, where
  there is a card, the device, written as a chrome trace
  (``<logdir>/trace_<ns>.pt.trace.json``) that ``utils/trace_tools.py``
  reads; ``with trace('build/tb'): run_steps()``.
* ``annotate(name)``: a named region in that trace (``record_function``).
* ``StepTimer``: host-side wall time per step, with the JAX class's warmup
  and summary fields. ``stop(result)`` waits for the result's device first
  (``torch.cuda.synchronize`` where a CUDA tensor is in it; the JAX
  package calls ``block_until_ready``), so a step's time includes its
  device work.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture the block's host operations and device kernels; the chrome
    trace is written to ``logdir`` when the block ends. Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named region of the trace: ``with annotate('flow_net'): ...``."""
    return torch.profiler.record_function(name)


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
