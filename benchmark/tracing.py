"""The traced slice of a ``--trace 1`` run: spans opened from the
benchmark around calls into the program, a ``torch.profiler`` capture,
and what the per-layer readers take from it.

* Kernel calls: every ``kernels/<k>.py`` names the program's functions
  that route to its kernel (``TARGETS``) and counts a call's bytes and
  operations from its arguments (``work``). While the slice is traced,
  each such function, in every loaded module of the program that holds
  it, is wrapped in a ``bench:<k>`` range, and its work is recorded.
* Stages: a metric file's ``STAGES`` maps a stage to submodules of the
  model; CUDA events around their calls (outermost call only) give the
  stage's device time, as ``profile_step.StageTimer`` takes it.
* The trace: written as a chrome trace to the run's temporary directory,
  read into ``Trace`` and deleted.
"""
from __future__ import annotations

import bisect
import collections
import gzip
import importlib.util
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WAIT_MARKERS = ("Synchronize", "Memcpy")          # host calls that wait on the card
WINDOW = "bench:window"
PROGRAM = "cista_flow_torch"
SKIP_CALLS = 4            # calls of the window before the traced slice opens


def load_files(folder: Path) -> dict:
    """{stem: module} of every ``*.py`` in ``folder``, by name."""
    out = {}
    for path in sorted(folder.glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"bench_{folder.name}_{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


class KernelCalls:
    """Wraps the program's kernel entry points in ``bench:<k>`` ranges and
    records each call's (key, bytes, operations, dtype)."""

    def __init__(self, counters: dict):
        self.counters = counters
        self.calls = []
        self.patched = []

    def install(self):
        for key, mod in self.counters.items():
            for module_name, attr in mod.TARGETS:
                owner = sys.modules.get(module_name)
                fn = getattr(owner, attr, None) if owner is not None else None
                if fn is None:
                    continue                   # the program no longer has it
                wrapped = self._wrap(key, mod.work, fn)
                for m in list(sys.modules.values()):
                    name = getattr(m, "__name__", "") or ""
                    if name.split(".")[0] == PROGRAM and getattr(m, attr, None) is fn:
                        self.patched.append((m, attr, fn))
                        setattr(m, attr, wrapped)

    def _wrap(self, key, work, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(f"bench:{key}"):
                out = fn(*args, **kwargs)
            self.calls.append((key, *work(*args, **kwargs)))
            return out
        return wrapper

    def remove(self):
        for m, attr, fn in reversed(self.patched):
            setattr(m, attr, fn)
        self.patched = []


class StageTimer:
    """CUDA events around the outermost call of each stage's submodules."""

    def __init__(self, model, stages: dict):
        self.spans = {s: [] for s in stages}
        self.depth = collections.Counter()
        self.handles = []
        if not torch.cuda.is_available():
            return                               # CUDA events need the card
        for stage, names in stages.items():
            for n in names:
                try:
                    mod = model.get_submodule(n)
                except AttributeError:
                    continue
                self.handles.append(mod.register_forward_pre_hook(
                    lambda *_, s=stage: self._enter(s)))
                self.handles.append(mod.register_forward_hook(
                    lambda *_, s=stage: self._leave(s)))

    def _enter(self, stage):
        self.depth[stage] += 1
        if self.depth[stage] == 1:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[stage].append([ev, None])

    def _leave(self, stage):
        self.depth[stage] -= 1
        if self.depth[stage] == 0:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[stage][-1][1] = ev

    def ms(self) -> dict:
        if not self.handles:
            return {}
        torch.cuda.synchronize()
        return {s: sum(a.elapsed_time(b) for a, b in v) for s, v in self.spans.items() if v}

    def remove(self):
        for h in self.handles:
            h.remove()


class Tracer:
    """Traces ``calls`` calls of the window after its first ``SKIP_CALLS``:
    ``begin`` before the first, ``end`` after the last."""

    def __init__(self, model, counters: dict, metric_files: dict, calls: int):
        self.model = model
        self.kernels = KernelCalls(counters)
        self.stages = {}
        for mod in metric_files.values():
            self.stages.update(getattr(mod, "STAGES", {}))
        self.start_call, self.stop_call = SKIP_CALLS, SKIP_CALLS + calls
        self.timer = None
        self.prof = None
        self.window = None
        self.calls = 0

    def begin(self):
        self.kernels.install()
        self.timer = StageTimer(self.model, self.stages)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.window = torch.profiler.record_function(WINDOW)
        self.window.__enter__()

    def end(self, calls: int):
        self.window.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.calls = calls
        self.kernels.remove()
        self.timer.remove()

    def read(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with (gzip.open if path.endswith(".gz") else open)(path, "rt") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return Trace(events, self.kernels.calls, self.timer.ms())


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """What the readers need of one traced slice; times in seconds."""

    def __init__(self, events, kernel_calls, stage_ms):
        ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = [e for e in ev if e.get("name") == WINDOW and e.get("cat") != "gpu_user_annotation"]
        self.kernel_calls = kernel_calls
        self.stage_ms = stage_ms
        if not win:
            raise RuntimeError("the trace holds no window range")
        w = win[0]
        self.main = (w.get("pid"), w.get("tid"))
        self.t0, self.t1 = w["ts"], w["ts"] + w["dur"]
        self.window_s = w["dur"] * 1e-6
        inside = [e for e in ev if e["ts"] < self.t1 and e["ts"] + e["dur"] > self.t0]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATEGORIES]
        host = [e for e in inside if e.get("cat") not in DEVICE_CATEGORIES
                and (e.get("pid"), e.get("tid")) == self.main and e is not w]
        self.host_self = _self_segments([w] + host, "host: between operations")
        self.waits_s = sum(b - a for a, b, name in self.host_self
                           if any(m in name for m in WAIT_MARKERS)) * 1e-6
        self.busy = _union([(max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1))
                            for e in self.device])
        self.busy_s = sum(b - a for a, b in self.busy) * 1e-6
        runtime = {e["args"]["correlation"]: e for e in inside
                   if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        self.launch_ts = {id(e): runtime[e["args"]["correlation"]]["ts"] for e in self.device
                          if e.get("args", {}).get("correlation") in runtime}
        self.ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                             if e.get("name", "").startswith("bench:"))

    def device_seconds(self, category: str) -> float:
        return sum(e["dur"] for e in self.device if e.get("cat") == category) * 1e-6

    def kernel_seconds_in_ranges(self) -> float:
        """Device seconds of the kernels launched inside a ``bench:<k>`` range."""
        starts = [r[0] for r in self.ranges]
        total = 0.0
        for e in self.device:
            ts = self.launch_ts.get(id(e))
            if e.get("cat") != "kernel" or ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and self.ranges[i][1] >= ts:
                total += e["dur"]
        return total * 1e-6

    def host_busy_s(self) -> float:
        """The main thread's time in the slice, less its waits on the card
        (synchronisations and blocking copies)."""
        return self.window_s - self.waits_s

    def top_device_ops(self, n=10):
        agg = collections.Counter()
        for e in self.device:
            agg[e.get("name", "")] += e["dur"] * 1e-6
        return [[k, v] for k, v in agg.most_common(n)]

    def idle_gaps(self, n=10):
        """The seconds in which no kernel or copy ran, split by what the
        main thread was doing meanwhile: the innermost operation's name,
        "host: between operations" for the time in no operation."""
        edges = [self.t0] + [x for a, b in self.busy for x in (a, b)] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        ends = [b for _, b, _ in self.host_self]
        agg = collections.Counter()
        for a, b in gaps:
            i = bisect.bisect_right(ends, a)
            while i < len(self.host_self) and self.host_self[i][0] < b:
                s0, s1, name = self.host_self[i]
                agg[name] += (min(b, s1) - max(a, s0)) * 1e-6
                i += 1
        return [[k, v] for k, v in agg.most_common(n)]


def _self_segments(events, root_name):
    """[(start, end, name)] of the time each event holds no nested event,
    in order: every instant of the outermost event's span belongs to the
    innermost event open at it (the outermost is named ``root_name``)."""
    out, stack = [], []                          # stack: [end, name, emitted up to]

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, name, last = stack.pop()
            if end > last:
                out.append((last, end, name))
            if stack:
                stack[-1][2] = end
    for i, e in enumerate(sorted(events, key=lambda e: (e["ts"], -e["dur"]))):
        a, b = e["ts"], e["ts"] + e["dur"]
        close_until(a)
        if stack:
            if a > stack[-1][2]:
                out.append((stack[-1][2], a, stack[-1][1]))
            b = min(b, stack[-1][0])
        stack.append([b, root_name if i == 0 else e.get("name", ""), a])
    close_until(float("inf"))
    return out
