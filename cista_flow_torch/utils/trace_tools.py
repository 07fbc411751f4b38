"""Reading a ``utils.profiling.trace`` capture (a ``torch.profiler``
chrome trace; no TensorBoard needed).

    with profiling.trace('build/tb'):
        run_steps()
    trace_tools.print_summary('build/tb', runs=N)

Counterpart of cista_flow_tpu/utils/trace_tools.py. Events split as the
JAX ``_is_host`` splits them, into host and device: device events are the
card's kernels, copies and fills (the trace's 'kernel', 'gpu_memcpy' and
'gpu_memset' categories), every other complete event is the host's. Host
operations nest (``aten::conv2d`` holds ``aten::convolution``), so the
host side sums only leaves, events holding no other on their thread, as
the JAX summary leaves out its container nodes: totals are leaf sums.

``span_summary`` reads the program's own spans (``profiling.annotate``,
the ``cista.`` ranges on the host threads; not their copies on the
device's timeline): each span's host time, the device time of the work
launched inside it (matched by the launch's correlation id, on the
thread that opened the span), its launches, and the operation that holds
most of its host time, innermost.
"""
from __future__ import annotations

import bisect
import collections
import glob
import gzip
import json
import os

from .profiling import PREFIX

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")


def _newest(logdir: str, patterns, skip: str = "") -> str:
    paths = [p for pattern in patterns
             for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)
             if not (skip and os.path.basename(p).startswith(skip))]
    if not paths:
        raise FileNotFoundError(f"no {' or '.join(patterns)} under {logdir}")
    return max(paths, key=os.path.getmtime)


def load_events(logdir: str) -> list[dict]:
    """The complete events (phase 'X', with a duration) of the newest
    trace under ``logdir``, but the profiler's own span (category 'Trace')."""
    path = _newest(logdir, ("*.json", "*.json.gz"), skip="counters_")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    return [e for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") != "Trace"]


def load_counters(logdir: str) -> dict:
    """The newest ``counters_<ns>.json`` under ``logdir`` ({} if none)."""
    try:
        path = _newest(logdir, ("counters_*.json",))
    except FileNotFoundError:
        return {}
    with open(path) as f:
        return json.load(f)


def _is_host(event: dict) -> bool:
    return event.get("cat", "") not in DEVICE_CATEGORIES


def _thread(event: dict) -> tuple:
    return event.get("pid"), event.get("tid")


def _host_leaves(events: list[dict]) -> list[dict]:
    """The host events that hold no other event of their thread."""
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[_thread(e)].append(e)
    leaves = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        for e, nxt in zip(evs, evs[1:] + [None]):
            if nxt is None or nxt["ts"] >= e["ts"] + e["dur"]:
                leaves.append(e)
    return leaves


def summarize(logdir: str, runs: int = 1, top: int = 20,
              side: str = "device") -> list[tuple]:
    """[(operation name, ms per run, count)] of one side ('device' or
    'host'), largest first, ``top`` of them."""
    if side not in ("device", "host"):
        raise ValueError(f"side {side!r}: 'device' or 'host'")
    events = [e for e in load_events(logdir) if _is_host(e) == (side == "host")]
    if side == "host":
        events = _host_leaves(events)
    agg, cnt = collections.Counter(), collections.Counter()
    for e in events:
        key = e.get("name", "")
        agg[key] += e["dur"]
        cnt[key] += 1
    return [(k, d / runs / 1e3, cnt[k]) for k, d in agg.most_common(top)]


def _self_segments(events: list[dict]) -> list[tuple]:
    """[(start, end, name)] of one thread's events: each instant belongs to
    the innermost event open at it."""
    out, stack = [], []                          # stack: [end, name, emitted up to]

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, name, last = stack.pop()
            if end > last:
                out.append((last, end, name))
            if stack:
                stack[-1][2] = max(stack[-1][2], end)
    for e in sorted(events, key=lambda e: (e["ts"], -e["dur"])):
        a, b = e["ts"], e["ts"] + e["dur"]
        close_until(a)
        if stack:
            if a > stack[-1][2]:
                out.append((stack[-1][2], a, stack[-1][1]))
            b = min(b, stack[-1][0])
        stack.append([b, e.get("name", ""), a])
    close_until(float("inf"))
    return sorted(out)


def span_summary(logdir: str, runs: int = 1) -> list[tuple]:
    """The program's spans in the newest trace under ``logdir``, in order of
    first opening: [(span name without ``cista.``, spans per run, host ms
    per run, device ms per run of the kernels, copies and fills launched
    inside, launches per run, the operation with most host time inside
    (innermost, not a span), its ms per run)]."""
    return _span_rows(load_events(logdir), runs)


def _span_rows(events: list[dict], runs: int = 1) -> list[tuple]:
    host = [e for e in events if _is_host(e)]
    spans = sorted((e for e in host if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(PREFIX)), key=lambda e: e["ts"])
    runtime = {e["args"]["correlation"]: e for e in host
               if e.get("cat") in RUNTIME_CATEGORIES and "correlation" in e.get("args", {})}
    launched = collections.defaultdict(list)     # thread -> [(launch ts, device us)]
    for e in events:
        r = runtime.get(e.get("args", {}).get("correlation"))
        if not _is_host(e) and r is not None:
            launched[_thread(r)].append((r["ts"], e["dur"]))
    launches = collections.defaultdict(list)     # thread -> [launch ts]
    for r in runtime.values():
        if "Launch" in r.get("name", ""):
            launches[_thread(r)].append(r["ts"])
    for v in (*launched.values(), *launches.values()):
        v.sort()
    threads = {_thread(s) for s in spans}
    by_thread = collections.defaultdict(list)
    for e in host:
        if _thread(e) in threads:
            by_thread[_thread(e)].append(e)
    segments = {t: _self_segments(evs) for t, evs in by_thread.items()}

    rows = {}
    for s in spans:
        t, a, b = _thread(s), s["ts"], s["ts"] + s["dur"]
        row = rows.setdefault(s["name"][len(PREFIX):],
                              [0, 0.0, 0.0, 0, collections.Counter()])
        row[0] += 1
        row[1] += s["dur"]
        dev = launched[t]
        row[2] += sum(d for _, d in dev[bisect.bisect_left(dev, (a,)):
                                          bisect.bisect_right(dev, (b, float("inf")))])
        ts = launches[t]
        row[3] += bisect.bisect_right(ts, b) - bisect.bisect_left(ts, a)
        segs = segments[t]
        i = bisect.bisect_left(segs, (a,))
        while i < len(segs) and segs[i][0] < b:
            s0, s1, name = segs[i]
            if not name.startswith(PREFIX):
                row[4][name] += min(s1, b) - max(s0, a)
            i += 1
    out = []
    for name, (n, host_us, dev_us, n_launch, ops) in rows.items():
        op, op_us = ops.most_common(1)[0] if ops else ("", 0.0)
        out.append((name, n / runs, host_us / runs / 1e3, dev_us / runs / 1e3,
                    n_launch / runs, op, op_us / runs / 1e3))
    return out


def print_summary(logdir: str, runs: int = 1, top: int = 20) -> None:
    for side in ("device", "host"):
        rows = summarize(logdir, runs=runs, top=top, side=side)
        total = sum(r[1] for r in rows)
        print(f"{side}: top-{top} leaf op time {total:.3f} ms/run")
        for key, ms, n in rows:
            print(f"{ms:10.4f} ms  x{n:<6d} {key}")
    print_spans(logdir, runs)


def print_spans(logdir: str, runs: int = 1) -> None:
    """The program's spans (``span_summary``) and counters, per run, and the
    host copies' rate: the runner's bytes over its upload and download
    spans' host time."""
    rows = span_summary(logdir, runs)
    if rows:
        print(f"program spans, per run: {'host ms':>10s} {'device ms':>10s} {'launches':>9s}"
              "  spans  most host time inside")
        for name, n, host_ms, dev_ms, n_launch, op, op_ms in rows:
            print(f"  {name:<22s} {host_ms:10.4f} {dev_ms:10.4f} {n_launch:9.1f} {n:6.1f}"
                  f"  {op} {op_ms:.4f} ms")
    counters = load_counters(logdir)
    for key, v in sorted(counters.items()):
        print(f"  counter {key}: {v / runs:.1f} per run")
    copy_ms = sum(r[2] for r in rows if r[0] in ("runner.upload", "runner.download"))
    nbytes = counters.get("runner.bytes_up", 0) + counters.get("runner.bytes_down", 0)
    if copy_ms and nbytes:
        print(f"  host copies {nbytes / runs / copy_ms / 1e6:.3f} GB/s "
              "(runner.bytes_up + bytes_down over runner.upload + download host ms)")
