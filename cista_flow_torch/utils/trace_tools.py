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
"""
from __future__ import annotations

import collections
import glob
import gzip
import json
import os

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(logdir: str) -> list[dict]:
    """The complete events (phase 'X', with a duration) of the newest
    trace under ``logdir``, but the profiler's own span (category 'Trace')."""
    paths = [p for pattern in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pattern), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        tr = json.load(f)
    return [e for e in tr.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e and e.get("cat") != "Trace"]


def _is_host(event: dict) -> bool:
    return event.get("cat", "") not in DEVICE_CATEGORIES


def _host_leaves(events: list[dict]) -> list[dict]:
    """The host events that hold no other event of their thread."""
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e.get("pid"), e.get("tid"))].append(e)
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


def print_summary(logdir: str, runs: int = 1, top: int = 20) -> None:
    for side in ("device", "host"):
        rows = summarize(logdir, runs=runs, top=top, side=side)
        total = sum(r[1] for r in rows)
        print(f"{side}: top-{top} leaf op time {total:.3f} ms/run")
        for key, ms, n in rows:
            print(f"{ms:10.4f} ms  x{n:<6d} {key}")
