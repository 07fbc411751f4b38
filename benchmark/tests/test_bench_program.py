"""The benchmark with the program's own spans and counters in its traced
slice: the counter reader by hand, the benchmark's readers unmoved by the
spans, and the idle time inside a call named by the program's spans."""
import collections
import json
import sys
import types

import pytest

import harness
import traffic
from conftest import tiny_cell
from harness import BENCH, Run
from tracing import Trace, Tracer, load_files

METRICS = load_files(BENCH / "metrics")
OWN = ("host_ms_per_step", "copy_ms_per_step", "flownet_ms_per_step", "cista_ms_per_step",
       "kernel_roofline_pct", "device_idle_pct", "mfu_pct")
PROFILING = "cista_flow_torch.utils.profiling"
BETWEEN = "host: between operations"


def _event(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """A 1000 us slice of two steps. Main thread: a call (2-950) holding an
    upload (2-8), an issue (8-90) with a flow net (9-35) whose update
    (10-31) launches a 100 us kernel inside a K5 range, a reconstruction
    (38-75) launching a 200 us kernel, a wait (95-705) in a synchronise, a
    download (705-760); a launch after the issue (800, 20 us) and one after
    the call (960, 10 us). The device also copies 50 us with no launch, and
    shows copies of two spans on its own timeline."""
    return [
        _event("bench:window", "user_annotation", 0, 1000),
        _event("cista.runner.call", "user_annotation", 2, 948),
        _event("cista.runner.upload", "user_annotation", 2, 6),
        _event("cista.runner.issue", "user_annotation", 8, 82),
        _event("cista.flownet", "user_annotation", 9, 26),
        _event("cista.flownet.update", "user_annotation", 10, 21),
        _event("bench:K5", "user_annotation", 10, 20),
        _event("cudaLaunchKernel", "cuda_runtime", 12, 5, corr=1),
        _event("cista.reconstruct", "user_annotation", 38, 37),
        _event("aten::add", "cpu_op", 40, 30),
        _event("cudaLaunchKernel", "cuda_runtime", 45, 5, corr=2),
        _event("cista.runner.wait", "user_annotation", 95, 610),
        _event("cudaStreamSynchronize", "cuda_runtime", 100, 600),
        _event("cista.runner.download", "user_annotation", 705, 55),
        _event("cudaLaunchKernel", "cuda_runtime", 800, 5, corr=3),
        _event("cudaLaunchKernel", "cuda_runtime", 960, 5, corr=4),
        _event("conv3x3_mma_kernel", "kernel", 50, 100, tid=7, corr=1),
        _event("add_kernel", "kernel", 300, 200, tid=7, corr=2),
        _event("Memcpy DtoH", "gpu_memcpy", 600, 50, tid=7),
        _event("fill_kernel", "kernel", 810, 20, tid=7, corr=3),
        _event("tail_kernel", "kernel", 970, 10, tid=7, corr=4),
        _event("cista.runner.issue", "gpu_user_annotation", 50, 450, tid=7),
        _event("cista.flownet", "gpu_user_annotation", 50, 250, tid=7),
    ]


def _traced_run(events):
    run = Run()
    run.latencies, run.calls, run.frames, run.window_s = [0.0005, 0.0005], 2, 8, 0.001
    run.trace = Trace(events, [("K5", 3.35e6 * 50, 0.0, "bfloat16")],
                      {"flownet": 30.0, "cista": 12.0})
    run.traced_steps, run.traced_frames = 2, 8
    run.flops_per_frame = 1e9
    return run


def _program(monkeypatch, counters):
    """The program's profiling module as the reader finds it loaded."""
    mod = types.ModuleType(PROFILING)
    if counters is not None:
        mod.counters = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, PROFILING, mod)


def test_device_allocs_by_hand(monkeypatch):
    _program(monkeypatch, {"runner.bytes_up": 6000, "runner.device_allocs": 3})
    assert METRICS["device_allocs_per_step"].read(_traced_run(_events())) == 1.5


@pytest.mark.parametrize("counters", [None, {}, {"runner.bytes_up": 6000}])
def test_device_allocs_reads_nothing_without_the_counter(monkeypatch, counters):
    """A program before the counters, or one that counted none (off the
    card), reads nothing; so does a run with no traced slice."""
    _program(monkeypatch, counters)
    assert METRICS["device_allocs_per_step"].read(_traced_run(_events())) is None
    _program(monkeypatch, {"runner.device_allocs": 3})
    assert METRICS["device_allocs_per_step"].read(Run()) is None


def test_own_readers_read_the_same_with_the_program_spans():
    with_spans = _traced_run(_events())
    without = _traced_run([e for e in _events() if not e["name"].startswith("cista.")])
    got = {k: METRICS[k].read(with_spans) for k in OWN}
    assert got == {k: METRICS[k].read(without) for k in OWN}
    assert all(v is not None for v in got.values())


def test_idle_time_in_a_call_is_named_by_the_program():
    gaps = dict(_traced_run(_events()).trace.idle_gaps())
    # idle outside the call only: 0-2, 950-960, 965-970, 980-1000
    assert gaps[BETWEEN] == pytest.approx(37e-6)
    # the call's own time between its spans: 760-800, 805-810, 830-950
    assert gaps["cista.runner.call"] == pytest.approx((40 + 5 + 120) * 1e-6)


def test_a_traced_cpu_slice_names_its_idle_time_by_the_program(tmp_path, monkeypatch):
    """Two calls of a tiny cell on the CPU, traced by the benchmark's own
    tracer (opened and closed around them, not by the clock): every instant
    inside a ``cista.runner.call`` belongs to a program span or an
    operation, never to the time between operations; off the card the
    program counts no device allocations."""
    from cista_flow_torch.utils import profiling
    monkeypatch.setattr(profiling, "_COUNTERS", collections.Counter())
    cell, cfg, mix = tiny_cell("eiflow-live-vga-b8", 48, 64)
    pool = traffic.make_pool(7, mix, "cpu")
    recon = harness.build_program(cfg, mix, "cpu")
    call = harness.port_call(recon, cell["entry"], mix["streams"])
    call(pool[0])
    tracer = Tracer(recon.model, load_files(BENCH / "kernels"), METRICS, 2)
    tracer.begin()
    for voxels in pool[:2]:
        call(voxels)
    tracer.end(2)
    path = str(tmp_path / "slice.json")
    tracer.prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == "cista.runner.call" and e.get("cat") == "user_annotation"]
    assert len(calls) == 2
    trace = Trace(events, tracer.kernels.calls, tracer.timer.ms())     # as ``read`` makes it
    between = [(a, b) for a, b, name in trace.host_self if name == BETWEEN]
    assert not [s for s in between for c in calls if s[0] < c[1] and c[0] < s[1]]
    names = {name for name, _ in trace.idle_gaps(n=100)}
    assert {"cista.runner.upload", "cista.flownet.update"} <= names
    run = Run()
    run.trace, run.traced_steps = trace, 2
    assert METRICS["device_allocs_per_step"].read(run) is None
    assert profiling.counters()["runner.bytes_up"] == pool[0].nbytes + pool[1].nbytes
    assert not profiling.enabled()
