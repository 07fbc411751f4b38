"""The metric readers: a rate is all the work over all the time, a tail
is over every call, the traced shares from one trace."""
import numpy as np
import pytest

from harness import BENCH, Run
from tracing import Trace, load_files

METRICS = load_files(BENCH / "metrics")


def _run(latencies, streams=4, steps=1):
    run = Run()
    run.latencies = list(latencies)
    run.calls = len(latencies)
    run.frames = run.calls * streams * steps
    run.window_s = sum(latencies)
    return run


def test_rate_is_all_frames_over_all_the_window():
    run = _run([0.03] * 99 + [0.5])          # one slow call stays in the rate
    assert METRICS["frames_per_s"].read(run) == pytest.approx(400 / (99 * 0.03 + 0.5))


def test_tail_is_taken_over_every_call():
    lat = [0.01] * 90 + [0.1] * 10
    run = _run(lat)
    assert METRICS["latency_ms_p95"].read(run) == pytest.approx(np.percentile(lat, 95) * 1e3)
    assert METRICS["latency_ms_p95"].read(run) == pytest.approx(100.0)


def test_no_calls_reads_nothing():
    assert METRICS["frames_per_s"].read(_run([])) is None
    assert METRICS["latency_ms_p95"].read(_run([])) is None


def _event(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(kernel_calls):
    """A 1000 us slice: a K5 range launching one 100 us kernel, a plain
    kernel of 200 us, a 50 us copy, the host waiting in a synchronise."""
    events = [
        _event("bench:window", "user_annotation", 0, 1000),
        _event("bench:K5", "user_annotation", 10, 20),
        _event("cudaLaunchKernel", "cuda_runtime", 12, 5, corr=1),
        _event("aten::add", "cpu_op", 40, 30),
        _event("cudaLaunchKernel", "cuda_runtime", 45, 5, corr=2),
        _event("cudaStreamSynchronize", "cuda_runtime", 100, 600),
        _event("conv3x3_mma_kernel", "kernel", 50, 100, tid=7, corr=1),
        _event("add_kernel", "kernel", 300, 200, tid=7, corr=2),
        _event("Memcpy DtoH", "gpu_memcpy", 600, 50, tid=7),
    ]
    return Trace(events, kernel_calls, {"flownet": 30.0, "cista": 12.0})


def _traced_run(kernel_calls=()):
    run = _run([0.0005, 0.0005], streams=4)
    run.trace = _trace(list(kernel_calls))
    run.traced_steps, run.traced_frames = 2, 8
    run.flops_per_frame = 1e9
    return run


def test_traced_shares():
    run = _traced_run([("K5", 3.35e6 * 50, 0.0, "bfloat16")])    # 50 us of bytes
    tr = run.trace
    assert tr.busy_s == pytest.approx(350e-6)
    assert METRICS["device_idle_pct"].read(run) == pytest.approx(65.0)
    assert METRICS["copy_ms_per_step"].read(run) == pytest.approx(0.025)
    assert METRICS["kernel_roofline_pct"].read(run) == pytest.approx(50.0)
    # host: the whole slice but the 600 us synchronise, over 2 steps
    assert METRICS["host_ms_per_step"].read(run) == pytest.approx(0.2)
    assert METRICS["flownet_ms_per_step"].read(run) == pytest.approx(15.0)
    assert METRICS["cista_ms_per_step"].read(run) == pytest.approx(6.0)
    assert METRICS["mfu_pct"].read(run) == pytest.approx(100 * 8e9 / (1e-3 * 989e12))
    gaps = dict(tr.idle_gaps())
    assert gaps["cudaStreamSynchronize"] == pytest.approx(150e-6 + 100e-6 + 50e-6)
    assert gaps["host: between operations"] == pytest.approx(10e-6 + 10e-6 + 300e-6)
    assert gaps["bench:K5"] == pytest.approx(15e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["aten::add"] == pytest.approx(5e-6)
    assert sum(gaps.values()) == pytest.approx(1e-3 - tr.busy_s)
    assert [k for k, _ in tr.top_device_ops()] == ["add_kernel", "conv3x3_mma_kernel",
                                                    "Memcpy DtoH"]


def test_a_reader_with_nothing_to_read_returns_nothing():
    run = _run([0.03, 0.03])
    for name, mod in METRICS.items():
        if mod.KIND == "per_layer":
            assert mod.read(run) is None, name
    assert METRICS["kernel_roofline_pct"].read(_traced_run()) is None
