"""The port's spans and counters (``utils.profiling.annotate``/``count``):
nothing while no profiler records, every span of a serving call with its
parent and the runner's counters under ``profiling.trace``, the same
frames, flows and state either way, and ``trace_tools.span_summary`` on a
hand-made trace."""
import collections
import json

import numpy as np
import pytest
import torch

from cista_flow_torch.config import Config
from cista_flow_torch.runner import Reconstructor
from cista_flow_torch.utils import profiling, trace_tools

H, W, STREAMS, STEPS = 64, 96, 2, 3
# span -> the span it lies in (runner.call: the whole call)
PARENT = {"runner.call": None, "runner.upload": "runner.call", "runner.issue": "runner.call",
          "runner.wait": "runner.call", "runner.download": "runner.call",
          "flownet": "runner.issue", "flownet.encode": "flownet",
          "flownet.update": "flownet", "reconstruct": "runner.issue"}
CALLS = [("cista-eiflow", "step"), ("cista-eraft", "step"), ("cista-eraft", "step_window")]


def _recon(mode):
    cfg = Config(image_dim=(H, W), model_mode=mode, depth=1, flow_iters=2)
    return Reconstructor(cfg, device="cpu", batch=STREAMS)


def _voxels(seed=0):
    rng = np.random.default_rng(seed)
    shape = (STEPS, STREAMS, 5, H, W)
    return (rng.standard_normal(shape) * (rng.random(shape) < 0.2)).astype(np.float32)


def _call(recon, entry, voxels):
    """Two calls, as a serving loop makes them: (outputs, host bytes in)."""
    if entry == "step":
        return [recon.step(v) for v in voxels[:2]], voxels[0].nbytes * 2
    return [recon.step_window(voxels, return_all=True) for _ in range(2)], voxels.nbytes * 2


def _boom(*args, **kwargs):
    raise AssertionError("called while no profiler records")


def test_no_profiler_no_ranges_no_waits_no_counts(monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTERS", collections.Counter())
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    for name in ("memory_stats", "Event", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, _boom)
    assert not profiling.enabled()
    assert profiling.annotate("runner.call") is profiling.annotate("flownet")
    with profiling.annotate("flownet"):
        profiling.count("runner.bytes_up", 3)
    rec, flow = _recon("cista-eiflow").step(_voxels()[0])
    assert rec.shape == (STREAMS, H, W) and flow.shape == (STREAMS, 2, H, W)
    assert profiling.counters() == {}


def _spans(events):
    """[(name, start, end)] of the program's spans, host side."""
    return [(e["name"][len(profiling.PREFIX):], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"].startswith(profiling.PREFIX)]


def _parent(span, spans):
    """The innermost other span that holds ``span``."""
    name, a, b = span
    holders = [s for s in spans if s is not span and s[1] <= a and b <= s[2]
               and (s[1], -s[2]) < (a, -b)]
    return max(holders, key=lambda s: (s[1], -s[2]))[0] if holders else None


@pytest.mark.parametrize("mode,entry", CALLS)
def test_traced_call_records_every_span_and_counter(tmp_path, mode, entry):
    recon, voxels = _recon(mode), _voxels()
    with profiling.trace(str(tmp_path)):
        outs, nbytes_in = _call(recon, entry, voxels)
    spans = _spans(trace_tools.load_events(str(tmp_path)))
    assert {s[0] for s in spans} == set(PARENT)
    for s in spans:
        assert _parent(s, spans) == PARENT[s[0]], s
    calls = [s for s in spans if s[0] == "runner.call"]
    assert len(calls) == 2
    steps = 1 if entry == "step" else STEPS
    nbytes_out = sum(a.nbytes + b.nbytes for a, b in outs)
    counters = profiling.counters()
    assert counters == {"runner.bytes_up": nbytes_in, "runner.bytes_down": nbytes_out}
    with open(next(tmp_path.glob("counters_*.json"))) as f:
        assert json.load(f) == counters
    rows = {r[0]: r for r in trace_tools.span_summary(str(tmp_path), runs=2)}
    assert set(rows) == set(PARENT) and rows["runner.call"][1] == 1
    assert rows["reconstruct"][1] == steps and rows["flownet.update"][1] == (
        1 if entry == "step_window" else steps)


@pytest.mark.parametrize("mode,entry", CALLS)
def test_traced_and_untraced_calls_are_bit_identical(tmp_path, mode, entry):
    voxels = _voxels(1)
    plain, traced = _recon(mode), _recon(mode)
    want, _ = _call(plain, entry, voxels)
    with profiling.trace(str(tmp_path)):
        got, _ = _call(traced, entry, voxels)
    for (a, b), (c, d) in zip(want, got):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    for x, y in zip((*plain.state, plain.prev_image, plain.extra),
                    (*traced.state, traced.prev_image, traced.extra)):
        assert (x is None and y is None) or torch.equal(x, y)


def _ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_summary_of_a_hand_made_trace(tmp_path, capsys):
    """Two runs: an upload whose copy's host time is mostly ``aten::copy_``,
    an issue launching two kernels, one in a flow-net span; a flow-net span
    on another thread with its own launch; a launch in no span; each span's
    copy on the device's timeline, which is not a span."""
    events = [
        _ev("cista.runner.call", "user_annotation", 0, 1000),
        _ev("cista.runner.upload", "user_annotation", 10, 100),
        _ev("aten::copy_", "cpu_op", 20, 80),
        _ev("cudaMemcpyAsync", "cuda_runtime", 80, 15, corr=1),
        _ev("cista.runner.issue", "user_annotation", 200, 500),
        _ev("cista.flownet", "user_annotation", 205, 50),
        _ev("cudaLaunchKernel", "cuda_runtime", 210, 10, corr=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 300, 10, corr=3),
        _ev("cudaLaunchKernel", "cuda_runtime", 1100, 10, corr=4),
        _ev("cista.flownet", "user_annotation", 0, 400, tid=2),
        _ev("cudaLaunchKernel", "cuda_runtime", 100, 10, tid=2, corr=5),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 50, tid=7, corr=1),
        _ev("k2", "kernel", 230, 100, tid=7, corr=2),
        _ev("k3", "kernel", 340, 40, tid=7, corr=3),
        _ev("k4", "kernel", 1120, 30, tid=7, corr=4),
        _ev("k5", "kernel", 400, 8, tid=7, corr=5),
        _ev("cista.runner.issue", "gpu_user_annotation", 230, 150, tid=7),
    ]
    with open(tmp_path / "trace_1.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    with open(tmp_path / "counters_1.json", "w") as f:
        json.dump({"runner.bytes_up": 200000, "runner.bytes_down": 100000}, f)
    rows = {r[0]: r[1:] for r in trace_tools.span_summary(str(tmp_path), runs=2)}
    # per run: spans, host ms, device ms, launches, top op, its ms
    assert rows["runner.call"] == pytest.approx((0.5, 0.5, 0.095, 1.0, "aten::copy_", 0.0325))
    assert rows["runner.upload"] == pytest.approx((0.5, 0.05, 0.025, 0.0, "aten::copy_", 0.0325))
    assert rows["runner.issue"] == pytest.approx(
        (0.5, 0.25, 0.07, 1.0, "cudaLaunchKernel", 0.01))
    assert rows["flownet"] == pytest.approx((1.0, 0.225, 0.054, 1.0, "cudaLaunchKernel", 0.01))
    assert list(rows) == ["runner.call", "flownet", "runner.upload", "runner.issue"]
    trace_tools.print_spans(str(tmp_path), runs=2)
    out = capsys.readouterr().out
    assert "runner.upload" in out and "counter runner.bytes_up: 100000.0 per run" in out
    # 150,000 bytes a run over the upload's 0.05 host ms a run (no download span here)
    assert "host copies 3.000 GB/s" in out
