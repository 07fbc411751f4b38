"""The runner's host copies (``runner.Staging``, ``Reconstructor._upload``
and ``_download``): the chunked fill is the plain conversion bit for bit,
the staging tensor is made again only for another shape or dtype, and a
CPU reconstructor keeps the plain copies and calls nothing of CUDA. The
``cuda`` tests hold the page-locked path on the card: the device voxels,
returned arrays that no later call writes, no page-locked allocation in
steady state, and ``runner.bytes_staged`` against the byte counters. Run
them on the card with ``python -m pytest tests/test_torch_runner_staging.py
-m cuda``."""
import collections

import numpy as np
import pytest
import torch

from cista_flow_torch.config import Config
from cista_flow_torch.runner import Reconstructor, Staging, chunks
from cista_flow_torch.utils import profiling

H, W, BINS = 48, 64, 5
# (T, B): one step of 3 streams (3 chunks), a window of 5 steps (5), one step of one stream (1)
SHAPES = [(1, 3), (5, 2), (1, 1)]


def _voxels(t, b, seed=0, bins=BINS):
    rng = np.random.default_rng(seed)
    shape = (t, b, bins, H, W)
    # magnitudes over many binades, so bf16 rounds in every way
    v = rng.standard_normal(shape) * np.exp2(rng.integers(-12, 12, shape))
    return (v * (rng.random(shape) < 0.5)).astype(np.float32)


def _events(t, b, seed=0):
    """Voxels as a camera gives them: sparse, of unit scale."""
    rng = np.random.default_rng(seed)
    shape = (t, b, BINS, H, W)
    return (rng.standard_normal(shape) * (rng.random(shape) < 0.2)).astype(np.float32)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,b", SHAPES)
def test_chunked_fill_is_the_plain_conversion(dtype, t, b):
    v = _voxels(t, b, seed=t * 10 + b)
    assert len(chunks(v)) == (b if t == 1 else t)
    got = Staging(pinned=False).fill(v, dtype)
    assert got.shape == v.shape
    assert _bits_equal(got, torch.from_numpy(v).to(dtype))


def test_staging_is_made_again_only_for_another_shape_or_dtype(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTERS", collections.Counter())
    stage = Staging(pinned=False)
    step, window = _voxels(1, 3), _voxels(5, 2)
    stage.fill(step, torch.bfloat16)               # no profiler: made, not counted
    first = stage.host
    assert profiling.counters() == {}
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            stage.fill(step, torch.bfloat16)
        assert stage.host is first
        assert profiling.counters().get("runner.host_allocs", 0) == 0
        stage.fill(step, torch.float32)            # another dtype
        stage.fill(step, torch.float32)
        assert profiling.counters()["runner.host_allocs"] == 1
        stage.fill(window, torch.float32)          # another shape
        stage.fill(window, torch.float32)
        stage.fill(step, torch.bfloat16)           # back to the first: made again
        assert profiling.counters()["runner.host_allocs"] == 3
    assert stage.host is not first and _bits_equal(stage.host, first)


def _recon(mode, dtype, device, batch):
    cfg = Config(image_dim=(H, W), model_mode=mode, depth=1, flow_iters=2, dtype=dtype)
    torch.manual_seed(0)
    return Reconstructor(cfg, device=device, batch=batch)


def _boom(*args, **kwargs):
    raise AssertionError("called off the card")


@pytest.mark.parametrize("mode,dtype", [("cista-eiflow", "float32"),
                                        ("cista-eraft", "bfloat16")])
def test_cpu_reconstructor_keeps_the_plain_copies(monkeypatch, mode, dtype):
    """``step`` and ``step_window`` on the CPU return what the plain
    ``.to`` and ``.cpu()`` give around ``run_step`` and ``run_window``, and
    call nothing of CUDA and no staging, with no profiler."""
    for name in ("Event", "synchronize", "current_stream", "memory_stats",
                 "host_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, _boom, raising=False)
    monkeypatch.setattr(Staging, "fill", _boom)
    got, want = _recon(mode, dtype, "cpu", 2), _recon(mode, dtype, "cpu", 2)
    v = _events(3, 2, seed=4)
    dt = want.dtype
    for t in range(2):
        rec, flow = got.step(v[t])
        r, f = want.run_step(torch.from_numpy(v[t]).to("cpu", dt))
        assert np.array_equal(rec, r[:, 0].float().numpy())
        assert np.array_equal(flow, f.float().numpy())
    recs, flows = got.step_window(v, return_all=True)
    r, f = want.run_window(torch.from_numpy(v).to("cpu", dt))
    assert np.array_equal(recs, r[:, :, 0].float().numpy())
    assert np.array_equal(flows, f.float().numpy())
    assert profiling.counters() == {}


# ---- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked copies and the port's kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("t,b", SHAPES)
def test_card_uploads_are_the_plain_copies(card, dtype, t, b):
    recon = _recon("cista-eiflow", dtype, "cuda", b)
    for seed in range(3):                          # the staging tensor reused
        v = _voxels(t, b, seed)
        assert _bits_equal(recon.device_events(v),
                           torch.from_numpy(v).to("cuda", recon.dtype))
        f = _voxels(t, b, seed, bins=2)
        assert _bits_equal(recon.device_flows(f, t, True), torch.from_numpy(f).to("cuda"))


def _spy(recon, name, outs):
    """Keeps the host copy (``.cpu()``) of each device output of
    ``recon.<name>`` (``run_step`` or ``run_window``)."""
    run = getattr(recon, name)

    def spied(*args):
        recs, flows = run(*args)
        frames = recs[:, 0] if name == "run_step" else recs[:, :, 0]
        outs.append((frames.float().cpu().numpy(), flows.float().cpu().numpy()))
        return recs, flows
    setattr(recon, name, spied)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,entry", [("cista-eiflow", "step"), ("cista-eraft", "step"),
                                        ("cista-eraft", "step_window")])
def test_card_returned_arrays_are_never_written_again(card, mode, entry):
    recon = _recon(mode, "bfloat16", "cuda", 2)
    device_outs, kept = [], []
    _spy(recon, "run_step" if entry == "step" else "run_window", device_outs)
    for call in range(4):
        v = _events(3, 2, seed=call)
        out = recon.step(v[0]) if entry == "step" else recon.step_window(v, return_all=True)
        kept.append((out, tuple(a.copy() for a in out)))
    for (out, copies), want in zip(kept, device_outs):
        for a, c, d in zip(out, copies, want):
            assert np.array_equal(a, c)            # no later call wrote it
            assert np.array_equal(a, d)            # the device output's .cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["step", "step_window"])
def test_card_steady_state_makes_no_page_locked_allocation(card, tmp_path, monkeypatch, entry):
    """As the benchmark's closed loop: a warm-up call dropped, 8 calls kept
    whole, then calls whose arrays are dropped after a copy of a slice. The
    first of those takes a ninth set of blocks, as the 8 kept calls hold
    theirs; from then on each call takes the blocks the previous one gave
    back."""
    monkeypatch.setattr(profiling, "_COUNTERS", collections.Counter())
    recon = _recon("cista-eraft", "bfloat16", "cuda", 2)
    v = _events(3, 2)

    def call():
        return recon.step(v[0]) if entry == "step" else recon.step_window(v, return_all=True)
    call()
    kept = [call() for _ in range(8)]
    call()
    with profiling.trace(str(tmp_path)):
        for _ in range(10):
            out = call()
            kept.append(tuple(np.ascontiguousarray(a[..., :4, :4]) for a in out))
            del out
    counters = profiling.counters()
    assert counters["runner.bytes_staged"] > 0
    assert counters.get("runner.host_allocs", 0) == 0, counters


@pytest.mark.cuda
def test_card_bytes_staged_are_bytes_up_and_down(card, tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_COUNTERS", collections.Counter())
    recon = _recon("cista-eiflow", "bfloat16", "cuda", 2)
    v, f = _events(3, 2), np.ascontiguousarray(_events(3, 2)[:, :, :2])  # f: (T, B, 2, H, W)
    with profiling.trace(str(tmp_path)):
        recon.step(v[0], f[0], use_gt_flow=True)
        recon.step_window(v, f, use_gt_flow=True, return_all=True)
        recon.step_window(v)
    c = profiling.counters()
    assert c["runner.bytes_up"] == 2 * v.nbytes + v[0].nbytes + f.nbytes + f[0].nbytes
    assert c["runner.bytes_staged"] == c["runner.bytes_up"] + c["runner.bytes_down"]
