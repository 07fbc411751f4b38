"""The whole serving slice: the port's ``Reconstructor.step_window`` against
the JAX package's, on the CPU in f32, with the committed gate weights.

The weights do not depend on the frame size, so a small frame (48x64,
padded to 64x64 by the flow net) keeps the closed loop cheap. Tolerance on
the 3-step closed loop: 1e-3 abs on frames and flows (f32 differences of
the two packages feed back through the recurrence and the warps).
"""
from pathlib import Path

import numpy as np
import pytest

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.runner import Reconstructor as JReconstructor
from cista_flow_torch.config import Config
from cista_flow_torch.runner import Reconstructor

H, W = 48, 64
T = 3
GATE = Path(__file__).resolve().parent.parent / "gate"
POINTS = [(str(GATE / "flagship_ft1_f16.npz"), 1, 1),
          (str(GATE / "flagship_sim40_f16.npz"), 6, 5)]


def _voxels(seed, t=T, batch=None):
    rng = np.random.default_rng(seed)
    shape = (t, 5, H, W) if batch is None else (t, batch, 5, H, W)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("path,iters,depth", POINTS)
def test_step_window_matches_jax(path, iters, depth):
    voxels = _voxels(0)
    jr = JReconstructor(JConfig(image_dim=(H, W), model_mode="cista-eiflow",
                                depth=depth, flow_iters=iters, path_to_test_model=path))
    jrecs, jflows = jr.step_window(list(voxels), return_all=True)
    tr = Reconstructor(Config(image_dim=(H, W), depth=depth, flow_iters=iters,
                              path_to_test_model=path), device="cpu")
    recs, flows = tr.step_window(voxels, return_all=True)
    assert recs.shape == (T, H, W) and flows.shape == (T, 2, H, W)
    np.testing.assert_allclose(recs, jrecs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(flows, jflows, rtol=0, atol=1e-3)
    # the carried state agrees too: the step after the window matches
    nxt = _voxels(1, 1)[0]
    np.testing.assert_allclose(tr.step(nxt)[0], jr.step(nxt)[0], rtol=0, atol=1e-3)


def test_step_window_equals_sequential_steps():
    cfg = Config(image_dim=(H, W), depth=1, flow_iters=1,
                 path_to_test_model=POINTS[0][0])
    voxels = _voxels(2)
    r1 = Reconstructor(cfg, device="cpu")
    seq = [r1.step(v) for v in voxels]
    r2 = Reconstructor(cfg, device="cpu")
    recs, flows = r2.step_window(voxels, return_all=True)
    for t in range(T):
        np.testing.assert_allclose(recs[t], seq[t][0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(flows[t], seq[t][1], rtol=0, atol=1e-6)
    r2.reset()
    np.testing.assert_allclose(r2.step(voxels[0])[0], seq[0][0], rtol=0, atol=1e-6)


def test_batched_streams_match_single_streams():
    """A batch of streams computes each stream as alone (the chip's frames/s
    are measured at batch 8)."""
    cfg = Config(image_dim=(H, W), depth=1, flow_iters=1,
                 path_to_test_model=POINTS[0][0])
    voxels = _voxels(3, batch=2)
    recs, flows = Reconstructor(cfg, device="cpu", batch=2).step_window(
        voxels, return_all=True)
    for b in range(2):
        r, f = Reconstructor(cfg, device="cpu").step_window(voxels[:, b], return_all=True)
        np.testing.assert_allclose(recs[:, b], r, rtol=0, atol=1e-5)
        np.testing.assert_allclose(flows[:, b], f, rtol=0, atol=1e-5)


def test_bf16_stays_close_to_f32():
    """bf16 serving against f32 over the closed loop: above 30 dB PSNR per
    step, the JAX package's drift rule (tests/test_bf16_drift.py)."""
    voxels = _voxels(4)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config(image_dim=(H, W), depth=1, flow_iters=1, dtype=dtype,
                     path_to_test_model=POINTS[0][0])
        out[dtype], _ = Reconstructor(cfg, device="cpu").step_window(voxels, return_all=True)
    assert np.isfinite(out["bfloat16"]).all()
    for a, b in zip(out["float32"], out["bfloat16"]):
        psnr = 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
        assert psnr > 30.0, psnr


def test_other_modes_are_refused():
    with pytest.raises(ValueError, match="not ported"):
        Reconstructor(Config(image_dim=(H, W), model_mode="cista-idnet"), device="cpu")


def test_frame_under_64_px_matches_jax():
    """A 32x48 frame pads to 32x64, so the 1/8-res map is 4x8 and the
    correlation pyramid's last level is empty (0x1): it contributes zeros in
    both packages. 1e-3 over a 2-step closed loop, as above."""
    path, iters, depth = POINTS[0]
    rng = np.random.default_rng(5)
    voxels = rng.standard_normal((2, 5, 32, 48)).astype(np.float32)
    jr = JReconstructor(JConfig(image_dim=(32, 48), model_mode="cista-eiflow",
                                depth=depth, flow_iters=iters, path_to_test_model=path))
    jrecs, jflows = jr.step_window(list(voxels), return_all=True)
    tr = Reconstructor(Config(image_dim=(32, 48), depth=depth, flow_iters=iters,
                              path_to_test_model=path), device="cpu")
    recs, flows = tr.step_window(voxels, return_all=True)
    assert np.abs(flows).max() > 0
    np.testing.assert_allclose(recs, jrecs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(flows, jflows, rtol=0, atol=1e-3)
