"""The port's eval metrics against the JAX package's, on the CPU in f32:
SSIM, PSNR, ``recon_evaluate``, ``validity_mask`` and ``flow_evaluate``
within 1e-5 (f32 sums in another order), and the eval's ``compare`` and
``mean_metrics`` against ``eval_harness``'s.

Images come from a numpy seed: a smooth frame and a noisy copy (SSIM's
variances cancel on smooth areas), locally flat frames (the case the JAX
package's HIGHEST-precision blur was made for), flows that reach out of the
frame, a GT flow with zeros (the out% division) and one past MAX_FLOW.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval_harness
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_torch import evaluate
from cista_flow_torch.config import Config
from cista_flow_torch.losses import flow_evaluate, psnr, recon_evaluate, ssim, validity_mask

# the modules themselves: the package's __init__ rebinds ``ssim`` to the function
JFLOW = importlib.import_module("cista_flow_tpu.losses.flow")
JRECON = importlib.import_module("cista_flow_tpu.losses.recon")
JSSIM = importlib.import_module("cista_flow_tpu.losses.ssim")
ATOL = 1e-5
# SSIM of a locally flat frame against itself plus 1e-3 noise: the
# variances (~1e-6) come from E[x^2] - mu^2 at x ~ 0.5 in f32, and each
# package lands 1e-5 to 4e-5 from the float64 value (JAX -1.5e-5, the port
# +3.3e-5), so the two are held to 1e-4 there
ATOL_FLAT_SSIM = 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def _images(kind, h=36, w=52, b=2, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 10.0
    base = 0.5 + 0.3 * np.sin(xx + 0.5 * yy)[None, ..., None] + np.zeros((b, 1, 1, 1))
    if kind == "flat":
        base = np.where(xx < w / 20.0, 0.3, 0.7)[None, ..., None] + np.zeros((b, 1, 1, 1))
        other = base + 1e-3 * rng.standard_normal(base.shape)
    elif kind == "equal":
        other = base
    else:
        other = np.clip(base + 0.05 * rng.standard_normal(base.shape), 0, 1)
    return base.astype(np.float32), other.astype(np.float32)


@pytest.mark.parametrize("kind", ["noisy", "flat", "equal"])
def test_recon_metrics(kind):
    a, b = _images(kind)
    ref = JRECON.recon_evaluate(jnp.asarray(a), jnp.asarray(b))
    out = recon_evaluate(nchw(a), nchw(b))
    assert list(out) == ["mse", "psnr", "ssim"] == list(ref)
    tol = {"mse": ATOL, "psnr": 100 * ATOL,
           "ssim": ATOL_FLAT_SSIM if kind == "flat" else ATOL}
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=0, atol=tol[k], err_msg=k)
    np.testing.assert_allclose(float(ssim(nchw(a), nchw(b))),
                               float(JSSIM.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=0,
                               atol=tol["ssim"])
    np.testing.assert_allclose(float(psnr(nchw(a), nchw(b))),
                               float(JRECON.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=0,
                               atol=1e-3)
    if kind == "equal":
        assert float(out["psnr"]) == 100.0 and abs(float(out["ssim"]) - 1.0) < 1e-6


def _flows(h=36, w=52, b=2, seed=1):
    rng = np.random.default_rng(seed)
    gt = (3 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    gt[0, :4, :4] = 0.0                       # zero magnitude: epe / mag is inf or nan
    gt[-1, 0, 0] = (500.0, 0.0)               # past MAX_FLOW: not valid
    pred = (gt + rng.standard_normal(gt.shape) * np.array([0.3, 4.0])[None, :, None, None]
            .reshape(1, 1, 1, 2)).astype(np.float32)
    pred[0, -1, -6:] = (40.0, -30.0)          # samples that fold back into the frame
    return gt, pred


def test_validity_mask():
    a, b = _images("noisy")
    gt, _ = _flows()
    ref = JFLOW.validity_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(gt))
    out = validity_mask(nchw(a), nchw(b), nchw(gt))
    np.testing.assert_allclose(np.moveaxis(out.numpy(), 1, -1), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("flow_valid", [False, True])
def test_flow_evaluate(flow_valid):
    a, b = _images("noisy")
    gt, pred = _flows()
    jt = {"gt_img0": jnp.asarray(a), "gt_img1": jnp.asarray(b), "gt_flow": jnp.asarray(gt)}
    tt = {"gt_img0": nchw(a), "gt_img1": nchw(b), "gt_flow": nchw(gt)}
    if flow_valid:
        v = (np.random.default_rng(2).random(a.shape) > 0.3).astype(np.float32)
        jt["flow_valid"], tt["flow_valid"] = jnp.asarray(v), nchw(v)
    ref = JFLOW.flow_evaluate(jnp.asarray(pred), jt, JConfig())
    out = flow_evaluate(nchw(pred), tt, Config(model_mode="cista-eiflow"))
    assert list(out) == list(ref) == ["photo_loss", "epe", "1px", "3px", "5px", "out"]
    assert 0.0 < float(ref["3px"]) < 1.0 and float(ref["out"]) > 0.0
    for k in out:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=0,
                                   atol=ATOL * (100 if k == "out" else 1), err_msg=k)


def test_score_matches_the_jax_eval_step():
    """``evaluate.score`` on host arrays, as the JAX eval scores one step."""
    a, b = _images("noisy", b=1)
    gt, pred = _flows(b=1)
    rec = np.clip(b[0, ..., 0] + 0.02, 0, 1)
    out = evaluate.score(rec, np.moveaxis(pred[0], -1, 0), a[0, ..., 0], b[0, ..., 0],
                         np.moveaxis(gt[0], -1, 0), Config(model_mode="cista-eiflow"))
    jt = {"gt_img0": jnp.asarray(a), "gt_img1": jnp.asarray(b), "gt_flow": jnp.asarray(gt)}
    ref = {**JRECON.recon_evaluate(jnp.asarray(rec)[None, ..., None], jt["gt_img1"]),
           **JFLOW.flow_evaluate(jnp.asarray(pred), jt, JConfig())}
    assert list(out) == list(ref)
    for k in out:
        np.testing.assert_allclose(out[k], float(ref[k]), rtol=0, atol=1e-3 if k in
                                   ("psnr", "out") else ATOL, err_msg=k)


@pytest.mark.parametrize("tolerance", [0.002, 0.01])
def test_compare_and_mean_metrics_match_eval_harness(tolerance):
    keys = ["mse", "psnr", "3px", "out"]
    rows = [["sim_00", 0.0035, 24.6, 0.0, 0.0, 26], ["sim_01", 0.0039, 24.1, 0.0, 0.0, 26],
            ["mean", 0.0037, 24.3763, 0.0, 0.0, 52]]
    measured = evaluate.mean_metrics(rows, keys)
    assert measured == eval_harness.mean_metrics(rows, keys)
    cases = [{"mse": 0.0037, "psnr": 24.3763, "3px": 0.0, "out": 0.0},
             {"mse": 0.0038, "psnr": 24.40, "3px": 1e-6, "out": 0.0},
             {"mse": 0.0037, "psnr": 24.3763, "3px": 0.0, "lpips": 0.1}]
    for targets in cases:
        assert evaluate.compare(measured, targets, tolerance) == \
            eval_harness.compare(measured, targets, tolerance)
    assert evaluate.compare(measured, cases[0], tolerance)[0]
    assert not evaluate.compare(measured, cases[1], tolerance)[0]
    with pytest.raises(AssertionError):
        evaluate.mean_metrics(rows[:-1], keys)
