"""The port's training losses against the JAX package's on the CPU, in f32:
``flow_sequence_loss`` (same resolution, lower resolution, the pseudo-feature
term, the bidirectional half), ``recon_loss`` (consistency on and off) and
``flow_recon_loss`` in each mode, at 48x64, and their gradients with respect
to the reconstruction and the flow predictions against ``jax.grad``.

Inputs come from a numpy seed. Tolerance: 1e-5 relative on the losses (f32
sums of a few thousand terms in another order), and 1e-5 of each gradient's
largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.losses import flow as JF
from cista_flow_tpu.losses import recon as JR
from cista_flow_tpu.ops.pad import ImagePadder as JPadder
from cista_flow_tpu.ops.resize import resize_bilinear as jresize
from cista_flow_tpu.ops.warp import frame_warp as jwarp
from cista_flow_torch.config import Config
from cista_flow_torch.losses import flow as TF
from cista_flow_torch.losses import recon as TR

H, W = 48, 64          # padded to 64x64 by the flow loss
HP, WP = 64, 64
RTOL = 1e-5


def nchw(a):
    a = np.asarray(a)
    axes = (0, 1, 4, 2, 3) if a.ndim == 5 else (0, 3, 1, 2)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, axes)))


def nhwc(t):
    a = t.detach().numpy()
    return np.transpose(a, (0, 1, 3, 4, 2) if a.ndim == 5 else (0, 2, 3, 1))


def _inputs(seed, bi=False, iters=3, pred_hw=(HP, WP)):
    """NHWC numpy: the targets, flow_preds (iters, B, h, w, 2), features."""
    rng = np.random.default_rng(seed)
    b = 2
    img0 = rng.random((b, H, W, 1)).astype(np.float32)
    tgt = {"gt_img0": img0,
           "gt_img1": np.clip(img0 + 0.1 * rng.standard_normal(img0.shape), 0, 1
                              ).astype(np.float32),
           "gt_flow": (2.0 * rng.standard_normal((b, H, W, 2))).astype(np.float32)}
    flow = {"flow_preds": (2.0 * rng.standard_normal((iters, b, *pred_hw, 2))).astype(np.float32),
            "fmap2_pseudo": rng.standard_normal((b, 8, 8, 16)).astype(np.float32),
            "fmap2_gt": rng.standard_normal((b, 8, 8, 16)).astype(np.float32)}
    if bi:
        tgt["gt_flow_bw"] = (2.0 * rng.standard_normal((b, H, W, 2))).astype(np.float32)
        flow["flow_preds_bw"] = (2.0 * rng.standard_normal((iters, b, *pred_hw, 2))
                                 ).astype(np.float32)
        flow["fmap1_pseudo"] = rng.standard_normal((b, 8, 8, 16)).astype(np.float32)
        flow["fmap1_gt"] = rng.standard_normal((b, 8, 8, 16)).astype(np.float32)
    out = rng.random((b, H, W, 1)).astype(np.float32)
    prev = rng.random((b, H, W, 1)).astype(np.float32)
    return tgt, flow, out, prev


def _cfgs(is_bi=False, warp_mode="forward"):
    return (JConfig(image_dim=(H, W), is_bi=is_bi, warp_mode=warp_mode),
            Config(image_dim=(H, W), is_bi=is_bi, warp_mode=warp_mode))


def _close_grad(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("case", ["same_res", "lower_res", "no_pseudo", "is_bi", "backward_warp"])
def test_flow_sequence_loss_matches_jax(case):
    bi = case == "is_bi"
    jcfg, tcfg = _cfgs(bi, "backward" if case == "backward_warp" else "forward")
    pred_hw = (HP // 2, WP // 2) if case == "lower_res" else (HP, WP)
    tgt, flow, _, _ = _inputs(1, bi, pred_hw=pred_hw)
    if case == "no_pseudo":
        del flow["fmap2_pseudo"], flow["fmap2_gt"]
    rng = np.random.default_rng(2)
    tgt["valid"] = rng.random((2, H, W, 1)).astype(np.float32)
    if bi:
        tgt["valid_bw"] = rng.random((2, H, W, 1)).astype(np.float32)

    def jloss(preds):
        if case == "lower_res":
            return _jax_lower_res_loss(preds, flow, tgt)
        return JF.flow_sequence_loss(dict(flow, flow_preds=preds),
                                     {k: jnp.asarray(v) for k, v in tgt.items()}, jcfg,
                                     is_bi=bi)[0]
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(flow["flow_preds"]))
    preds = nchw(flow["flow_preds"]).requires_grad_(True)
    tflow = {k: nchw(v) for k, v in flow.items() if k != "flow_preds"}
    tl, metrics = TF.flow_sequence_loss(dict(tflow, flow_preds=preds),
                                        {k: nchw(v) for k, v in tgt.items()}, tcfg, is_bi=bi)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    _close_grad(nhwc(preds.grad), jg)
    assert float(metrics["flow_l1loss"]) == float(tl.detach())
    assert bool(torch.isfinite(metrics["epe"]))


def _jax_lower_res_loss(preds, flow, tgt):
    """The lower-resolution branch of the JAX ``_seq_loss``, composed of the
    JAX package's ops line for line: its own ``_seq_loss`` raises there when
    it takes the EPE (full-resolution target minus a lower-resolution
    prediction), after the loss."""
    pad = JPadder((H, W), 32).pad
    i0, i1 = pad(jnp.asarray(tgt["gt_img0"])), pad(jnp.asarray(tgt["gt_img1"]))
    fgt, valid = pad(jnp.asarray(tgt["gt_flow"])), pad(jnp.asarray(tgt["valid"]))
    n, loss = len(preds), 0.0
    for i in range(n):
        w, hw = JF.GAMMA ** (n - i - 1), preds[i].shape[1:3]
        s_gt = jresize(fgt, hw, align_corners=True)
        photo = jnp.abs(jwarp(jresize(i0, hw, align_corners=True), preds[i])
                        - jresize(i1, hw, align_corners=True))
        s_mag = jnp.sqrt(jnp.sum(s_gt ** 2, axis=-1, keepdims=True))
        s_valid = jresize(valid, hw, align_corners=True) * (s_mag < JF.MAX_FLOW)
        loss = loss + w * jnp.mean(s_valid * jnp.abs(preds[i] - s_gt)) + w * jnp.mean(photo)
    return loss + 10.0 * jnp.mean(jnp.abs(flow["fmap2_pseudo"] - flow["fmap2_gt"]))


@pytest.mark.parametrize("consis", [True, False])
def test_recon_loss_matches_jax(consis):
    jcfg, tcfg = _cfgs()
    tgt, _, out, prev = _inputs(3)
    tgt["valid"] = np.random.default_rng(4).random((2, H, W, 1)).astype(np.float32)

    def jloss(o):
        return JR.recon_loss(o, jnp.asarray(prev), {k: jnp.asarray(v) for k, v in tgt.items()},
                             jcfg, is_loss_consis=consis)[0]
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(out))
    o = nchw(out).requires_grad_(True)
    tl, parts = TR.recon_loss(o, nchw(prev), {k: nchw(v) for k, v in tgt.items()}, tcfg,
                              is_loss_consis=consis)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    _close_grad(nhwc(o.grad), jg)
    assert (float(parts["loss_consistency"]) > 0) == consis
    # a 0-dim tensor gates the term by a multiply, as the JAX scan's flag
    gated, _ = TR.recon_loss(o, nchw(prev), {k: nchw(v) for k, v in tgt.items()}, tcfg,
                             is_loss_consis=torch.tensor(consis))
    np.testing.assert_allclose(float(gated.detach()), float(tl.detach()), rtol=1e-7)


@pytest.mark.parametrize("mode,is_bi", [("rec", False), ("flow", False), ("both", False),
                                        ("flow", True)])
def test_flow_recon_loss_matches_jax(mode, is_bi):
    jcfg, tcfg = _cfgs(is_bi)
    tgt, flow, out, prev = _inputs(5, is_bi)

    def jloss(o, preds):
        return JR.flow_recon_loss(o, jnp.asarray(prev), dict(flow, flow_preds=preds),
                                  {k: jnp.asarray(v) for k, v in tgt.items()}, jcfg, mode,
                                  is_loss_consis=True)
    jl, (jgo, jgp) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(out), jnp.asarray(flow["flow_preds"]))
    o = nchw(out).requires_grad_(True)
    preds = nchw(flow["flow_preds"]).requires_grad_(True)
    tflow = {k: nchw(v) for k, v in flow.items() if k != "flow_preds"}
    tl = TR.flow_recon_loss(o, nchw(prev), dict(tflow, flow_preds=preds),
                            {k: nchw(v) for k, v in tgt.items()}, tcfg, mode)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    if mode != "flow":
        _close_grad(nhwc(o.grad), jgo)
    if mode != "rec":
        _close_grad(nhwc(preds.grad), jgp)


def test_lpips_is_refused():
    _, tcfg = _cfgs()
    tgt, flow, out, prev = _inputs(6)
    with pytest.raises(NotImplementedError, match="LPIPS"):
        TR.flow_recon_loss(nchw(out), nchw(prev), {k: nchw(v) for k, v in flow.items()},
                           {k: nchw(v) for k, v in tgt.items()}, tcfg, "rec",
                           lpips_params={"w": 1})
    with pytest.raises(ValueError, match="loss_mode"):
        TR.flow_recon_loss(nchw(out), nchw(prev), {}, {k: nchw(v) for k, v in tgt.items()},
                           tcfg, "perceptual")
