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
            Config(model_mode="cista-eiflow", image_dim=(H, W), is_bi=is_bi, warp_mode=warp_mode))


def _close_grad(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("case", ["same_res", "lower_res", "no_pseudo", "is_bi", "backward_warp",
                                  "listed", "listed_lower_res"])
def test_flow_sequence_loss_matches_jax(case):
    """Stacked ``flow_preds`` (DCEIFlow, E-RAFT) and listed ones (IDNet's
    every-iteration totals; ``listed_lower_res`` takes the lower-resolution
    branch), value and gradient against ``jax.grad``."""
    bi = case == "is_bi"
    jcfg, tcfg = _cfgs(bi, "backward" if case == "backward_warp" else "forward")
    lower = case.endswith("lower_res")
    listed = case.startswith("listed")
    pred_hw = (HP // 2, WP // 2) if lower else (HP, WP)
    tgt, flow, _, _ = _inputs(1, bi, pred_hw=pred_hw)
    if case == "no_pseudo" or listed:
        del flow["fmap2_pseudo"], flow["fmap2_gt"]
    rng = np.random.default_rng(2)
    tgt["valid"] = rng.random((2, H, W, 1)).astype(np.float32)
    if bi:
        tgt["valid_bw"] = rng.random((2, H, W, 1)).astype(np.float32)

    def jloss(preds):
        if lower:
            return _jax_lower_res_loss(list(preds) if listed else preds, flow, tgt)
        return JF.flow_sequence_loss(dict(flow, flow_preds=list(preds) if listed else preds),
                                     {k: jnp.asarray(v) for k, v in tgt.items()}, jcfg,
                                     is_bi=bi)[0]
    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(flow["flow_preds"]))
    preds = nchw(flow["flow_preds"]).requires_grad_(True)
    tflow = {k: nchw(v) for k, v in flow.items() if k != "flow_preds"}
    tl, metrics = TF.flow_sequence_loss(
        dict(tflow, flow_preds=list(preds.unbind(0)) if listed else preds),
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
    if "fmap2_pseudo" not in flow:
        return loss
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
    """Once refused, LPIPS parameters now add the perceptual term: the
    loss with random LPIPS weights (``losses/lpips.init``) is the loss
    without them plus their LPIPS distance (tests/test_torch_lpips.py holds
    the distance against the JAX package's). An unknown loss mode is
    still refused."""
    from cista_flow_torch.losses import lpips as TL
    _, tcfg = _cfgs()
    tgt, flow, out, prev = _inputs(6)
    args = (nchw(out), nchw(prev), {k: nchw(v) for k, v in flow.items()},
            {k: nchw(v) for k, v in tgt.items()}, tcfg, "rec")
    params = TL.init(5)
    with_lp = TR.flow_recon_loss(*args, lpips_params=params)
    lp = TL.lpips(params, nchw(out), nchw(tgt["gt_img1"]))
    np.testing.assert_allclose(float(with_lp), float(TR.flow_recon_loss(*args) + lp), rtol=1e-6)
    assert float(lp) > 0
    with pytest.raises(ValueError, match="loss_mode"):
        TR.flow_recon_loss(nchw(out), nchw(prev), {}, {k: nchw(v) for k, v in tgt.items()},
                           tcfg, "perceptual")


def test_idn_losses_match_jax():
    """IDNet's auxiliary losses (cista_flow_tpu/losses/idn_losses.py; the
    counterpart of tests/test_extras.py:139) on NCHW: each against the JAX
    function on the NHWC inputs at 1e-6 relative, the masked ones with a
    random mask and an empty one (exactly 0), the sequence mean, and the
    Charbonnier and smoothness gradients against ``jax.grad``."""
    from cista_flow_tpu.losses import idn_losses as JI
    from cista_flow_torch.losses import idn_losses as TI
    rng = np.random.default_rng(21)
    e = rng.standard_normal((2, 8, 10, 2)).astype(np.float32)
    g = rng.standard_normal((2, 8, 10, 2)).astype(np.float32)
    mask = (rng.random((2, 8, 10, 1)) > 0.5).astype(np.float32)
    je, jg_, jm = jnp.asarray(e), jnp.asarray(g), jnp.asarray(mask)
    te, tg, tm = nchw(e), nchw(g), nchw(mask)

    def same(port, ref):
        np.testing.assert_allclose(float(port), float(ref), rtol=1e-6, atol=1e-7)
    for m_j, m_t in ((None, None), (jm, tm), (jnp.zeros_like(jm), torch.zeros_like(tm))):
        same(TI.sparse_l1(te, tg, m_t), JI.sparse_l1(je, jg_, m_j))
        for order in (1, 2):
            same(TI.sparse_lnorm(order, te, tg, m_t), JI.sparse_lnorm(order, je, jg_, m_j))
        same(TI.npe(1.0, te, tg, m_t), JI.npe(1.0, je, jg_, m_j))
    assert float(TI.sparse_l1(te, tg, torch.zeros_like(tm))) == 0.0
    same(TI.sparse_l1_seq([te, tg], [tg, te], [tm, tm]),
         JI.sparse_l1_seq([je, jg_], [jg_, je], [jm, jm]))
    same(TI.sparse_l1_seq([te, te], [tg, tg]), JI.sparse_l1_seq([je, je], [jg_, jg_]))
    for tfn, jfn in ((TI.charbonnier_loss, JI.charbonnier_loss),
                     (TI.smoothness_loss, JI.smoothness_loss)):
        x = te.clone().requires_grad_(True)
        val = tfn(x) if tfn is TI.smoothness_loss else tfn(x - tg)
        val.backward()
        jv, jgrad = jax.value_and_grad(
            (lambda a: jfn(a)) if tfn is TI.smoothness_loss else (lambda a: jfn(a - jg_)))(je)
        same(val.detach(), jv)
        _close_grad(nhwc(x.grad), jgrad)


def test_combine_loss_and_metric():
    """``CombineLoss`` and ``CombineMetric`` (tests/test_extras.py:189)
    against the JAX package's on the same callables."""
    from cista_flow_tpu.losses import combine as JC
    from cista_flow_torch.losses import combine as TC

    def f1(o, t):
        return torch.tensor(1.0), {"a": 1.0}

    def f2(o, t):
        return torch.tensor(2.0), {"b": 4.0}
    for mod in (TC, JC):
        m = mod.CombineLoss([f1, f2], [1.0, 0.5])(None, None)
        assert float(m["loss"]) == 2.0 and m["a"] == 1.0 and m["b"] == 4.0
    with pytest.raises(ValueError):
        TC.CombineLoss([f1], [1.0, 2.0])
    fns = [lambda o, t: {"epe": torch.tensor(1.0)}, lambda o, t: {"px": 0.5}]
    ours, theirs = TC.CombineMetric(fns), JC.CombineMetric(fns)
    for cm in (ours, theirs):
        cm.push(cm.calculate(None, None))
        cm.push({"epe": 3.0, "px": 0.7})
    assert ours.get_all() == theirs.get_all()
    (text, summary), (jtext, jsummary) = ours.summary(), theirs.summary()
    assert text == jtext and summary == jsummary
    np.testing.assert_allclose(summary["epe"], 2.0)
    assert ours.get_all() == {}
