"""The cista-idnet slice of the PyTorch port against the JAX package, on the
CPU in f32: the LiteEncoder, the LiteUpdateBlock, IDNet, the composite
step and the ``Reconstructor`` with the committed gate weights; the IDNet
tree of ``weights.from_jax``; and the runner's f32 scoping of cuDNN's TF32.

Inputs come from a numpy seed and feed both packages (JAX NHWC, the port
NCHW). Tolerances: 1e-4 abs for modules (chains of f32 convs summed in
another order than XLA's), 1e-3 on the 3-step closed loop, where those
differences feed back through the recurrence, the deblur and the warps.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_tpu.models import idnet as JIDNET
from cista_flow_tpu.nn import encoders as JE
from cista_flow_tpu.nn import gru as JG
from cista_flow_tpu.ops.upsample import convex_upsample as j_convex_upsample
from cista_flow_tpu.runner import Reconstructor as JReconstructor
from cista_flow_torch import weights
from cista_flow_torch.config import Config
from cista_flow_torch.device import cudnn_fp32
from cista_flow_torch.models import composite
from cista_flow_torch.models.cista_lstc import CistaState
from cista_flow_torch.models.idnet import deblur
from cista_flow_torch.ops.upsample import convex_upsample
from cista_flow_torch.runner import Reconstructor

ATOL = 1e-4
H, W = 48, 64
GATE = Path(__file__).resolve().parent.parent / "gate"
ANCHORS = {"ft2": (str(GATE / "idnet_ft2_f16.npz"), 2),
           "sim40": (str(GATE / "idnet_sim40_f16.npz"), 5)}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


def _cfgs(anchor):
    path, depth = ANCHORS[anchor]
    return (JConfig(image_dim=(H, W), model_mode="cista-idnet", depth=depth,
                    path_to_test_model=path),
            Config(image_dim=(H, W), model_mode="cista-idnet", depth=depth,
                   path_to_test_model=path))


@pytest.fixture(scope="module", params=sorted(ANCHORS))
def gate_pair(request):
    """The JAX params and the port's CistaIDNet, both from one gate anchor."""
    jcfg, cfg = _cfgs(request.param)
    params, _ = ti.composite_params(ti.load_state_dict(cfg.path_to_test_model),
                                    "cista-idnet")
    model = composite.init(cfg, device="cpu")
    model.load_reference_state(weights.load_state_dict(cfg.path_to_test_model))
    return jcfg, params, model


def test_lite_encoder(gate_pair):
    _, params, model = gate_pair
    x = np.random.default_rng(0).standard_normal((3, 64, 64, 2)).astype(np.float32)
    ref = JE.lite_encoder(params["flow"]["fnet"], jnp.asarray(x), stage_strides=(2, 2))
    with torch.no_grad():
        out = model.event_flownet.fnet(nchw(x))
    assert out.shape == (3, 64, 8, 8)
    close(nhwc(out), ref)


def test_lite_update_block(gate_pair):
    """The ConvGRU over 5 bins' features, then both head pairs and their
    convex upsampling."""
    _, params, model = gate_pair
    rng = np.random.default_rng(1)
    net = np.tanh(rng.standard_normal((2, 8, 8, 96))).astype(np.float32)
    feats = rng.standard_normal((5, 2, 8, 8, 64)).astype(np.float32)
    up = params["flow"]["update"]
    jnet = jnp.asarray(net)
    for f in feats:
        jnet = JG.conv_gru(up["gru"], jnet, jnp.asarray(f))
    ub = model.event_flownet.update_net
    with torch.no_grad():
        tnet = nchw(net)
        for f in feats:
            tnet = ub.gru(tnet, nchw(f))
        heads = ub.heads(tnet)
    close(nhwc(tnet), jnet)
    assert len(heads) == 2
    for (dflow, mask), fh, mh in zip(heads, ("flow_head", "flow_head2"), ("mask", "mask2")):
        jflow = JG.flow_head(up[fh], jnet)
        jmask = JG.mask_head(up[mh], jnet)
        close(nhwc(dflow), jflow)
        close(nhwc(mask), jmask, 1e-3 * max(1.0, float(jnp.abs(jmask).max())))
        close(nhwc(convex_upsample(dflow, mask, 8, flow_scale=8)),
              j_convex_upsample(jflow, jmask, factor=8, flow_scale=8))


def test_deblur_matches_jax():
    """The one grid_sample over all bins: align_corners=False, zeros
    padding, /(W-1) normalization and t/(V-1) scales, flows that reach out
    of the frame."""
    rng = np.random.default_rng(2)
    vox = rng.standard_normal((2, 32, 64, 5)).astype(np.float32)
    flow = (6 * rng.standard_normal((2, 32, 64, 2))).astype(np.float32)
    ref = JIDNET._deblur(jnp.asarray(vox), jnp.asarray(flow))
    out = deblur(nchw(vox), nchw(flow))
    close(nhwc(out), ref, 1e-5)


@pytest.mark.parametrize("iters,with_init", [(1, False), (1, True), (2, True)])
def test_idnet(gate_pair, iters, with_init):
    jcfg, params, model = gate_pair
    rng = np.random.default_rng(3 + iters)
    vox = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    fi = (2 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32) if with_init else None
    ref = JIDNET.apply(params["flow"], jnp.asarray(vox), jcfg,
                       flow_init=None if fi is None else jnp.asarray(fi),
                       deblur_iters=iters, collect_preds=True)
    with torch.no_grad():
        out = model.event_flownet(nchw(vox), flow_init=None if fi is None else nchw(fi),
                                  iters=iters, collect_preds=True)
    assert out["flow_final"].shape == (2, 2, H, W)
    assert out["next_flow"].shape == (2, 2, 64, 64)     # padded to a multiple of 32
    close(nhwc(out["flow_final"]), ref["flow_final"])
    close(nhwc(out["next_flow"]), ref["next_flow"])
    assert len(out["flow_preds"]) == iters
    for p, r in zip(out["flow_preds"], ref["flow_preds"]):
        close(nhwc(p), r)


def test_composite_step(gate_pair):
    """One CistaIDNet step from a non-zero state, frame and flow_init."""
    jcfg, params, model = gate_pair
    rng = np.random.default_rng(7)
    ev = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    rec0 = rng.random((1, H, W, 1)).astype(np.float32)
    fi = (2 * rng.standard_normal((1, 64, 64, 2))).astype(np.float32)
    st = [(0.1 * rng.standard_normal((1, H // 2, W // 2, c))).astype(np.float32)
          for c in (128, 128, 64, 64)]
    jstate = JCOMP.zero_state(1, jcfg)._replace(
        lstc_cell=jnp.asarray(st[0]), sparse_code=jnp.asarray(st[1]),
        dg_hidden=jnp.asarray(st[2]), dg_cell=jnp.asarray(st[3]))
    jrec, jflow, jnew, _ = JCOMP.apply(
        params, {"flow": {}}, {"event_voxel": jnp.asarray(ev), "rec_img0": jnp.asarray(rec0)},
        jstate, jcfg, flow_init=jnp.asarray(fi), collect_preds=False)
    with torch.no_grad():
        rec, flow, new = model(nchw(ev), nchw(rec0), CistaState(*map(nchw, st)),
                               flow_init=nchw(fi))
    close(nhwc(rec), jrec)
    close(nhwc(flow["flow_final"]), jflow["flow_final"])
    close(nhwc(flow["next_flow"]), jflow["next_flow"])
    for a, b in zip(new, jnew):
        close(nhwc(a), b)


@pytest.mark.parametrize("anchor", sorted(ANCHORS))
def test_reconstructor_closed_loop_matches_jax(anchor):
    """3 closed-loop steps with next_flow chained, then one more step from
    the carried state: the port's window against the JAX package's."""
    jcfg, cfg = _cfgs(anchor)
    rng = np.random.default_rng(8)
    vox = (rng.standard_normal((3, 5, H, W)) * (rng.random((3, 5, H, W)) < 0.3)
           ).astype(np.float32)
    jr = JReconstructor(jcfg)
    jrecs, jflows = jr.step_window(list(vox), return_all=True)
    tr = Reconstructor(cfg, device="cpu")
    recs, flows = tr.step_window(vox, return_all=True)
    assert recs.shape == (3, H, W) and flows.shape == (3, 2, H, W)
    assert tr.extra.shape == (1, 2, 64, 64) and float(tr.extra.abs().max()) > 0
    close(recs, jrecs, 1e-3)
    close(flows, jflows, 1e-3)
    nxt = rng.standard_normal((5, H, W)).astype(np.float32)
    r, f = tr.step(nxt)
    jrr, jf = jr.step(nxt)
    close(r, jrr, 1e-3)
    close(f, jf, 1e-3)
    tr.reset()
    assert float(tr.extra.abs().max()) == 0.0


def test_from_jax_idnet_round_trip():
    """Random JAX cista-idnet parameters carried across: the state dict
    loads strictly into the port, matches the JAX importer's key set for a
    reference checkpoint, and maps back to the same JAX tree."""
    jcfg = JConfig(image_dim=(H, W), model_mode="cista-idnet", depth=2)
    params, mstate = JCOMP.init(jax.random.PRNGKey(3), jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = weights.from_jax(params, jax.tree_util.tree_map(np.asarray, mstate))
    flow_keys = {k for k in weights.load_state_dict(ANCHORS["ft2"][0])
                 if k.startswith("event_flownet.")}
    assert {k for k in sd if k.startswith("event_flownet.")} == flow_keys
    model = composite.init(Config(image_dim=(H, W), model_mode="cista-idnet", depth=2),
                           device="cpu", seed=5)
    model.load_reference_state(sd)
    back, _ = ti.composite_params(
        {k: v.detach().numpy() for k, v in model.state_dict().items()}, "cista-idnet")
    flat = jax.tree_util.tree_leaves_with_path(params["flow"])
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back["flow"]))
    assert len(flat) == len(back_flat) == len(flow_keys)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), leaf)
    # and the port computes what JAX computes with those weights
    vox = np.random.default_rng(4).standard_normal((1, H, W, 5)).astype(np.float32)
    ref = JIDNET.apply(params["flow"], jnp.asarray(vox), jcfg, collect_preds=False)
    with torch.no_grad():
        out = model.event_flownet(nchw(vox))
    close(nhwc(out["flow_final"]), ref["flow_final"])


def _tf32_state():
    """What a cuDNN conv would consult: the per-operator precision where
    this PyTorch has it, else the legacy flag."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return conv.fp32_precision
    return cudnn.allow_tf32


def _flags():
    cudnn = torch.backends.cudnn
    conv, rnn = getattr(cudnn, "conv", None), getattr(cudnn, "rnn", None)
    try:
        legacy = cudnn.allow_tf32
    except RuntimeError:
        legacy = "mixed"
    prec = (conv.fp32_precision, rnn.fp32_precision) if hasattr(conv, "fp32_precision") else None
    return (legacy, prec, cudnn.enabled, cudnn.benchmark, cudnn.deterministic)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tf32_scoped_to_f32_steps(monkeypatch, dtype):
    """Every conv of an f32 step runs with cuDNN's TF32 off, and the
    caller's flags (TF32 on, as PyTorch's default) are as they were after
    the step; a bf16 step leaves them alone."""
    import torch.nn.functional as F
    cudnn = torch.backends.cudnn
    monkeypatch.setattr(cudnn, "allow_tf32", True)
    before = _flags()
    assert _tf32_state() in (True, "tf32")
    seen = []
    conv2d = F.conv2d

    def spy(*args, **kwargs):
        seen.append((_tf32_state(), cudnn.enabled))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(F, "conv2d", spy)
    cfg = Config(image_dim=(32, 32), model_mode="cista-idnet", depth=1, dtype=dtype)
    rec = Reconstructor(cfg, device="cpu")
    vox = np.random.default_rng(0).standard_normal((2, 5, 32, 32)).astype(np.float32)
    rec.step_window(vox)
    rec.step(vox[0])
    assert len(seen) > 20
    want = (False, "ieee") if dtype == "float32" else (True, "tf32")
    assert all(state in want and enabled for state, enabled in seen), set(seen)
    assert _flags() == before


def test_cudnn_fp32_restores_mixed_flags():
    """A caller that set the per-operator precision itself (the legacy
    getter then refuses to answer) gets its flags back as they were."""
    cudnn = torch.backends.cudnn
    if not hasattr(getattr(cudnn, "conv", None), "fp32_precision"):
        pytest.skip("this PyTorch has only the legacy TF32 flag")
    saved = (cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision)
    try:
        for conv, rnn in (("tf32", "ieee"), ("ieee", "tf32"), ("tf32", "tf32")):
            cudnn.allow_tf32 = True
            cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = conv, rnn
            before = _flags()
            with cudnn_fp32():
                assert cudnn.conv.fp32_precision == "ieee"
            assert _flags() == before
    finally:
        cudnn.allow_tf32 = True
        cudnn.conv.fp32_precision, cudnn.rnn.fp32_precision = saved
