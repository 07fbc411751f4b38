"""Parity of the PyTorch port's modules and models with the JAX package on
the CPU, in f32, with one set of weights loaded into both.

Weights: ``composite.init`` of the JAX package carried across with
``weights.from_jax``, or the committed gate anchors loaded both ways
(``torch_import.composite_params`` and the port's strict
``load_state_dict``). Inputs come from a numpy seed. Tolerance 1e-4 abs for
modules: chains of f32 convs summed in another order than XLA's.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import cista_lstc as JL
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_tpu.models import dceiflow as JD
from cista_flow_tpu.nn import encoders as JE
from cista_flow_tpu.nn import gru as JG
from cista_flow_torch import weights
from cista_flow_torch.config import Config
from cista_flow_torch.models import composite
from cista_flow_torch.models.cista_lstc import CistaState

ATOL = 1e-4
H, W = 48, 64


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def pair():
    """JAX (params, model_state) and the port's model, same random weights,
    at depth 5 (the ISTA block is tied, so depth only changes the loop)."""
    jcfg = JConfig(image_dim=(H, W), model_mode="cista-eiflow", depth=5)
    params, mstate = JCOMP.init(jax.random.PRNGKey(0), jcfg)
    model = composite.init(Config(model_mode="cista-eiflow",
                                  image_dim=(H, W), depth=5), device="cpu", seed=1)
    model.load_reference_state(weights.from_jax(_np_tree(params), _np_tree(mstate)))
    return jcfg, params, mstate, model


def _state(rng, b, c=64, h=H // 2, w=W // 2):
    return [(0.3 * rng.standard_normal((b, h, w, ch))).astype(np.float32)
            for ch in (2 * c, 2 * c, c, c)]


@pytest.mark.parametrize("depth", [1, 5])
def test_cista_lstc_two_steps(pair, depth):
    _, params, _, model = pair
    net = model.cista_net
    net.depth = depth
    try:
        rng = np.random.default_rng(depth)
        st = _state(rng, 2)
        jst, tst = JL.CistaState(*map(jnp.asarray, st)), CistaState(*map(nchw, st))
        for _ in range(2):
            ev = rng.standard_normal((2, H, W, 5)).astype(np.float32)
            img = rng.random((2, H, W, 1)).astype(np.float32)
            jrec, jst = JL.apply(params["cista"], jnp.asarray(ev), jnp.asarray(img),
                                 jst, depth=depth)
            with torch.no_grad():
                trec, tst = net(nchw(ev), nchw(img), tst)
            close(nhwc(trec), jrec)
            for a, b in zip(tst, jst):
                close(nhwc(a), b)
    finally:
        net.depth = 5


@pytest.mark.parametrize("norm", ["instance", "batch"])
def test_basic_encoder(pair, norm):
    _, params, mstate, model = pair
    name = "fnet" if norm == "instance" else "cnet"
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    ref, _ = JE.basic_encoder(params["flow"][name], mstate["flow"][name],
                              jnp.asarray(x), norm, train=False)
    with torch.no_grad():
        out = getattr(model.event_flownet, name)(nchw(x))
    close(nhwc(out), ref)


def test_update_block(pair):
    _, params, _, model = pair
    rng = np.random.default_rng(4)
    b, h, w = 2, 6, 8
    net = np.tanh(rng.standard_normal((b, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((b, h, w, 128)), 0).astype(np.float32)
    cor = np.maximum(rng.standard_normal((b, h, w, 256)), 0).astype(np.float32)
    emap = rng.standard_normal((b, h, w, 256)).astype(np.float32)
    flow = (2 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    up = params["flow"]["update"]
    ema = JG.precompute_update_ema(up, jnp.asarray(emap))
    jnet, _, jdelta = JG.basic_update_block_event(
        up, jnp.asarray(net), jnp.asarray(inp), jnp.asarray(cor), ema,
        jnp.asarray(flow), corr_projected=True, ema_precomputed=True)
    ub = model.event_flownet.update_block
    with torch.no_grad():
        tema = ub.precompute_update_ema(nchw(emap))
        tnet, tdelta = ub(nchw(net), nchw(inp), nchw(cor), tema, nchw(flow))
    close(nhwc(tema), ema)
    close(nhwc(tnet), jnet)
    close(nhwc(tdelta), jdelta)


@pytest.mark.parametrize("iters,collect", [(1, False), (6, False), (2, True)])
def test_dceiflow(pair, iters, collect):
    jcfg, params, mstate, model = pair
    rng = np.random.default_rng(5 + iters)
    ev = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    img = rng.random((2, H, W, 1)).astype(np.float32)
    ref, _ = JD.apply(params["flow"], mstate["flow"], jnp.asarray(ev), jnp.asarray(img),
                      jcfg, iters=iters, collect_preds=collect)
    with torch.no_grad():
        out = model.event_flownet(nchw(ev), nchw(img), iters=iters, collect_preds=collect)
    close(nhwc(out["flow_final"]), ref["flow_final"])
    close(nhwc(out["flow_init"]), ref["flow_init"])
    assert out["flow_preds"].shape[0] == np.asarray(ref["flow_preds"]).shape[0]
    for a, b in zip(out["flow_preds"], ref["flow_preds"]):
        close(nhwc(a), b)


def test_composite_step(pair):
    jcfg, params, mstate, model = pair
    rng = np.random.default_rng(9)
    st = _state(rng, 1)
    ev = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    img = rng.random((1, H, W, 1)).astype(np.float32)
    jrec, jflow, jst, _ = JCOMP.apply(
        params, mstate, {"event_voxel": jnp.asarray(ev), "rec_img0": jnp.asarray(img)},
        JL.CistaState(*map(jnp.asarray, st)), jcfg, iters=2, collect_preds=False)
    with torch.no_grad():
        trec, tflow, tst = model(nchw(ev), nchw(img), CistaState(*map(nchw, st)), iters=2)
    close(nhwc(tflow["flow_final"]), jflow["flow_final"])
    close(nhwc(trec), jrec)
    for a, b in zip(tst, jst):
        close(nhwc(a), b)


@pytest.mark.parametrize("name,depth", [("flagship_ft1_f16.npz", 1),
                                        ("flagship_sim40_f16.npz", 5)])
def test_gate_weights_load_both_ways(name, depth):
    """The gate anchor strict-loads into the port, and the JAX importer's
    tree carried back by ``from_jax`` gives the same tensors per key."""
    path = str(Path(__file__).resolve().parent.parent / "gate" / name)
    sd = weights.load_state_dict(path)
    assert all(v.dtype != np.float16 for v in sd.values())
    model = composite.init(Config(model_mode="cista-eiflow",
                                  image_dim=(H, W), depth=depth), device="cpu")
    model.load_reference_state(sd)
    p, s = ti.composite_params(ti.load_state_dict(path), "cista-eiflow")
    back = weights.tie_ista_blocks(weights.from_jax(_np_tree(p), _np_tree(s)), depth)
    mine = model.state_dict()
    assert set(back) == set(mine)
    for k, v in back.items():
        close(mine[k].numpy(), v, 0)


def test_tied_ista_block_is_one_parameter_set():
    model = composite.init(Config(model_mode="cista-eiflow",
                                  image_dim=(32, 32), depth=5), device="cpu")
    blocks = model.cista_net.lista_blocks
    assert all(b is blocks[0] for b in blocks)
    keys = [k for k in model.state_dict() if "lista_blocks" in k]
    assert len(keys) == 5 * 5
