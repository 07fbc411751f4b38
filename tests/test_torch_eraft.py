"""The cista-eraft slice of the PyTorch port against the JAX package, on the
CPU in f32: the E-RAFT modules, the composite step, the time-parallel
window and the ``Reconstructor`` with the committed gate weights.

Inputs come from a numpy seed and feed both packages (JAX NHWC, the port
NCHW). Weights are one set in both: ``composite.init`` of the JAX package
carried across with ``weights.from_jax``, or a gate anchor loaded both ways.
Tolerances: 1e-4 abs for modules (chains of f32 convs summed in another
order than XLA's), 1e-3 on the 3-step closed loop, where those differences
feed back through the recurrence and the warps.
"""
import warnings
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
from cista_flow_tpu.models import eraft as JERAFT
from cista_flow_tpu.nn import gru as JG
from cista_flow_tpu.runner import Reconstructor as JReconstructor
from cista_flow_torch import weights
from cista_flow_torch.config import Config
from cista_flow_torch.models import composite
from cista_flow_torch.models.cista_lstc import CistaState
from cista_flow_torch.runner import Reconstructor

ATOL = 1e-4
H, W = 48, 64
GATE = Path(__file__).resolve().parent.parent / "gate"
FT1 = str(GATE / "eraft_ft1_f16.npz")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def pair():
    """JAX (cfg, params, model_state) and the port's model with the same
    random weights, depth 1."""
    jcfg = JConfig(image_dim=(H, W), model_mode="cista-eraft", depth=1)
    params, mstate = JCOMP.init(jax.random.PRNGKey(0), jcfg)
    model = composite.init(Config(image_dim=(H, W), model_mode="cista-eraft", depth=1),
                           device="cpu", seed=1)
    model.load_reference_state(weights.from_jax(_np_tree(params), _np_tree(mstate)))
    return jcfg, params, mstate, model


@pytest.mark.parametrize("corr_projected", [False, True])
def test_basic_update_block(pair, corr_projected):
    _, params, _, model = pair
    rng = np.random.default_rng(1)
    b, h, w = 2, 6, 8
    net = np.tanh(rng.standard_normal((b, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((b, h, w, 128)), 0).astype(np.float32)
    planes = 256 if corr_projected else 324
    cor = np.maximum(rng.standard_normal((b, h, w, planes)), 0).astype(np.float32)
    flow = (2 * rng.standard_normal((b, h, w, 2))).astype(np.float32)
    jnet, jmask, jdelta = JG.basic_update_block(
        params["flow"]["update"], jnp.asarray(net), jnp.asarray(inp), jnp.asarray(cor),
        jnp.asarray(flow), corr_projected=corr_projected)
    with torch.no_grad():
        tnet, tmask, tdelta = model.event_flownet.update_block(
            nchw(net), nchw(inp), nchw(cor), nchw(flow), corr_projected=corr_projected)
    assert tmask.shape == (b, 576, h, w)
    close(nhwc(tnet), jnet)
    close(nhwc(tmask), jmask)
    close(nhwc(tdelta), jdelta)


@pytest.mark.parametrize("iters,flow_init,encoded", [(1, False, False), (3, False, False),
                                                     (3, True, False), (1, False, True)])
def test_eraft(pair, iters, flow_init, encoded):
    jcfg, params, mstate, model = pair
    rng = np.random.default_rng(10 + iters)
    old = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    new = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    fi = (2 * rng.standard_normal((2, 8, 8, 2))).astype(np.float32) if flow_init else None
    enc = [rng.standard_normal((2, 8, 8, 256)).astype(np.float32) for _ in range(3)] \
        if encoded else None
    ref, _ = JERAFT.apply(
        params["flow"], mstate["flow"], jnp.asarray(old), jnp.asarray(new), jcfg,
        iters=iters, flow_init=None if fi is None else jnp.asarray(fi),
        collect_preds=False, encoded=None if enc is None else tuple(map(jnp.asarray, enc)))
    with torch.no_grad():
        out = model.event_flownet(
            nchw(old), nchw(new), iters=iters, flow_init=None if fi is None else nchw(fi),
            encoded=None if enc is None else tuple(map(nchw, enc)))
    assert out["flow_final"].shape == (2, 2, H, W)
    assert out["flow_preds"].shape == (1, 2, 2, 64, 64)      # padded to 64x64
    close(nhwc(out["flow_init"]), ref["flow_init"])
    close(nhwc(out["flow_final"]), ref["flow_final"])
    close(nhwc(out["flow_preds"]), ref["flow_preds"])


def test_eraft_collect_preds(pair):
    """Every iteration's upsampled flow, as the training losses read them."""
    jcfg, params, mstate, model = pair
    rng = np.random.default_rng(14)
    old = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    new = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    ref, _ = JERAFT.apply(params["flow"], mstate["flow"], jnp.asarray(old),
                          jnp.asarray(new), jcfg, iters=2, collect_preds=True)
    with torch.no_grad():
        out = model.event_flownet(nchw(old), nchw(new), iters=2, collect_preds=True)
    assert out["flow_preds"].shape[0] == 2
    close(nhwc(out["flow_preds"]), ref["flow_preds"])


def _state(rng, b, c=64, h=H // 2, w=W // 2):
    return [(0.3 * rng.standard_normal((b, h, w, ch))).astype(np.float32)
            for ch in (2 * c, 2 * c, c, c)]


def test_composite_step(pair):
    jcfg, params, mstate, model = pair
    rng = np.random.default_rng(20)
    st = _state(rng, 1)
    old = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    ev = rng.standard_normal((1, H, W, 5)).astype(np.float32)
    img = rng.random((1, H, W, 1)).astype(np.float32)
    batch = {"event_voxel": jnp.asarray(ev), "event_voxel_old": jnp.asarray(old),
             "rec_img0": jnp.asarray(img)}
    jrec, jflow, jst, _ = JCOMP.apply(params, mstate, batch,
                                      JL.CistaState(*map(jnp.asarray, st)), jcfg,
                                      iters=2, collect_preds=False)
    with torch.no_grad():
        trec, tflow, tst = model(nchw(ev), nchw(img), CistaState(*map(nchw, st)),
                                 nchw(old), iters=2)
    close(nhwc(tflow["flow_final"]), jflow["flow_final"])
    close(nhwc(trec), jrec)
    for a, b in zip(tst, jst):
        close(nhwc(a), b)


@pytest.mark.parametrize("tchunk", [0, 1])
def test_window_matches_apply_sequence_eraft(pair, tchunk):
    """The time-parallel window against its JAX twin, with the flow call
    over the whole window and over one time step at a time."""
    jcfg, params, mstate, model = pair
    t_len, b = 2, 2
    rng = np.random.default_rng(30)
    seq = rng.standard_normal((t_len + 1, b, H, W, 5)).astype(np.float32)
    st = _state(rng, b)
    rec0 = rng.random((b, H, W, 1)).astype(np.float32)
    jc = JConfig(image_dim=(H, W), model_mode="cista-eraft", depth=1, eraft_tchunk=tchunk)
    jrecs, jflows, jst = JCOMP.apply_sequence_eraft(
        params, mstate, jnp.asarray(seq), JL.CistaState(*map(jnp.asarray, st)), jc,
        rec0=jnp.asarray(rec0), iters=2)
    model.cfg.eraft_tchunk = tchunk
    try:
        with torch.no_grad():
            recs, flows, tst = model.forward_window(nchw(seq), nchw(rec0),
                                                    CistaState(*map(nchw, st)), iters=2)
    finally:
        model.cfg.eraft_tchunk = 0
    assert recs.shape == (t_len, b, 1, H, W) and flows.shape == (t_len, b, 2, H, W)
    close(nhwc(flows), jflows)
    close(nhwc(recs), jrecs)
    for a, c in zip(tst, jst):
        close(nhwc(a), c)


def test_window_tchunk_that_does_not_divide_warns(pair):
    _, _, _, model = pair
    seq = torch.zeros((4, 1, 5, H, W))
    model.cfg.eraft_tchunk = 2          # t_len = 3
    try:
        with torch.no_grad(), pytest.warns(UserWarning, match="does not divide"):
            flows = model.window_flows(seq, iters=1)
    finally:
        model.cfg.eraft_tchunk = 0
    assert flows.shape == (3, 1, 2, H, W)


@pytest.mark.parametrize("name,depth", [("eraft_ft1_f16.npz", 1), ("eraft_sim40_f16.npz", 5)])
def test_gate_weights_load_both_ways(name, depth):
    """The gate anchor strict-loads into the port, and the JAX importer's
    tree carried back by ``from_jax`` gives the same tensors per key."""
    path = str(GATE / name)
    sd = weights.load_state_dict(path)
    model = composite.init(Config(image_dim=(H, W), model_mode="cista-eraft", depth=depth),
                           device="cpu")
    model.load_reference_state(sd)
    p, s = ti.composite_params(ti.load_state_dict(path), "cista-eraft")
    back = weights.tie_ista_blocks(weights.from_jax(_np_tree(p), _np_tree(s)), depth)
    mine = model.state_dict()
    assert set(back) == set(mine)
    for k, v in back.items():
        close(mine[k].numpy(), v, 0)


# ------------------------- the Reconstructor --------------------------------

def _voxels(seed, t, batch=None):
    rng = np.random.default_rng(seed)
    shape = (t, 5, H, W) if batch is None else (t, batch, 5, H, W)
    return rng.standard_normal(shape).astype(np.float32)


def _cfg(**kw):
    return Config(image_dim=(H, W), model_mode="cista-eraft", depth=1, flow_iters=1,
                  path_to_test_model=FT1, **kw)


def test_step_window_matches_jax():
    """3-step closed loop with the gate weights, and the step after it (the
    carried state, frame and previous voxel): 1e-3 on frames and flows."""
    voxels = _voxels(0, 3)
    jr = JReconstructor(JConfig(image_dim=(H, W), model_mode="cista-eraft", depth=1,
                                flow_iters=1, path_to_test_model=FT1))
    jrecs, jflows = jr.step_window(list(voxels), return_all=True)
    tr = Reconstructor(_cfg(), device="cpu")
    recs, flows = tr.step_window(voxels, return_all=True)
    assert recs.shape == (3, H, W) and flows.shape == (3, 2, H, W)
    np.testing.assert_allclose(recs, jrecs, rtol=0, atol=1e-3)
    np.testing.assert_allclose(flows, jflows, rtol=0, atol=1e-3)
    nxt = _voxels(1, 1)[0]
    trec, tflow = tr.step(nxt)
    jrec, jflow = jr.step(nxt)
    np.testing.assert_allclose(trec, jrec, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tflow, jflow, rtol=0, atol=1e-3)


def test_step_window_equals_steps_and_two_windows_equal_one():
    """The time-parallel window equals stepping (which encodes each pair
    anew), and the carried previous voxel joins two windows into one. 1e-5:
    the same f32 ops at other batch sizes."""
    voxels = _voxels(2, 4)
    r1 = Reconstructor(_cfg(), device="cpu")
    seq = [r1.step(v) for v in voxels]
    r2 = Reconstructor(_cfg(), device="cpu")
    recs, flows = r2.step_window(voxels, return_all=True)
    r3 = Reconstructor(_cfg(eraft_tchunk=1), device="cpu")
    a = r3.step_window(voxels[:2], return_all=True)
    b = r3.step_window(voxels[2:], return_all=True)
    for t in range(4):
        np.testing.assert_allclose(recs[t], seq[t][0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(flows[t], seq[t][1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([a[0], b[0]]), recs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([a[1], b[1]]), flows, rtol=0, atol=1e-5)
    r2.reset()
    np.testing.assert_allclose(r2.step(voxels[0])[0], seq[0][0], rtol=0, atol=1e-5)


def test_batched_streams_match_single_streams():
    voxels = _voxels(3, 2, batch=2)
    recs, flows = Reconstructor(_cfg(), device="cpu", batch=2).step_window(
        voxels, return_all=True)
    for b in range(2):
        r, f = Reconstructor(_cfg(), device="cpu").step_window(voxels[:, b], return_all=True)
        np.testing.assert_allclose(recs[:, b], r, rtol=0, atol=1e-5)
        np.testing.assert_allclose(flows[:, b], f, rtol=0, atol=1e-5)


def test_first_step_sees_a_zero_previous_voxel():
    """A stream starts from a zero voxel, so fnet's instance norms see
    constant planes (variance 0, eps 1e-5): finite, and equal to JAX."""
    v = _voxels(4, 1)[0]
    tr = Reconstructor(_cfg(), device="cpu")
    assert float(tr.extra.abs().max()) == 0.0
    rec, flow = tr.step(v)
    assert np.isfinite(rec).all() and np.isfinite(flow).all()
    np.testing.assert_array_equal(tr.extra[0].numpy(), v)


def test_variant_routes_match_the_default_route():
    """K3a / K6 for the ISTA loop and K4s for the encoders' norms compute
    what K3 / K4 compute (on the CPU: their plain versions), 1e-5."""
    voxels = _voxels(5, 2)
    cfg = Config(image_dim=(H, W), model_mode="cista-eraft", depth=5, flow_iters=1,
                 path_to_test_model=str(GATE / "eraft_sim40_f16.npz"))
    base = Reconstructor(cfg, device="cpu").step_window(voxels, return_all=True)
    for ista, norm in (("v2", "fused"), ("loop", "fused"), ("dg", "stats")):
        r = Reconstructor(cfg, device="cpu")
        r.model.cista_net.ista_route = ista
        r.model.event_flownet.fnet.norm_route = norm
        assert all(m._norm_route == norm for m in r.model.event_flownet.fnet.layer2)
        out = r.step_window(voxels, return_all=True)
        np.testing.assert_allclose(out[0], base[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(out[1], base[1], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        r.model.event_flownet.fnet.norm_route = "nope"


def test_default_device_is_cuda_and_idnet_is_refused():
    """The default device is the card; cista-idnet and cista-lstc, refused
    until they were ported, now build, and an unknown mode is refused."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Reconstructor(Config(image_dim=(32, 32), model_mode="cista-eraft"))
    Reconstructor(Config(image_dim=(32, 32), model_mode="cista-idnet", depth=1), device="cpu")
    Reconstructor(Config(image_dim=(32, 32), model_mode="cista-lstc", depth=1), device="cpu")
    with pytest.raises(ValueError, match="unknown model_mode"):
        Reconstructor(Config(image_dim=(32, 32), model_mode="cista-raft"), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Reconstructor(Config(image_dim=(32, 32), model_mode="cista-eraft", depth=1,
                             flow_iters=1), device="cpu")
