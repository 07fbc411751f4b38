"""The serving modes this slice adds, against the JAX package on the CPU in
f32: cista-lstc and cista-gtflow (no flow net), cista-eiflow's
``flow_half``, every flow mode's windows with ``use_gt_flow``, the strict
load of a full checkpoint under a no-flow mode, the output folder's name,
and the device voxelization.

Weights: a JAX ``composite.init`` carried across with ``weights.from_jax``
(the no-flow modes), or a committed gate anchor loaded by both packages.
Inputs come from a numpy seed. Tolerances: 1e-5 absolute on frames, flows
and states in f32 (the two packages sum f32 convolutions in other orders);
voxels within 1e-6 of the numpy golden.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu import runner as JRUN
from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_tpu.ops import voxel as JOV
from cista_flow_torch import runner, weights
from cista_flow_torch.config import Config
from cista_flow_torch.events import voxel as golden
from cista_flow_torch.models import composite
from cista_flow_torch.ops import voxel as dvox

H, W = 48, 64
TOL = 1e-5
GATE = Path(__file__).resolve().parent.parent / "gate"
ANCHORS = {"cista-eiflow": ("flagship_ft1_f16.npz", 1, 1),
           "cista-eraft": ("eraft_ft1_f16.npz", 1, 1),
           "cista-idnet": ("idnet_ft2_f16.npz", 2, 1)}


def nchw(a):
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def close(port, ref, atol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


def voxels(seed, steps, h=H, w=W):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((steps, 5, h, w)).astype(np.float32) * 2.0
    return v * (rng.random(v.shape) < 0.2)


def flows(seed, steps, scale=2.0):
    """Smooth GT flows (2, H, W): an affine field, as the simulator's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for _ in range(steps):
        a = rng.standard_normal(6).astype(np.float32) * np.float32(scale)
        out.append(np.stack([a[0] + a[1] * xx / W + a[2] * yy / H,
                             a[3] + a[4] * xx / W + a[5] * yy / H]))
    return np.stack(out)


def state_close(port_state, jax_state):
    for a, b in zip(port_state, jax_state):
        close(nhwc(a), b)


@pytest.mark.parametrize("mode", ["cista-lstc", "cista-gtflow"])
def test_no_flow_steps_match_jax(mode):
    """Three closed-loop steps of ``composite.apply`` (the JAX package's
    no-flow tree of the idnet anchor's reconstructor, depth 2, carried
    across with ``from_jax``): zero flow for cista-lstc (the warps pass
    their inputs through), the GT flow for cista-gtflow; frames, flows and
    the state."""
    jcfg = JConfig(image_dim=(H, W), model_mode=mode, depth=2)
    params, mstate = ti.composite_params(ti.load_state_dict(str(GATE / "idnet_ft2_f16.npz")), mode)
    assert params["flow"] == {}
    sd = weights.from_jax(jax.tree_util.tree_map(np.asarray, params),
                          jax.tree_util.tree_map(np.asarray, mstate))
    assert sd and all(k.startswith("cista_net.") for k in sd)
    model = composite.init(Config(image_dim=(H, W), model_mode=mode, depth=2), device="cpu")
    model.load_reference_state(sd)
    ev, gt = voxels(1, 3), flows(2, 3)
    jstate, jrec = JCOMP.zero_state(1, jcfg), jnp.zeros((1, H, W, 1))
    state = composite.zero_state(1, model.cfg, device="cpu")
    rec = torch.zeros((1, 1, H, W))
    apply = jax.jit(lambda b, st, gt: JCOMP.apply(params, mstate, b, st, jcfg, batch_gt=gt,
                                                  collect_preds=False))
    for t in range(3):
        batch_gt = {"gt_flow": jnp.asarray(gt[t].transpose(1, 2, 0))[None]} \
            if mode == "cista-gtflow" else {}
        jrec, jflow, jstate, _ = apply(
            {"event_voxel": jnp.asarray(ev[t].transpose(1, 2, 0))[None], "rec_img0": jrec},
            jstate, batch_gt)
        with torch.no_grad():
            rec, bflow, state = model(
                torch.from_numpy(ev[t])[None], rec, state,
                batch_gt={"gt_flow": torch.from_numpy(gt[t])[None]} if batch_gt else None)
        close(nhwc(rec), jrec)
        close(nhwc(bflow["flow_final"]), jflow["flow_final"])
        state_close(state, jstate)
    assert float(np.abs(nhwc(rec)).max()) > 0


@pytest.fixture(scope="module")
def flagship():
    name, depth, iters = ANCHORS["cista-eiflow"]
    p, s = ti.composite_params(ti.load_state_dict(str(GATE / name)), "cista-eiflow")
    model = composite.init(Config(model_mode="cista-eiflow",
                                  image_dim=(H, W), depth=depth, flow_half=True), device="cpu")
    model.load_reference_state(weights.load_state_dict(str(GATE / name)))
    return p, s, model, depth, iters


def test_flow_half_matches_jax(flagship):
    """``flow_half``: the flow net on the half domain (24x32, padded to
    32x32), the code warped along its flow, the frame along its x2
    upsample; two closed-loop steps against ``composite.apply`` with
    ``cfg.flow_half``. The flow half cannot train the flow net or run the
    backward direction."""
    p, s, model, depth, iters = flagship
    jcfg = JConfig(image_dim=(H, W), model_mode="cista-eiflow", depth=depth, flow_half=True)
    ev = voxels(4, 2)
    jstate, jrec = JCOMP.zero_state(1, jcfg), jnp.asarray(
        np.random.default_rng(5).random((1, H, W, 1)).astype(np.float32))
    state, rec = composite.zero_state(1, model.cfg, device="cpu"), nchw(jrec)
    apply = jax.jit(lambda b, st: JCOMP.apply(p, s, b, st, jcfg, iters=iters,
                                              collect_preds=False))
    for t in range(2):
        jrec, jflow, jstate, _ = apply(
            {"event_voxel": jnp.asarray(ev[t].transpose(1, 2, 0))[None], "rec_img0": jrec}, jstate)
        with torch.no_grad():
            rec, bflow, state = model(torch.from_numpy(ev[t])[None], rec, state, iters=iters)
        assert float(torch.abs(bflow["flow_final"]).max()) > 0.1
        close(nhwc(bflow["flow_final"]), jflow["flow_final"])
        close(nhwc(rec), jrec)
        state_close(state, jstate)
    with pytest.raises(ValueError, match="flow_half"):
        model(torch.from_numpy(ev[0])[None], rec, state, batch_gt={"gt_img1": rec})


@pytest.mark.parametrize("mode", ["cista-eiflow", "cista-eraft", "cista-idnet"])
def test_gt_flow_windows_match_jax(mode):
    """``step_window(..., gt_flows, use_gt_flow=True)`` against the JAX
    runner's, 3 steps from a gate anchor (for cista-eiflow then one more
    ``step`` with a GT flow): the warps follow the GT flows; the flows
    returned are the flow net's (cista-eraft steps instead of its
    time-parallel window)."""
    name, depth, iters = ANCHORS[mode]
    kw = dict(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters,
              path_to_test_model=str(GATE / name))
    jr, tr = JRUN.Reconstructor(JConfig(**kw)), runner.Reconstructor(Config(**kw), device="cpu")
    ev, gt = voxels(6, 4), flows(7, 4)
    jrecs, jflows = jr.step_window(list(ev[:3]), list(gt[:3]), use_gt_flow=True, return_all=True)
    recs, fl = tr.step_window(ev[:3], gt[:3], use_gt_flow=True, return_all=True)
    close(recs, jrecs)
    close(fl, jflows)
    if mode == "cista-eiflow":
        close(tr.step(ev[3], gt[3], use_gt_flow=True)[0],
              jr.step(ev[3], gt[3], use_gt_flow=True)[0])
    # the GT flow reached the warps: the frames differ from the flow net's
    other = runner.Reconstructor(Config(**kw), device="cpu").step_window(ev[:3], return_all=True)
    assert np.abs(other[0] - recs).max() > 1e-3


def test_full_checkpoint_loads_strictly_under_no_flow_modes():
    """A full cista-eiflow checkpoint under cista-gtflow: its
    ``event_flownet.*`` keys are dropped, as the JAX package reads only
    ``cista_net.*`` there; the reconstructor's weights are the anchor's;
    any other key still fails the strict load."""
    sd = weights.load_state_dict(str(GATE / "flagship_ft1_f16.npz"))
    assert any(k.startswith("event_flownet.") for k in sd)
    cfg = Config(image_dim=(H, W), model_mode="cista-gtflow", depth=1,
                 path_to_test_model=str(GATE / "flagship_ft1_f16.npz"))
    rec = runner.Reconstructor(cfg, device="cpu")
    got = rec.model.state_dict()
    for k, v in sd.items():
        if k.startswith("cista_net.") and "lista_blocks" not in k:
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    with pytest.raises(RuntimeError, match="Unexpected"):
        rec.model.load_reference_state({**sd, "cista_net.extra.weight": np.zeros(1)})
    missing = {k: v for k, v in sd.items() if not k.startswith("cista_net.We")}
    with pytest.raises(RuntimeError, match="Missing"):
        rec.model.load_reference_state(missing)


def test_model_names_match_the_jax_runner(tmp_path):
    """``model_name_from_cfg`` (with and without ``--model_name``), the
    file name of a checkpoint, and ``load_epoch_for_test``: the checkpoint
    ``<folder>/<folder name>_<epoch>.pth.tar`` served under
    ``<folder name>/<epoch>``, as the JAX runner names them."""
    for name in ("", "exp1"):
        for mode in ("cista-eiflow", "cista-lstc"):
            kw = dict(model_name=name, model_mode=mode, num_bins=5, depth=3, base_channels=32)
            assert runner.model_name_from_cfg(Config(**kw)) == \
                JRUN.model_name_from_cfg(JConfig(**kw))
    folder = tmp_path / "cista-lstc_b5_d1_c16"
    folder.mkdir()
    model = composite.init(Config(image_dim=(H, W), model_mode="cista-lstc", depth=1,
                                  base_channels=16), device="cpu", seed=4)
    weights.save_checkpoint(str(folder / "cista-lstc_b5_d1_c16_3.pth.tar"), model, epoch=3)
    kw = dict(image_dim=(H, W), model_mode="cista-lstc", depth=1, base_channels=16,
              path_to_test_model=str(folder) + "/", load_epoch_for_test=3)
    jr, tr = JRUN.Reconstructor(JConfig(**kw)), runner.Reconstructor(Config(**kw), device="cpu")
    assert tr.model_name == jr.model_name == "cista-lstc_b5_d1_c16/3"
    close(tr.step(voxels(8, 1)[0])[0], jr.step(voxels(8, 1)[0])[0])
    kw.update(load_epoch_for_test=None,
              path_to_test_model=str(folder / "cista-lstc_b5_d1_c16_3.pth.tar"))
    assert runner.Reconstructor(Config(**kw), device="cpu").model_name == \
        JRUN.Reconstructor(JConfig(**kw)).model_name == "cista-lstc_b5_d1_c16_3.pth"
    kw.update(path_to_test_model=None)
    assert runner.Reconstructor(Config(**kw), device="cpu").model_name == "cista-lstc_b5_d1_c16"


def events_of(seed, n, h, w):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random(n)) * 0.04 + 0.5
    return np.stack([t, rng.integers(0, w, n), rng.integers(0, h, n), rng.integers(0, 2, n)], 1)


@pytest.mark.parametrize("n,cap", [(15000, 15000), (15000, 20000), (1, 8), (0, 16)])
def test_device_voxels_match_the_numpy_golden(n, cap):
    """A buffer of ``cap`` entries holding ``n`` events (the tail masked and
    filled with junk): f64 timestamps within 1e-6 of the numpy golden,
    normalised voxels (with and without the hot-pixel filter) too; f32
    timestamps as the JAX package's ``ops.voxel`` within 1e-6."""
    ev = events_of(n, n, 180, 240)
    junk = events_of(99, cap - n, 400, 400) * np.array([1e3, 1, 1, 1])
    buf = np.concatenate([ev, junk])
    valid = torch.arange(cap) < n
    t, x, y, p = (torch.from_numpy(buf[:, i]) for i in range(4))
    got = dvox.events_to_voxel_grid(t, x.long(), y.long(), p.long(), 5, 180, 240, valid)
    ref = golden.events_to_voxel_grid(ev, 5, 240, 180)
    assert got.dtype == torch.float32 and got.shape == (5, 180, 240)
    close(got.numpy(), ref, 1e-6)
    for hot in (False, True):
        close(dvox.event_preprocess(got, filter_hot_pixel=hot).numpy(),
              golden.event_preprocess(ref.copy(), filter_hot_pixel=hot), 1e-6)
    j = JOV.events_to_voxel_grid(jnp.asarray(buf[:, 0], jnp.float32), jnp.asarray(buf[:, 1]),
                                 jnp.asarray(buf[:, 2]), jnp.asarray(buf[:, 3]), 5, 180, 240,
                                 jnp.asarray(valid.numpy()))
    got32 = dvox.events_to_voxel_grid(t.float(), x.long(), y.long(), p.long(), 5, 180, 240, valid)
    close(got32.numpy(), np.asarray(j), 1e-6)
    close(dvox.event_preprocess(got32).numpy(), np.asarray(JOV.event_preprocess(j)), 1e-6)
