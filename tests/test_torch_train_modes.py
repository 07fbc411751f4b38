"""Training in every model mode but cista-eiflow (tests/test_torch_train_step.py
holds that one; tests/test_torch_idnet_train.py cista-idnet's, with these
helpers): the port's composites in train mode and its BPTT train step
against the JAX package's (``composite.apply(train=True)``,
``make_train_step``) on the CPU in f32, the E-RAFT ``coords1`` repair, remat,
the exact resume, and the ``sim_quality`` loop.

The weights, carried across with ``weights.from_jax``: the reconstructor
from the JAX package's ``composite.init`` at base width 16 with its 1x1
output conv scaled by 300 (at the raw init the reconstruction is flat to
1e-4, which the flow nets' norms then amplify; see
tests/test_torch_train_step.py), and the flow net of a committed anchor:
``gate/eraft_ft1_f16.npz`` for cista-eraft, ``gate/idnet_ft2_f16.npz`` for
cista-idnet. Sizes: 48x64, depth 2, 2 flow iterations, T = 3, batch 2.
"""
import functools
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cista_flow_tpu import parallel as JP
from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import cista_lstc as JLSTC
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_torch import ckpt, train, weights
from cista_flow_torch.config import Config
from cista_flow_torch.data.sim import write_train_dataset
from cista_flow_torch.data.train_loader import StackedSequenceLoader, TrainSequenceDataset
from cista_flow_torch.models import composite
from cista_flow_torch.parallel import train_step as TS

REPO = Path(__file__).resolve().parent.parent
ANCHORS = {"cista-eraft": REPO / "gate" / "eraft_ft1_f16.npz",
           "cista-idnet": REPO / "gate" / "idnet_ft2_f16.npz"}
H, W = 48, 64
SMALL = dict(image_dim=(H, W), depth=2, base_channels=16, flow_iters=2, len_sequence=3,
             batch_size=2, lr=1e-4)
# E-RAFT's encoders read voxels that are zero on most pixels (fnet, instance
# norms; cnet, BatchNorm in train mode): near-constant channels whose
# normalisation amplifies f32 rounding, weight gradients that are sums
# that cancel
ENCODERS = ("event_flownet.cnet.", "event_flownet.fnet.")
# a bias whose conv feeds a normalisation in E-RAFT: its true gradient is 0
PRE_NORM_BIAS = re.compile(
    r"event_flownet\.(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))\.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU shapes: the test
    runner's workers share the machine's cores, and torch's thread pools
    then wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _cista():
    k_cista, _ = jax.random.split(jax.random.PRNGKey(0))      # as composite.init splits
    cista = jax.jit(lambda k: JLSTC.init(k, JConfig(**SMALL)))(k_cista)
    cista["final"] = jax.tree_util.tree_map(lambda a: 300.0 * a, cista["final"])
    return cista


@functools.lru_cache(maxsize=None)
def jax_weights(mode: str):
    """JAX (params, model_state) of ``mode``: the reconstructor of
    ``composite.init`` at width 16 with its head scaled, the anchor's flow
    net."""
    params, mstate = {"cista": _cista(), "flow": {}}, {"flow": {}}
    if mode in ANCHORS:
        anchor, astate = ti.composite_params(ti.load_state_dict(str(ANCHORS[mode])), mode)
        params["flow"], mstate["flow"] = anchor["flow"], astate["flow"]
    return params, mstate


def port_model(mode, params, mstate):
    model = composite.init(Config(model_mode=mode, **SMALL), device="cpu")
    model.load_reference_state(weights.from_jax(np_tree(params), np_tree(mstate)))
    return model


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("modes")
    write_train_dataset(str(root), 2, 4, H, W, seed=0)
    return str(root)


@functools.lru_cache(maxsize=None)
def _batch(root: str, mode: str):
    cfg = Config(model_mode=mode, **SMALL, path_to_train_data=root)
    loader = StackedSequenceLoader(
        TrainSequenceDataset(os.path.join(root, "train_e2v_estflow.txt"), cfg), 2, 3,
        shuffle=False, num_workers=0)
    return {k: v.astype(np.float32) for k, v in next(iter(loader)).items()}


# ----------------------------- the composites in train mode -----------------

@pytest.mark.parametrize("mode,fix", [
    ("cista-eraft", "rec"), ("cista-gtflow", None),
    pytest.param("cista-eraft", "flow", marks=pytest.mark.slow)])
def test_composite_train_step_matches_jax(mode, fix):
    check_composite(mode, fix)


def check_composite(mode, fix):
    """One composite step in train mode against ``composite.apply(train=True)``:
    the reconstruction, every flow output (E-RAFT's stacked ``flow_preds``,
    IDNet's listed ``flow_preds`` and ``delta_flow``, ``next_flow``), the
    new state and E-RAFT's cnet BN running statistics (updated exactly when
    the flow net trains), to 1e-4 abs (f32 chains of convs)."""
    params, mstate = jax_weights(mode)
    rng = np.random.default_rng(7)
    b = 2
    ev = rng.standard_normal((b, H, W, 5)).astype(np.float32)
    rec0 = rng.random((b, H, W, 1)).astype(np.float32)
    gt = {"gt_img1": rng.random((b, H, W, 1)).astype(np.float32)}
    if mode == "cista-gtflow":
        gt["gt_flow"] = (2.0 * rng.standard_normal((b, H, W, 2))).astype(np.float32)
    data = {"event_voxel": ev, "rec_img0": rec0}
    kw = {}
    if mode == "cista-eraft":
        data["event_voxel_old"] = rng.standard_normal((b, H, W, 5)).astype(np.float32)
        kw["event_voxel_old"] = nchw(data["event_voxel_old"])
    st = [(0.3 * rng.standard_normal((b, H // 2, W // 2, ch))).astype(np.float32)
          for ch in (32, 32, 16, 16)]
    jcfg = JConfig(model_mode=mode, **SMALL)
    apply = jax.jit(lambda p, m, d, s, g: JCOMP.apply(p, m, d, s, jcfg, batch_gt=g,
                                                      fix_net_name=fix, train=True))
    jr, jf, jst, jm = apply(
        params, mstate, {k: jnp.asarray(v) for k, v in data.items()},
        JCOMP.zero_state(b, jcfg)._replace(**{f: jnp.asarray(a) for f, a in zip(
            ("lstc_cell", "sparse_code", "dg_hidden", "dg_cell"), st)}),
        {k: jnp.asarray(v) for k, v in gt.items()})
    model = port_model(mode, params, mstate).train()
    with torch.no_grad():
        r, f, nst = model(nchw(ev), nchw(rec0), composite.CistaState(*map(nchw, st)),
                          collect_preds=True, batch_gt={k: nchw(v) for k, v in gt.items()},
                          fix_net_name=fix, **kw)

    def close(a, ref):
        np.testing.assert_allclose(a, np.asarray(ref), rtol=0, atol=1e-4)
    close(nhwc(r), jr)
    assert sorted(f) == sorted(jf)
    for k in f:
        if isinstance(f[k], list):
            assert len(f[k]) == len(jf[k]), k
            for a, ref in zip(f[k], jf[k]):
                close(nhwc(a), ref)
        else:
            close(nhwc(f[k]), jf[k])
    for a, ref in zip(nst, jst):
        close(nhwc(a), ref)
    if mode == "cista-eraft":
        assert model.event_flownet.training == (fix != "flow")
        sd, ref = model.state_dict(), weights.from_jax(np_tree(params), np_tree(jm))
        old = weights.from_jax(np_tree(params), np_tree(mstate))
        moved = 0
        for k in sd:
            if "running" in k:
                np.testing.assert_allclose(sd[k].numpy(), ref[k], rtol=1e-5, atol=1e-6)
                moved += not np.array_equal(sd[k].numpy(), old[k])
        assert (moved > 0) == (fix != "flow")


# ----------------------------- the BPTT train step --------------------------

def _capturing(opt):
    """An optimizer that also returns the gradients it was given."""
    def init(p):
        return opt.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, inner = opt.update(g, s[0], p)
        return u, (inner, g)
    return optax.GradientTransformation(init, update)


def _port_grads_as_jax(model, params, mode):
    """The port's gradients as a JAX tree shaped like ``params`` (zeros for
    a frozen subnet), through the reference-layout state dict and the JAX
    importer."""
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in model.named_parameters(remove_duplicate=False)}
    sd = weights.tie_ista_blocks(sd, model.cfg.depth)
    for k, v in model.state_dict().items():
        sd.setdefault(k, v.numpy())
    g, _ = ti.composite_params(sd, mode)
    return jax.tree_util.tree_map(lambda a, b: jnp.asarray(a, b.dtype), g, params)


# mode, phase -> (fix_net_name, loss_mode, use_gt_flow)
STEPS = {("cista-eraft", "phase3_flow_half"): ("rec", "both", False),
         ("cista-eraft", "phase1"): ("rec", "flow", True),
         ("cista-idnet", "both"): ("rec", "both", False),
         ("cista-idnet", "rec"): ("flow", "rec", False),
         ("cista-gtflow", "rec"): (None, "rec", True)}


def _jax_step(mode, params, mstate, batch, fix, loss_mode, gt_flow):
    jopt = _capturing(JP.make_optimizer(1e-4))
    jstep = JP.make_train_step(JConfig(model_mode=mode, **SMALL), jopt, loss_mode, fix,
                               gt_flow, donate=False)
    jparams, jmstate, (_, jgrads), jloss = jstep(
        params, mstate, jopt.init(params),
        {k: jnp.asarray(np.moveaxis(v, 2, -1)) for k, v in batch.items()})
    return jparams, jmstate, jgrads, float(jloss)


@pytest.mark.parametrize("mode,phase", [
    ("cista-eraft", "phase3_flow_half"), ("cista-gtflow", "rec"),
    pytest.param("cista-eraft", "phase1", marks=pytest.mark.slow)])
def test_train_step_matches_jax(data, mode, phase):
    check_train_step(data, mode, phase)


def check_train_step(data, mode, phase):
    """One optimizer step of the port against ``make_train_step`` on the same
    parameters and batch (48x64, width 16, depth 2, 2 flow iterations,
    T = 3, batch 2, lr 1e-4):
    * the loss to 1e-5 relative;
    * every gradient leaf to 1e-4 of its largest magnitude where the
      reconstructor alone trains; where E-RAFT's flow net trains, its leaves
      to 1e-3 of their largest magnitude but for two kinds: a bias that
      feeds a normalisation (true gradient 0) is held to 1e-5 of the step's
      largest gradient, and the leaves of fnet and cnet, which read voxels
      that are zero on most pixels through their norms, to 5e-2 relative L2
      each; where IDNet's flow net trains, every leaf to 2e-3 of its
      largest magnitude: the JAX package's own f32 gradient of the
      LiteEncoder is 5e-4 (relative L2) off an f64 evaluation of the port
      on this step, the port's 5e-5 (its deblur's sampling points move
      with the flow); where IDNet's flow drives the warps and the
      reconstructor trains (phase 2), every leaf to 5e-3 of its largest:
      one pixel's consistency L1 lies within rounding of its kink
      (|warp(previous) - out| ~1e-7) and takes the other sign in f32 than
      in f64, which moves the port's f32 gradient 1.6e-3 (relative L2) off
      an f64 evaluation; the trained leaves as a whole to 2e-3 relative L2
      in these two cases and where E-RAFT's flow net trains (1e-4
      elsewhere);
    * the parameters after the step to 1e-6 against JAX's optimizer fed the
      port's gradients, and to JAX's own step wherever the gradient is
      settled (the packages' gradients share a sign and JAX's is above the
      leaf's tolerance, outside the leaves held by relative L2);
    * the BN running statistics to 1e-5 of their largest magnitude; the
      frozen subnet, its statistics and its (absent) Adam state bit for bit.
    For cista-eraft this is the test of the ``coords1`` repair: without the
    detach at every GRU iteration (the parent tree's loop) the flow net's
    gradients leave these tolerances."""
    fix, loss_mode, gt_flow = STEPS[(mode, phase)]
    params, mstate = jax_weights(mode)
    batch = _batch(data, mode)
    jparams, jmstate, jgrads, jloss = _jax_step(mode, params, mstate, batch, fix, loss_mode,
                                                gt_flow)
    cfg = Config(model_mode=mode, **SMALL)
    model = port_model(mode, params, mstate)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = TS.make_optimizer(model, 1e-4)
    loss = TS.make_train_step(cfg, opt, loss_mode, fix, gt_flow)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)

    frozen = TS.SUBNETS.get(fix, "\0")
    trained = dict(model.named_parameters())
    jg = weights.from_jax(np_tree(jgrads), np_tree(mstate))
    top = max(float(p.grad.abs().max()) for p in trained.values() if p.grad is not None)
    loose = fix == "rec"                     # a flow net trains
    leaf_tol = {"cista-eraft": 1e-3, "cista-idnet": 2e-3}.get(mode, 1e-4) if loose else 1e-4
    kinked = mode == "cista-idnet" and fix == "flow"
    if kinked:
        leaf_tol = 5e-3
    num = den = 0.0
    for k, p in trained.items():
        if k.startswith(frozen):
            assert p.grad is None and not np.any(jg[k]), k
            continue
        g, ref = p.grad.numpy().astype(np.float64), jg[k].astype(np.float64)
        if mode == "cista-eraft" and PRE_NORM_BIAS.match(k):
            assert max(np.abs(g).max(), np.abs(ref).max()) <= 1e-5 * top, k
            continue
        num, den = num + np.sum((g - ref) ** 2), den + np.sum(ref ** 2)
        if loose and mode == "cista-eraft" and k.startswith(ENCODERS):
            assert np.linalg.norm(g - ref) <= 5e-2 * np.linalg.norm(ref), k
        else:
            np.testing.assert_allclose(g, ref, rtol=0, atol=leaf_tol * np.abs(ref).max(),
                                       err_msg=k)
    assert np.sqrt(num) <= (2e-3 if loose or kinked else 1e-4) * np.sqrt(den)

    sd = model.state_dict()
    jafter = weights.from_jax(np_tree(jparams), np_tree(jmstate))
    adam = JP.make_optimizer(1e-4)
    jadam = weights.from_jax(np_tree(optax.apply_updates(params, adam.update(
        _port_grads_as_jax(model, params, mode), adam.init(params), params)[0])),
        np_tree(mstate))
    for k in trained:
        if k.startswith(frozen):
            continue
        a, ref, g = sd[k].numpy(), jafter[k], trained[k].grad.numpy()
        settled = ((g * jg[k] > 0) & (np.abs(jg[k]) > leaf_tol * np.abs(jg[k]).max())
                   & (not (mode == "cista-eraft" and (PRE_NORM_BIAS.match(k) or (
                       loose and k.startswith(ENCODERS))))))
        np.testing.assert_allclose(a[settled], ref[settled], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(a, jadam[k], rtol=0, atol=1e-6, err_msg=k)
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), jafter[k], rtol=0,
                                       atol=1e-5 * max(np.abs(jafter[k]).max(), 1.0), err_msg=k)
        if k.startswith(frozen) or (fix == "flow" and "running" in k):
            assert torch.equal(sd[k], before[k]), k
    assert all(p not in opt.state for k, p in trained.items() if k.startswith(frozen))


# ----------------------------- remat and resume -----------------------------

@pytest.mark.parametrize("mode", ["cista-eraft", "cista-gtflow"])
def test_remat_matches_no_remat(data, mode):
    """``remat=True`` (each unroll step under non-reentrant checkpointing)
    gives the step without it bit for bit on the CPU (batch 1, 1 flow
    iteration): the loss, every
    gradient, the updated parameters and Adam state, and the BatchNorm
    buffers (E-RAFT phase 1: cnet in train mode), whose running statistics
    and ``num_batches_tracked`` the recompute must not move a second time."""
    fix, loss_mode, gt_flow = STEPS[(mode, "phase1" if mode == "cista-eraft" else "rec")]
    params, mstate = jax_weights(mode)
    batch = {k: torch.from_numpy(v[:, :1]) for k, v in _batch(data, mode).items()}
    cfg = Config(model_mode=mode, **{**SMALL, "flow_iters": 1})
    runs = []
    for remat in (False, True):
        model = composite.init(cfg, device="cpu")
        model.load_reference_state(weights.from_jax(np_tree(params), np_tree(mstate)))
        opt = TS.make_optimizer(model, 1e-4)
        loss = TS.make_train_step(cfg, opt, loss_mode, fix, gt_flow, remat=remat)(model, batch)
        runs.append((loss, model, opt))
    (la, ma, oa), (lb, mb, ob) = runs
    assert torch.equal(la, lb)
    for (k, pa), pb in zip(ma.named_parameters(), mb.parameters()):
        assert (pa.grad is None) == (pb.grad is None), k
        if pa.grad is not None:
            assert torch.equal(pa.grad, pb.grad), k
    sa, sb = ma.state_dict(), mb.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    tracked = [int(v) for k, v in sb.items() if k.endswith("num_batches_tracked")]
    if mode == "cista-eraft":
        assert tracked and set(tracked) == {3}           # once per unroll step
    for pa, pb in zip(ma.parameters(), mb.parameters()):
        for key in oa.state.get(pa, {}):
            assert torch.equal(oa.state[pa][key], ob.state[pb][key])


def _trainer_cfg(root, models, mode, **kw):
    """One optimizer step an epoch (2 sequences, batch 2), depth 1, one flow
    iteration."""
    return Config(model_mode=mode, **{**SMALL, "depth": 1, "flow_iters": 1},
                  path_to_train_data=root, path_to_model=str(models), flow_epoch=1,
                  rec_epoch=1, shuffle=False, **kw)


def _full_state(trainer):
    model = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    opt = trainer.optimizer.state_dict()["state"]
    return model, {i: {k: v.clone() for k, v in s.items()} for i, s in opt.items()}


def _assert_same_state(a, b):
    assert sorted(a[0]) == sorted(b[0]) and sorted(a[1]) == sorted(b[1])
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for i in a[1]:
        assert sorted(a[1][i]) == sorted(b[1][i])
        for k in a[1][i]:
            assert torch.equal(a[1][i][k], b[1][i][k]), (i, k)


@pytest.mark.parametrize("kind", ["epoch", "step"])
def test_exact_resume(data, tmp_path, kind):
    """``--load_epoch_for_train -1`` (the counterpart of
    tests/test_cli_e2e.py:321-380): from an epoch save (``orbax_ckpt``) and
    from a mid-epoch step save (``save_every_steps``), cista-eraft. The
    resumed trainer holds the saving run's parameters, BN buffers and Adam
    state (moments and each parameter's step) bit for bit, and the JAX
    trainer's epoch is chosen: after the epoch save, the next epoch; from a step save
    (preferred when its epoch is at least the last epoch save's), that
    epoch again, from its first batch. Training on from the resume equals
    an uninterrupted run bit for bit."""
    mode = "cista-eraft"
    if kind == "epoch":
        kw, first, epochs = dict(orbax_ckpt=True), 2, 3
    else:
        kw, first, epochs = dict(save_every_steps=1), 2, 3
    t1 = train.Trainer(_trainer_cfg(data, tmp_path / "a", mode, epochs=first, **kw), "cpu")
    t1.run()
    saved = _full_state(t1)
    if kind == "epoch":
        assert ckpt.steps(t1.epoch_dir) == [1, 2]
    else:
        assert ckpt.steps(t1.steps_dir) == [1, 2]          # a step an epoch
    t2 = train.Trainer(_trainer_cfg(data, tmp_path / "a", mode, epochs=epochs,
                                    load_epoch_for_train=-1, **kw), "cpu")
    rdir, rstep = t2.resume
    if kind == "epoch":
        assert rdir == t1.epoch_dir and rstep == 2 and t2.cfgs.load_epoch_for_train == 2
    else:
        assert rdir == t1.steps_dir and rstep == 2 and t2.cfgs.load_epoch_for_train == 1
        assert t2.resume_global_step == 2
    _assert_same_state(saved, _full_state(t2))
    if kind == "epoch":
        # epoch 1 froze the reconstructor, epoch 2 the flow net: both have moments
        assert all(p in t2.optimizer.state for p in t2.model.parameters())
        t2.run()
        straight = train.Trainer(_trainer_cfg(data, tmp_path / "b", mode, epochs=epochs,
                                              **kw), "cpu")
        straight.run()
        _assert_same_state(_full_state(straight), _full_state(t2))


def test_resume_prefers_the_newer_save(data, tmp_path):
    """The JAX trainer's rule (train.py:64-87): a step save whose epoch is
    below the last epoch save's loses to it (the run starts after that
    epoch, its step count from 0); one whose epoch is at least as new wins
    (that epoch restarts, the step count goes on); no save raises."""
    mode = "cista-gtflow"

    def resumed():
        return train.Trainer(_trainer_cfg(data, tmp_path, mode, epochs=4,
                                          load_epoch_for_train=-1), "cpu")
    with pytest.raises(FileNotFoundError):
        resumed()
    t0 = train.Trainer(_trainer_cfg(data, tmp_path, mode, epochs=4), "cpu")
    ckpt.save_checkpoint(t0.epoch_dir, 2, t0.model, t0.optimizer)
    ckpt.save_checkpoint(t0.steps_dir, 3, t0.model, t0.optimizer,
                         meta={"epoch": 1, "global_step": 3})
    t = resumed()
    assert t.resume == (t0.epoch_dir, 2)
    assert (t.cfgs.load_epoch_for_train, t.resume_global_step) == (2, 0)
    ckpt.save_checkpoint(t0.steps_dir, 5, t0.model, t0.optimizer,
                         meta={"epoch": 2, "global_step": 5})
    t = resumed()
    assert t.resume == (t0.steps_dir, 5)
    assert (t.cfgs.load_epoch_for_train, t.resume_global_step) == (2, 5)


# ----------------------------- the sim quality loop -------------------------

def test_sim_quality_tiny(tmp_path, capsys):
    """``python -m cista_flow_torch.sim_quality --device cpu`` at a tiny
    size (2 videos of 5 frames at 48x64, 8 eval frames, 2 epochs, depth 1,
    f32): one JSON line with the JAX script's keys (sim_quality.py:160-175;
    the with-flow eval always scores a flow, so epe too), finite metrics,
    and the trained checkpoint where it names it."""
    from cista_flow_torch import sim_quality
    assert sim_quality.main(["--workdir", str(tmp_path), "--image_dim", "48", "64",
                             "--n_videos", "2", "--n_frames", "5", "--eval_frames", "8",
                             "--epochs", "2", "--batch_size", "2", "--len_sequence", "3",
                             "--depth", "1", "--dtype", "float32", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == sorted(["psnr_init", "psnr_trained", "ssim_init", "ssim_trained",
                                  "mse_init", "mse_trained", "epe_init", "epe_trained",
                                  "epochs", "ckpt"])
    assert out["epochs"] == 2 and os.path.exists(out["ckpt"])
    assert all(np.isfinite(v) for k, v in out.items() if k not in ("epochs", "ckpt"))
