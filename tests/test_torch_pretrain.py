"""Flow-net pretraining in the port (``pretrain_flow``, ``sim_flow_quality``,
``data.sim.SimFlowPairs``) against the JAX package's root scripts, on the
CPU in f32.

Data: ``write_train_dataset`` at 32x64 (2 videos of 4 frames, bit for bit
the JAX package's), read by both packages' ``SimFlowPairs``. Weights: a JAX
``init`` of each flow net carried across with ``weights.flow_net_from_jax``.
2 GRU iterations. Tolerances are stated in each test.
"""
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pretrain_flow as JPF
from cista_flow_tpu import parallel as JP
from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.data.sim import SimFlowPairs as JSimFlowPairs
from cista_flow_tpu.models import dceiflow as JD
from cista_flow_tpu.models import eraft as JE
from cista_flow_tpu.models import raft as JR
from cista_flow_torch import pretrain_flow as pf
from cista_flow_torch import sim_flow_quality as sfq
from cista_flow_torch import weights
from cista_flow_torch.config import Config
from cista_flow_torch.data.sim import SimFlowPairs, write_train_dataset
from cista_flow_torch.losses.flow import flow_sequence_loss
from test_torch_surface import jax_native_library

H, W = 32, 64
LR = 2e-4
INITS = {"dceiflow": JD.init, "eraft": JE.init, "raft": JR.init}
EXPORTS = {"dceiflow": ti.dceiflow_export, "eraft": ti.eraft_export, "raft": ti.raft_export}
# a bias whose conv feeds a normalisation (instance norm, or BatchNorm in
# train mode): its true gradient is 0 and the computed one rounding
PRE_NORM_BIAS = re.compile(r"(fnet|enet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))"
                           r"\.bias")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU shapes: the test
    runner's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("pairs")
    write_train_dataset(str(path), 2, 4, H, W, seed=0)
    return str(path)


def configs(root, mode="cista-eiflow", **kw):
    kw = dict(image_dim=(H, W), model_mode=mode, flow_iters=2, path_to_train_data=root,
              len_sequence=1, lr=LR, batch_size=2, seed=7, **kw)
    return JConfig(**kw), Config(**kw)


def jax_init(arch, jcfg, seed=0):
    return jax.jit(lambda k: INITS[arch](k, jcfg))(jax.random.PRNGKey(seed))


def port_net(arch, cfg, params, state):
    model = pf.flow_net(arch, cfg, device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           weights.flow_net_from_jax(np_tree(params), np_tree(state)).items()},
                          strict=True)
    return model


# ------------------------------- SimFlowPairs --------------------------------

@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("mode,bi", [("cista-eiflow", False), ("cista-eiflow", True),
                                     ("cista-eraft", False)])
def test_sim_flow_pairs_bit_for_bit(root, mode, bi, aug):
    """Every item, every key, bit for bit the JAX class's (with ``is_bi``
    and reversed events: the backward flow and the reversed voxel;
    cista-eraft: the previous voxel), and with ``aug`` the same flips in
    the same draw order. Both loaders voxelize on their default path, each
    package's host event library."""
    jcfg, cfg = configs(root, mode, is_bi=bi, is_reverse_events=bi)
    ours, theirs = SimFlowPairs(cfg, aug=aug), JSimFlowPairs(jcfg, aug=aug)
    assert len(ours) == len(theirs) == 6
    for i in list(range(len(ours))) * 2:              # twice: the flips draw on
        a, b = ours[i], theirs[i]
        assert sorted(a) == sorted(b)
        want = {"event_voxel", "gt_img0", "gt_img1", "gt_flow", "valid"}
        want |= {"gt_flow_bw", "event_voxel_bw"} if bi else set()
        want |= {"event_voxel_old"} if mode == "cista-eraft" else set()
        assert set(a) == want
        for k in a:
            assert a[k].dtype == np.float32 and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_make_batches_equal_the_jax_batches(root):
    """Shuffled from the same seed, the last partial batch dropped: the JAX
    function's batches (NHWC there, NCHW here), bit for bit (both
    packages' voxels from their host event library)."""
    jcfg, cfg = configs(root)
    ours = list(pf.make_batches(SimFlowPairs(cfg, aug=True), 4, True,
                                np.random.default_rng(5)))
    theirs = list(JPF.make_batches(JSimFlowPairs(jcfg, aug=True), 4, True,
                                   np.random.default_rng(5)))
    assert len(ours) == len(theirs) == 1
    for a, b in zip(ours, theirs):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.moveaxis(a[k], 1, -1), b[k], err_msg=k)


# ------------------------------ the optimizer --------------------------------

@pytest.mark.parametrize("total", [1, 2, 10, 100, 1000])
def test_raft_optimizer_matches_optax(total):
    """``make_raft_optimizer`` against the JAX script's at every step to
    T + 5 on seeded gradients (some above the clip, some below): the LR of
    each step equal to optax's ``linear_onecycle_schedule`` over the same
    horizon (T, or 100 where int(0.05 T) < 1) to 1e-6 relative, finite
    everywhere, and the parameters equal to 1e-4 relative (f32 rounding of
    the two AdamW updates, accumulated over up to 1005 steps)."""
    rng = np.random.default_rng(total)
    w0 = rng.standard_normal(5).astype(np.float32)
    grads = (rng.standard_normal((total + 5, 5)) * rng.choice([0.1, 3.0], (total + 5, 1)))
    horizon = total if int(0.05 * total) >= 1 else 100
    sched = optax.linear_onecycle_schedule(horizon, LR, pct_start=0.05, pct_final=1.0,
                                           div_factor=25.0, final_div_factor=1e3)
    jopt = JPF.make_raft_optimizer(LR, total)
    jparams = {"w": jnp.asarray(w0)}
    jstate = jopt.init(jparams)
    update = jax.jit(jopt.update)
    model = torch.nn.Linear(5, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0)[None])
    opt = pf.make_raft_optimizer(model, LR, total)
    for step, g in enumerate(grads.astype(np.float32)):
        upd, jstate = update({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        model.weight.grad = torch.from_numpy(g)[None].clone()
        opt.step()
        lr = opt.param_groups[0]["lr"]
        assert np.isfinite(lr)
        np.testing.assert_allclose(lr, float(sched(step)), rtol=1e-6)
        np.testing.assert_allclose(model.weight.detach().numpy()[0], np.asarray(jparams["w"]),
                                   rtol=1e-4, atol=1e-9)
    assert np.isfinite(model.weight.detach().numpy()).all()
    if total >= 100:
        assert opt.param_groups[0]["lr"] == pytest.approx(LR / 1e3, rel=1e-6)


def test_onecycle_knots():
    """The schedule's knots at T = 100, peak 2e-4: peak/25 at 0, the peak
    at 5, 2.303e-6 at 99, peak/1000 at 100 and after."""
    lr = pf.onecycle_lr(LR, 100)
    assert lr(0) == pytest.approx(8e-6, rel=1e-12)
    assert lr(5) == pytest.approx(2e-4, rel=1e-12)
    assert lr(99) == pytest.approx(2e-4 + (2e-7 - 2e-4) * 94 / 95, rel=1e-12)
    assert lr(100) == lr(500) == pytest.approx(2e-7, rel=1e-12)


@pytest.mark.parametrize("norm", [0.5, 1.0, 3.0])
def test_clip_matches_optax(norm):
    """Below the limit the gradients stay bit for bit; at and above it they
    equal ``optax.clip_by_global_norm(1.0)``'s to 1e-6 relative."""
    rng = np.random.default_rng(int(10 * norm))
    gs = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (7,), (2, 2, 2))]
    scale = norm / np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in gs))
    gs = [(g * scale).astype(np.float32) for g in gs]
    ref, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
    ts = [torch.from_numpy(g.copy()) for g in gs]
    got = float(pf.clip_by_global_norm_(ts, 1.0))
    assert got == pytest.approx(norm, rel=1e-6)
    for t, g, r in zip(ts, gs, ref):
        if norm < 1.0:
            assert np.array_equal(t.numpy(), g)
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6, atol=1e-9)


# ------------------------------ the train step --------------------------------

def capturing(opt):
    """``opt`` that also keeps the gradients it was given in its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), opt.init(params)

    def update(grads, state, params=None):
        upd, inner = opt.update(grads, state[1], params)
        return upd, (grads, inner)
    return optax.GradientTransformation(init, update)


def step_batch(root, arch, cfg):
    """Items 1 and 2 (not a video's first frame: the previous voxel is not
    zero); RAFT's frames as RGB (the grey frame scaled per channel)."""
    ds = SimFlowPairs(cfg)
    items = [ds[i] for i in (1, 2)]
    batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
    if arch == "raft":
        for k in ("gt_img0", "gt_img1"):
            batch[k] = np.concatenate([batch[k], 0.9 * batch[k], 0.8 * batch[k]], 1)
    return batch


def f64_grads(arch, cfg, params, state, batch, is_bi):
    """The port's loss gradient in float64 from the same weights."""
    model = port_net(arch, cfg, params, state).double().train()
    b = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    out = pf.flow_forward(model, b, arch, cfg.default_flow_iters())
    target = {"gt_img0": b["gt_img0"][:, :1], "gt_img1": b["gt_img1"][:, :1],
              "gt_flow": b["gt_flow"], "valid": b["valid"]}
    if is_bi:
        target.update(gt_flow_bw=b["gt_flow_bw"], valid_bw=b["valid"])
    flow_sequence_loss(out, target, cfg, is_bi=is_bi)[0].backward()
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


STEPS = {"dceiflow-bi-adam": ("dceiflow", True, "adam"),
         "eraft-raft": ("eraft", False, "raft"),
         "dceiflow-raft": ("dceiflow", False, "raft"),
         "raft-raft": ("raft", False, "raft")}


@pytest.mark.parametrize("case", [
    "dceiflow-bi-adam",
    pytest.param("eraft-raft", marks=pytest.mark.slow),
    pytest.param("dceiflow-raft", marks=pytest.mark.slow),
    pytest.param("raft-raft", marks=pytest.mark.slow)])
def test_train_step_matches_jax(root, monkeypatch, case):
    """One ``make_train_step`` step against the JAX script's
    ``make_train_step`` from the same weights and batch: the loss and the
    EPE to 1e-6 relative; the gradients (the JAX optimizer wrapped to keep
    them; the port's after the clip, so the JAX ones scaled by the same
    clip) each leaf to 1e-4 of its largest magnitude, a bias that feeds a
    normalisation to 1e-5 of the step's largest gradient (its true gradient
    is 0); the BatchNorm running statistics to 1e-6; the parameters'
    updates over every leaf held per leaf to 1e-2 relative L2 (Adam's first step is
    lr * sign(g) wherever |g| >> eps, so a gradient element within
    rounding of 0 moves by lr either way); with ``--opt adam`` every
    parameter's step count 1, as the JAX optimizer's count of every
    top-level key. DCEIFlow's frame encoder ``fnet`` reads the smooth
    simulated frames, whose 1/8-resolution feature planes are nearly
    constant: there the JAX package's f32 gradient is 2-4% (relative L2)
    off an f64 evaluation of the same step and the port's 2e-6, and the
    pseudo-feature loss's L1 carries that error into a few elements of the
    other leaves. So DCEIFlow's leaves but the context encoder's are held
    to 5e-2 relative L2 against JAX and to 1e-5 relative L2 against the
    port's own f64 evaluation; ``cnet`` (train-mode BatchNorm, whose f32
    rounding both packages share: 3e-3 off f64) to the per-leaf 1e-4."""
    arch, bi, opt_name = STEPS[case]
    mode = "cista-eraft" if arch == "eraft" else "cista-eiflow"
    jcfg, cfg = configs(root, mode, is_bi=bi, is_reverse_events=bi)
    batch = step_batch(root, arch, cfg)
    params, state = jax_init(arch, jcfg)
    jopt = capturing(JPF.make_raft_optimizer(LR, 1000) if opt_name == "raft"
                     else JP.make_optimizer(LR))
    jstep = JPF.make_train_step(jcfg, jopt, bi, arch)
    jparams, jstate, (jgrads, jinner), jloss, jepe = jstep(
        params, state, jopt.init(params),
        {k: jnp.asarray(np.moveaxis(v, 1, -1)) for k, v in batch.items()})

    model = port_net(arch, cfg, params, state)
    opt = (pf.make_raft_optimizer(model, LR, 1000) if opt_name == "raft"
           else pf.make_optimizer(model, LR))
    clipped = {}

    def clip(grads, max_norm):
        clipped.update({id(g): g.clone() for g in grads})
        return clip_by_global_norm_(grads, max_norm)
    clip_by_global_norm_ = pf.clip_by_global_norm_
    monkeypatch.setattr(pf, "clip_by_global_norm_", clip)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss, epe = pf.make_train_step(cfg, opt, bi, arch)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert float(epe) == pytest.approx(float(jepe), rel=1e-6)

    jg = weights.flow_net_from_jax(np_tree(jgrads), np_tree(jstate))
    grads = {n: clipped.get(id(p.grad), p.grad).numpy() for n, p in model.named_parameters()}
    assert (opt_name == "raft") == bool(clipped)
    top = max(float(np.abs(jg[n]).max()) for n in grads)
    l2_leaves = []
    for n, g in grads.items():
        r = jg[n]
        if PRE_NORM_BIAS.match(n):
            assert float(np.abs(g - r).max()) <= 1e-5 * top, n
        elif arch == "dceiflow" and not n.startswith("cnet."):
            l2_leaves.append((n, g - r, r))
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * float(np.abs(r).max()),
                                       err_msg=n)
    if l2_leaves:
        g64 = f64_grads(arch, cfg, params, state, batch, bi)
        for n, d, r in l2_leaves:
            assert np.linalg.norm(d) <= 5e-2 * np.linalg.norm(r), n
            assert np.linalg.norm(grads[n] - g64[n]) <= 1e-5 * np.linalg.norm(g64[n]), n

    sd, jsd = model.state_dict(), weights.flow_net_from_jax(np_tree(jparams), np_tree(jstate))
    for k, v in jsd.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
    jbefore = weights.flow_net_from_jax(np_tree(params), np_tree(state))
    held_l2 = {n for n, _, _ in l2_leaves}
    kept = [n for n in before if not PRE_NORM_BIAS.match(n) and n not in held_l2]
    ours = np.concatenate([(sd[n] - before[n]).numpy().ravel() for n in kept])
    theirs = np.concatenate([(jsd[n] - jbefore[n]).ravel() for n in kept])
    assert np.linalg.norm(ours - theirs) <= 1e-2 * np.linalg.norm(theirs)
    if opt_name == "adam":
        assert {int(s["step"]) for s in opt.state.values()} == {1}
        assert len(opt.state) == len(before)
        counts = jinner.inner_state.count
        assert sorted(counts) == sorted(params) and {int(c) for c in counts.values()} == {1}


@pytest.mark.slow
def test_bf16_raft_step_is_within_bf16s_own_spread(root, monkeypatch):
    """One DCEIFlow step of the one-cycle AdamW (``--opt raft``) from the
    JAX init on one batch, in f32 and in bf16, in both packages: the
    losses within 1e-2 relative of the f32 loss, the global norms before
    the clip within 5% of the JAX f32 norm (JAX's own bf16 norm lies 4.1%
    from it on this batch, the port's 0.6%); per leaf (but the biases that feed
    a normalisation, whose true gradient is 0) the relative L2 distance
    between the port's and the JAX package's gradient: its median in f32
    below 1e-4, in bf16 no larger than 1.25 times the median distance
    between the JAX package's own bf16 and f32 gradients (the bf16 step
    differs from JAX's by bf16 rounding, not by a cast: a cast in another
    place shows as a distance above bf16's own); the parameters' updates
    likewise. ``-s`` prints the medians."""
    grads, updates, losses, norms = {}, {}, {}, {}
    clip = pf.clip_by_global_norm_
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = configs(root, dtype=dtype)
        batch = step_batch(root, "dceiflow", cfg)
        params, state = jax_init("dceiflow", jcfg)
        jopt = capturing(JPF.make_raft_optimizer(LR, 100))
        jparams, jstate, (jg, _), jloss, _ = JPF.make_train_step(jcfg, jopt, False, "dceiflow")(
            params, state, jopt.init(params),
            {k: jnp.asarray(np.moveaxis(v, 1, -1)) for k, v in batch.items()})
        model = port_net("dceiflow", cfg, params, state)
        seen = {}

        def keep(g, max_norm):
            seen["g"] = [t.clone() for t in g]
            seen["norm"] = clip(g, max_norm)
            return seen["norm"]
        monkeypatch.setattr(pf, "clip_by_global_norm_", keep)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        loss, _ = pf.make_train_step(cfg, pf.make_raft_optimizer(model, LR, 100), False)(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
        names = [n for n, _ in model.named_parameters()]
        theirs = weights.flow_net_from_jax(np_tree(jg), np_tree(jstate))
        grads["jax", dtype] = {n: theirs[n] for n in names}
        grads["port", dtype] = {n: g.numpy() for n, g in zip(names, seen["g"])}
        jbefore = weights.flow_net_from_jax(np_tree(params), np_tree(state))
        jafter = weights.flow_net_from_jax(np_tree(jparams), np_tree(jstate))
        updates["jax", dtype] = {n: jafter[n] - jbefore[n] for n in names}
        sd = model.state_dict()
        updates["port", dtype] = {n: (sd[n] - before[n]).numpy() for n in names}
        losses["jax", dtype], losses["port", dtype] = float(jloss), float(loss)
        norms["jax", dtype] = float(np.sqrt(sum(float((theirs[n].astype(np.float64) ** 2).sum())
                                                for n in names)))
        norms["port", dtype] = float(seen["norm"])
    f32 = losses["jax", "float32"]
    assert all(abs(v - f32) <= 1e-2 * f32 for v in losses.values()), losses
    assert all(abs(v - norms["jax", "float32"]) <= 5e-2 * norms["jax", "float32"]
               for v in norms.values()), norms

    def median(tree, a, b):
        return float(np.median([np.linalg.norm(tree[a][n] - tree[b][n])
                                / max(np.linalg.norm(tree[b][n]), 1e-30)
                                for n in tree[a] if not PRE_NORM_BIAS.match(n)]))
    for tree, what in ((grads, "gradients"), (updates, "updates")):
        f32_gap = median(tree, ("port", "float32"), ("jax", "float32"))
        ours = median(tree, ("port", "bfloat16"), ("jax", "bfloat16"))
        own = median(tree, ("jax", "bfloat16"), ("jax", "float32"))
        print(f"{what}: median relative L2 per leaf, port - JAX f32 {f32_gap:.3g}, port - JAX "
              f"bf16 {ours:.3g}, JAX bf16 - JAX f32 {own:.3g}, port bf16 - port f32 "
              f"{median(tree, ('port', 'bfloat16'), ('port', 'float32')):.3g}")
        assert ours <= 1.25 * own, (what, ours, own)
        if what == "gradients":
            assert f32_gap < 1e-4, f32_gap


def test_bf16_step_runs_and_casts_the_inputs(root, monkeypatch):
    """A bf16 step (f32 master parameters, NET_INPUTS cast): the loss is
    finite and close to the f32 step's (1e-2 relative: bf16 rounding of
    the activations), the parameters stay f32, and the frames reach the
    loss in bf16 as in the JAX step (its targets are built from the cast
    batch)."""
    jcfg, cfg = configs(root, "cista-eraft")
    batch = {k: torch.from_numpy(v) for k, v in step_batch(root, "eraft", cfg).items()}
    params, state = jax_init("eraft", jcfg)
    seen = {}

    def spy(out, target, cfg_, is_bi=False):
        seen.update({k: v.dtype for k, v in target.items()})
        return flow_sequence_loss(out, target, cfg_, is_bi)
    monkeypatch.setattr(pf, "flow_sequence_loss", spy)
    losses = {}
    for dtype in ("float32", "bfloat16"):
        cfg.dtype = dtype
        model = port_net("eraft", cfg, params, state)
        losses[dtype] = float(pf.make_train_step(
            cfg, pf.make_optimizer(model, LR), False, "eraft")(model, batch)[0])
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert np.isfinite(losses["bfloat16"])
    assert losses["bfloat16"] == pytest.approx(losses["float32"], rel=1e-2)
    assert seen["gt_img0"] == seen["gt_img1"] == torch.bfloat16
    assert seen["gt_flow"] == seen["valid"] == torch.float32


# ------------------------------- the entry points ------------------------------

def test_pretrain_cli_refuses_what_the_port_lacks(root, tmp_path, capsys):
    """RAFT on simulated data (grey frames) and E-RAFT on chairs2 (no voxel
    pair) refuse at once, naming why; ``--data_kind chairs2`` (the default)
    and RAFT on it are taken (``tests/test_torch_chairs2.py`` trains
    them)."""
    base = ["--path_to_train_data", root, "--device", "cpu"]
    for extra, why in ((["--flow_arch", "eraft"], "chairs2 has no event stream"),
                       (["--data_kind", "sim", "--flow_arch", "raft"], "RGB")):
        with pytest.raises(SystemExit) as e:
            pf.main(base + extra)
        assert e.value.code == 2
        assert why in capsys.readouterr().err
    for extra in ([], ["--flow_arch", "raft", "--image_dim", "64", "96"]):   # no chairs2 samples
        assert pf.main(base + extra + ["--epochs", "0", "--path_to_model",
                                       str(tmp_path)]) == 0
        assert "FlyingChairs2: 0 training samples" in capsys.readouterr().out


@pytest.mark.parametrize("hw, ok", [((368, 496), False), ((48, 64), False), ((32, 64), True),
                                    ((384, 512), True)])
def test_raft_step_needs_a_crop_divisible_by_32(hw, ok):
    """RAFT pads to /8 and the sequence loss pads its targets to /32, so
    ``make_train_step`` refuses RAFT at a crop that is not /32 (the JAX
    script's assertion), here the upstream chairs crop 368x496 too; the
    event nets pad to /32 themselves and take any crop."""
    cfg = Config(model_mode="cista-eiflow", image_dim=hw)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.0)
    for arch in ("dceiflow", "eraft"):
        pf.make_train_step(cfg, opt, False, arch)
    if ok:
        pf.make_train_step(cfg, opt, False, "raft")
    else:
        with pytest.raises(ValueError, match="/32"):
            pf.make_train_step(cfg, opt, False, "raft")


def test_pretrain_cli_checkpoints_load_into_both_trainers(root, tmp_path):
    """``python -m cista_flow_torch.pretrain_flow --data_kind sim`` for
    E-RAFT (and DCEIFlow, bidirectional with ``--opt raft``) writes
    ``{arch}_b5/{arch}_{epoch}.pth.tar`` holding ``{'epoch', 'model'}``;
    the file loads with ``strict=True`` into the port's ``Trainer``
    (``--path_to_flownet``, cista-eraft and cista-eiflow), and into the JAX
    package (``ti.load_state_dict`` + ``ti.eraft_params`` /
    ``dceiflow_params``, whose export gives back every key). A JAX
    ``pretrain_flow`` checkpoint (its own export and save lines) loads
    strictly into the port's ``Trainer``."""
    from cista_flow_torch.train import Trainer
    models = tmp_path / "models"
    for arch, extra, mode in (("eraft", [], "cista-eraft"),
                              ("dceiflow", ["--is_bi", "--is_reverse_events", "--opt", "raft"],
                               "cista-eiflow")):
        assert pf.main(["--data_kind", "sim", "--flow_arch", arch, "--path_to_train_data", root,
                        "--path_to_model", str(models), "--image_dim", str(H), str(W),
                        "--flow_iters", "1", "--batch_size", "2", "--epochs", "2",
                        "--device", "cpu", *extra]) == 0
        ckpt = models / f"{arch}_b5" / f"{arch}_2.pth.tar"
        saved = torch.load(ckpt, weights_only=True)
        assert sorted(saved) == ["epoch", "model"] and saved["epoch"] == 1
        assert (models / f"{arch}_b5" / f"{arch}_1.pth.tar").exists()
        sd = ti.load_state_dict(str(ckpt))
        p, s = (ti.eraft_params if arch == "eraft" else ti.dceiflow_params)(sd)
        back = EXPORTS[arch](np_tree(p), np_tree(s))
        assert sorted(back) == sorted(sd)
        for k, v in back.items():
            if not k.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(np.asarray(v), sd[k], err_msg=k)
        cfg = Config(model_mode=mode, image_dim=(H, W), path_to_train_data=root,
                     path_to_model=str(tmp_path / "trained"), path_to_flownet=str(ckpt),
                     len_sequence=2, depth=1)
        trainer = Trainer(cfg, "cpu")
        got = trainer.model.event_flownet.state_dict()
        assert sorted(got) == sorted(saved["model"])
        for k, v in saved["model"].items():
            assert torch.equal(got[k], v), k

    # a JAX pretrain_flow checkpoint, written as pretrain_flow.py:195-201 writes it
    jcfg, _ = configs(root)
    params, state = jax_init("dceiflow", jcfg, seed=3)
    jsd = {k: torch.from_numpy(np.array(v))
           for k, v in ti.dceiflow_export(jax.device_get(params), jax.device_get(state)).items()}
    path = tmp_path / "dceiflow_1.pth.tar"
    torch.save({"epoch": 0, "model": jsd}, path)
    cfg = Config(model_mode="cista-eiflow", image_dim=(H, W), path_to_train_data=root,
                 path_to_model=str(tmp_path / "trained"), path_to_flownet=str(path),
                 len_sequence=2, depth=1)
    got = Trainer(cfg, "cpu").model.event_flownet.state_dict()
    for k, v in jsd.items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k


def test_sim_flow_quality_cpu(tmp_path):
    """``python -m cista_flow_torch.sim_flow_quality --device cpu`` on a
    tiny set: one JSON line with the JAX script's keys, finite EPEs, the
    zero-flow baseline equal to a numpy evaluation of the held-out flows,
    and the checkpoint ``{flow_arch}_sim_{epochs}.pth.tar``."""
    args = ["--workdir", str(tmp_path), "--image_dim", str(H), str(W), "--n_videos", "2",
            "--n_frames", "4", "--eval_videos", "1", "--epochs", "2", "--batch_size", "2",
            "--dtype", "float32", "--opt", "raft", "--device", "cpu"]
    out = sfq.run(sfq.parse_args(args))
    assert sorted(out) == sorted(["epe_zero", "epe_init", "epe_trained", "beats_zero_flow",
                                  "epochs", "ckpt"])
    assert all(np.isfinite(out[k]) for k in ("epe_zero", "epe_init", "epe_trained"))
    assert out["ckpt"] == os.path.join(str(tmp_path), "models", "dceiflow_sim_2.pth.tar")
    assert sorted(torch.load(out["ckpt"], weights_only=True)) == ["epoch", "model"]
    eval_ds = SimFlowPairs(Config(model_mode="cista-eiflow", image_dim=(H, W), len_sequence=1,
                                  path_to_train_data=str(tmp_path / "eval")))
    zero = np.mean([np.sqrt((eval_ds[i]["gt_flow"].astype(np.float64) ** 2).sum(0)).mean()
                    for i in range(len(eval_ds))])
    assert out["epe_zero"] == round(float(zero), 3)


@pytest.mark.slow
@pytest.mark.parametrize("opt,dtype,trained_tol", [("adam", "float32", 1e-2),
                                                   ("raft", "float32", 1e-2),
                                                   ("raft", "bfloat16", 5e-2)])
def test_sim_flow_quality_matches_the_root_script(tmp_path, monkeypatch, capsys, opt, dtype,
                                                  trained_tol):
    """The port's ``sim_flow_quality.main`` and the root script's on the
    same tiny set, from the same initial weights (the port's ``flow_net``
    made to load the JAX script's ``init(PRNGKey(seed))``), with Adam in
    f32 and with the one-cycle AdamW and its clip (``--opt raft``) in f32
    and in bf16: the same keys, ``epe_zero`` equal to 1e-3 (both are
    rounded to 3 decimals), ``epe_init`` to 1e-3 in f32 and 2e-3 in bf16
    (the untrained net's bf16 forward rounds its flow at ~4e-3 relative),
    ``epe_trained`` to ``trained_tol`` after 2 epochs of 3 steps each: 1e-2
    in f32 (Adam's first steps move a gradient element within rounding of 0
    by lr either way), 5e-2 in bf16, the size of bf16's own effect here:
    the root script's bf16 and f32 runs of this case end 0.044 apart (4.686
    against 4.642), and one bf16 step's gradient lies as far from the JAX
    bf16 one (median relative L2 per leaf 0.281) as each package's bf16
    gradient from its f32 one (0.289, 0.281;
    ``test_bf16_raft_step_is_within_bf16s_own_spread``)."""
    import sim_flow_quality as JSFQ
    args = ["--image_dim", str(H), str(W), "--n_videos", "2", "--n_frames", "4",
            "--eval_videos", "1", "--epochs", "2", "--batch_size", "2", "--dtype", dtype,
            "--opt", opt]
    assert JSFQ.main(args + ["--workdir", str(tmp_path / "jax")]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    make = pf.flow_net

    def jax_weights(arch, cfg, device=None):
        model = make(arch, cfg, device="cpu")
        params, state = jax_init(arch, JConfig(image_dim=cfg.image_dim,
                                               model_mode=cfg.model_mode), seed=cfg.seed)
        model.load_state_dict({k: torch.tensor(v) for k, v in weights.flow_net_from_jax(
            np_tree(params), np_tree(state)).items()}, strict=True)
        return model
    monkeypatch.setattr(pf, "flow_net", jax_weights)
    assert sfq.main(args + ["--workdir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(ours) == sorted(theirs)
    init_tol = 1e-3 if dtype == "float32" else 2e-3
    for k, tol in (("epe_zero", 1e-3), ("epe_init", init_tol), ("epe_trained", trained_tol)):
        assert abs(ours[k] - theirs[k]) <= tol, (k, ours[k], theirs[k])
    assert ours["epochs"] == theirs["epochs"]


@pytest.mark.parametrize("arch", ["dceiflow", pytest.param("eraft", marks=pytest.mark.slow),
                                  pytest.param("raft", marks=pytest.mark.slow)])
def test_seeded_init_has_the_jax_init_distribution(arch):
    """The port's seeded ``flow_net`` (what ``sim_flow_quality`` trains from)
    against ``init(PRNGKey(0))`` of the JAX script, leaf by leaf: the same
    keys; the norms' constant leaves equal; every conv weight's standard
    deviation within 10% of the JAX leaf's (the encoders' kaiming normal
    over fan_out, the update block's torch-default uniform); every bias,
    in both packages, inside the torch-default bound 1/sqrt(fan_in) of its
    conv, and over all of a net's biases of one fan-in the std within 10%.
    Each case is mostly the JAX init's compile (12-18 s): DCEIFlow, the
    net of ``sim_flow_quality``, runs in the fast tier."""
    mode = "cista-eraft" if arch == "eraft" else "cista-eiflow"
    params, state = jax_init(arch, JConfig(image_dim=(H, W), model_mode=mode))
    theirs = weights.flow_net_from_jax(np_tree(params), np_tree(state))
    ours = {k: v.numpy() for k, v in pf.flow_net(arch, Config(image_dim=(H, W), model_mode=mode),
                                                 "cpu", seed=0).state_dict().items()}
    assert sorted(ours) == sorted(theirs)
    pooled = {}
    for k, t in theirs.items():
        o = ours[k]
        assert o.shape == t.shape, k
        if t.size < 2 or t.std() == 0:
            np.testing.assert_array_equal(o, t, err_msg=k)
            continue
        if t.ndim == 4:
            assert abs(o.std() / t.std() - 1) < 0.1, (k, o.std(), t.std())
        elif k.endswith(".bias") and k[:-5] + ".weight" in theirs \
                and theirs[k[:-5] + ".weight"].ndim == 4:
            fan_in = int(np.prod(theirs[k[:-5] + ".weight"].shape[1:]))
            bound = fan_in ** -0.5
            assert np.abs(o).max() <= bound and np.abs(t).max() <= bound, k
            pooled.setdefault(fan_in, ([], []))
            pooled[fan_in][0].append(o.ravel())
            pooled[fan_in][1].append(t.ravel())
    for fan_in, (o, t) in pooled.items():
        o, t = np.concatenate(o), np.concatenate(t)
        if t.size >= 256:
            assert abs(o.std() / t.std() - 1) < 0.1, (fan_in, o.std(), t.std())


def test_step_timer_matches_the_jax_timer():
    """``utils.profiling.StepTimer`` keeps the JAX timer's warm-up and its
    summary's fields: given the same step times, the same summary and the
    same printed line."""
    from cista_flow_torch.utils.profiling import StepTimer
    from cista_flow_tpu.utils.profiling import StepTimer as JStepTimer
    ours, theirs = StepTimer("epoch1", warmup=1), JStepTimer("epoch1", warmup=1)
    assert ours.summary() == theirs.summary() == {"name": "epoch1", "steps": 0}
    for t in (ours, theirs):
        for _ in range(4):
            t.start()
            t.stop(torch.zeros(2) if t is ours else jnp.zeros(2))
    assert len(ours.times) == len(theirs.times) == 3
    ours.times = list(theirs.times)
    assert ours.summary() == theirs.summary()
    assert str(ours) == str(theirs)


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
