"""The port's composite in train mode and its BPTT train step against the
JAX package's (``composite.apply(train=True)``, ``make_train_step``) on the
CPU, in f32.

The weights, carried across with ``weights.from_jax``: the reconstructor
from ``composite.init`` of the JAX package at base width 16, its 1x1 output
conv scaled by 300, and the flow net of the committed anchor
``gate/flagship_sim40_f16.npz``. At the JAX init the reconstruction is 0.5
to within 1e-4 everywhere, and the next step's flow net reads it through
instance norms that scale those 1e-4 up to unit variance: the JAX package
against itself moves the flow by 7e-3 when that frame moves by 1e-7. The
scaled head gives frames with contrast. A flow net at its random init puts
near-dead channels into its train-mode BatchNorms, whose f32 gradient then
depends on rounding (port and JAX each several % off an f64 evaluation); the
anchor's trained flow net does not.
"""
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
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_torch import weights
from cista_flow_torch.config import Config
from cista_flow_torch.data.sim import write_train_dataset
from cista_flow_torch.data.train_loader import StackedSequenceLoader, TrainSequenceDataset
from cista_flow_torch.models import composite
from cista_flow_torch.parallel import train_step as TS

REPO = Path(__file__).resolve().parent.parent
ANCHOR = REPO / "gate" / "flagship_sim40_f16.npz"
H, W = 48, 64
SMALL = dict(image_dim=(H, W), model_mode="cista-eiflow", depth=2, base_channels=16,
             flow_iters=2, len_sequence=3, batch_size=2, lr=1e-4)
# the flow net's encoders: they read inputs that are constant over most of
# the frame (cnet and fnet the zero reconstruction at the first step of every
# sequence, enet event voxels that are zero on most pixels)
ENCODERS = ("event_flownet.cnet.", "event_flownet.fnet.", "event_flownet.enet.")
# a bias whose conv feeds a normalisation over its channels (instance norm, or
# BatchNorm in train mode): its true gradient is 0, the computed one rounding
PRE_NORM_BIAS = re.compile(
    r"event_flownet\.(fnet|enet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))\.bias")


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ----------------------------- the composite in train mode ------------------

@pytest.fixture(scope="module")
def small():
    """JAX (params, model_state): the reconstructor from ``composite.init``
    at base width 16 with its head scaled, the flow net the committed
    anchor's (see the module's docstring); and a config pair."""
    jcfg = JConfig(**SMALL)
    params, mstate = JCOMP.init(jax.random.PRNGKey(0), jcfg)
    params["cista"]["final"] = jax.tree_util.tree_map(lambda a: 300.0 * a,
                                                      params["cista"]["final"])
    anchor, anchor_state = ti.composite_params(ti.load_state_dict(str(ANCHOR)), "cista-eiflow")
    params["flow"], mstate["flow"] = anchor["flow"], anchor_state["flow"]
    return jcfg, Config(**SMALL), params, mstate


def _port(cfg, params, mstate, dtype=torch.float32):
    model = composite.init(cfg, device="cpu")
    model.load_reference_state(weights.from_jax(np_tree(params), np_tree(mstate)))
    return model.to(dtype)


@pytest.mark.parametrize("case", ["gt_img1+bw", "gt_flow", "fix_flow"])
def test_composite_train_step_matches_jax(small, case):
    """One composite step with ``batch_gt`` in train mode against
    ``composite.apply(train=True)``: the reconstruction, every flow output,
    the features of the pseudo-feature loss, the new state and the BN
    running statistics, to 1e-4 abs (f32 chains of convs)."""
    jcfg, cfg, params, mstate = small
    rng = np.random.default_rng(7)
    b = 2
    ev = rng.standard_normal((b, H, W, 5)).astype(np.float32)
    rec0 = rng.random((b, H, W, 1)).astype(np.float32)
    gt = {"gt_img1": rng.random((b, H, W, 1)).astype(np.float32)}
    extra = {}
    fix = "rec"
    if case == "gt_img1+bw":
        extra["event_voxel_bw"] = rng.standard_normal((b, H, W, 5)).astype(np.float32)
    elif case == "gt_flow":
        gt["gt_flow"] = (2.0 * rng.standard_normal((b, H, W, 2))).astype(np.float32)
    else:
        fix = "flow"
    st = [(0.3 * rng.standard_normal((b, H // 2, W // 2, ch))).astype(np.float32)
          for ch in (32, 32, 16, 16)]
    jr, jf, jst, jm = JCOMP.apply(
        params, mstate, {"event_voxel": jnp.asarray(ev), "rec_img0": jnp.asarray(rec0),
                         **{k: jnp.asarray(v) for k, v in extra.items()}},
        JCOMP.zero_state(b, jcfg)._replace(**{f: jnp.asarray(a) for f, a in zip(
            ("lstc_cell", "sparse_code", "dg_hidden", "dg_cell"), st)}),
        jcfg, batch_gt={k: jnp.asarray(v) for k, v in gt.items()}, fix_net_name=fix,
        train=True)
    model = _port(cfg, params, mstate).train()
    with torch.no_grad():
        r, f, nst = model(nchw(ev), nchw(rec0), composite.CistaState(*map(nchw, st)),
                          collect_preds=True, batch_gt={k: nchw(v) for k, v in gt.items()},
                          fix_net_name=fix,
                          event_voxel_bw=nchw(extra["event_voxel_bw"]) if extra else None)
    assert model.event_flownet.training == (fix != "flow")
    def close(a, b):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4)
    close(nhwc(r), jr)
    assert sorted(f) == sorted(jf)
    for k in f:
        close(nhwc(f[k]), jf[k])
    for a, bb in zip(nst, jst):
        close(nhwc(a), bb)
    sd, ref = model.state_dict(), weights.from_jax(np_tree(params), np_tree(jm))
    for k in sd:
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), ref[k], rtol=1e-5, atol=1e-6)
    if fix == "flow":
        for k in sd:
            if "running" in k:
                assert np.array_equal(sd[k].numpy(), weights.from_jax(
                    np_tree(params), np_tree(mstate))[k])



# ----------------------------- the BPTT train step --------------------------

@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """One (T=3, B=2) batch of simulated training data at 48x64, as NCHW
    numpy (the voxels f32, as the trainer moves them)."""
    root = tmp_path_factory.mktemp("seq")
    idx = write_train_dataset(str(root), 2, 4, H, W, seed=0)
    cfg = Config(**SMALL, path_to_train_data=str(root), is_reverse_events=True, is_bi=True)
    batch = next(iter(StackedSequenceLoader(TrainSequenceDataset(idx, cfg), 2, 3,
                                            shuffle=False, num_workers=0)))
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _capturing(opt):
    """An optimizer that also returns the gradients it was given, in its
    state (the JAX train step keeps its gradients inside)."""
    def init(p):
        return opt.init(p), jax.tree_util.tree_map(jnp.zeros_like, p)

    def update(g, s, p=None):
        u, inner = opt.update(g, s[0], p)
        return u, (inner, g)
    return optax.GradientTransformation(init, update)


PHASES = {"phase2": ("flow", "rec", False, False),
          "phase3_flow_half": ("rec", "both", False, False),
          "phase1": ("rec", "flow", True, False),
          "bidirectional": ("rec", "both", False, True)}


@pytest.mark.parametrize("phase", [
    "phase2", "phase3_flow_half",
    pytest.param("phase1", marks=pytest.mark.slow),
    pytest.param("bidirectional", marks=pytest.mark.slow)])
def test_train_step_matches_jax(small, seq, phase):
    """One optimizer step of the port against ``make_train_step`` on the same
    parameters and batch (cista-eiflow, 48x64, base width 16, depth 2, 2 GRU
    iterations, T = 3, batch 2, lr 1e-4):
    * the loss to 1e-5 relative;
    * every gradient leaf to 1e-4 of its largest magnitude, but for two
      kinds of leaf: a bias that feeds a normalisation has a true gradient
      of 0 and is held to 1e-5 of the largest gradient of the step; and
      where the flow net trains, its three encoders read inputs that are
      constant over most of the frame (``cnet``, BatchNorm in train mode,
      and ``fnet`` the zero reconstruction at the first step of every
      sequence; ``enet`` event voxels, zero on most pixels): near-constant
      channels whose normalisation amplifies f32 rounding, and weight
      gradients that are sums that cancel. Their leaves are held to 5e-2
      relative L2 each, the leaves their error reaches
      through the GRU to 1e-3 of their largest magnitude, and the trained
      subnet to 2e-3 relative L2 as a whole (the JAX package's own f32
      gradient of cnet on such a frame is 2e-2 off an f64 evaluation of the
      same function);
    * the parameters after the step to 1e-6 absolute against JAX's wherever
      the gradient is settled: the two packages' share a sign and JAX's is
      above the gradient tolerance, 1e-4 of its leaf's largest magnitude
      (never on a bias that feeds a normalisation, nor on the encoders'
      leaves where they are held loosely above; Adam's first step
      moves an element by lr g / (|g| + 1e-8), the sign of g unless g is
      tiny); and everywhere to 1e-6 against JAX's optimizer fed the port's
      gradients;
    * the BN running statistics to 1e-5 of their largest magnitude (batch
      means and variances of conv outputs that differ by ~1e-6 between the
      packages, over three steps whose frames carry the reconstructions'
      own differences); the frozen subnet, its statistics and its (absent)
      Adam state bit for bit."""
    jcfg0, cfg0, params, mstate = small
    fix, mode, gt_flow, bi = PHASES[phase]
    jcfg = JConfig(**SMALL, is_bi=bi)
    cfg = Config(**SMALL, is_bi=bi)
    keys = ["event_voxel", "gt_img0", "gt_img1", "gt_flow"]
    if bi:
        keys += ["event_voxel_bw", "gt_flow_bw"]
    batch = {k: seq[k] for k in keys}

    jopt = _capturing(JP.make_optimizer(1e-4))
    jstep = JP.make_train_step(jcfg, jopt, mode, fix, gt_flow, donate=False)
    jparams, jmstate, (jinner, jgrads), jloss = jstep(
        params, mstate, jopt.init(params),
        {k: jnp.asarray(np.moveaxis(v, 2, -1)) for k, v in batch.items()})

    model = _port(cfg, params, mstate)
    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    opt = TS.make_optimizer(model, 1e-4)
    loss = TS.make_train_step(cfg, opt, mode, fix, gt_flow)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    adam = JP.make_optimizer(1e-4)
    jadam = weights.from_jax(np_tree(optax.apply_updates(params, adam.update(
        _port_grads_as_jax(model, params), adam.init(params), params)[0])), np_tree(mstate))
    check_step(fix, float(loss), float(jloss), grads_of(model),
               weights.from_jax(np_tree(jgrads), np_tree(mstate)),
               state_of(model), weights.from_jax(np_tree(jparams), np_tree(jmstate)), jadam,
               before)
    frozen = TS.SUBNETS[fix]
    assert all(p not in opt.state for k, p in model.named_parameters() if k.startswith(frozen))


def grads_of(model) -> dict:
    """Every parameter's gradient as numpy (None where it has none)."""
    return {k: None if p.grad is None else p.grad.numpy()
            for k, p in model.named_parameters()}


def state_of(model) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def check_step(fix, loss, ref_loss, grads, ref_grads, after, ref_after, adam_after, before,
               normed: bool = True):
    """One train step (``loss``, every parameter's gradient ``grads``, the
    state dict ``after`` it) against a reference's, at the tolerances of
    ``test_train_step_matches_jax`` (its docstring gives the reasons):
    ``adam_after`` is the reference optimizer's step fed ``grads``,
    ``before`` the state dict before the step; the frozen subnet
    (``fix``, None where nothing is frozen) has no gradient and keeps its
    state bit for bit. ``normed``: the flow net normalises its encoders'
    convs (DCEIFlow, E-RAFT; IDNet's LiteEncoder has no norm, so its leaves
    take neither exception below)."""
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    frozen = (TS.SUBNETS[fix],) if fix else ()
    top = max(float(np.abs(g).max()) for g in grads.values() if g is not None)
    loose = fix == "rec"                     # the flow net trains: cnet's BN in train mode
    num = den = 0.0
    for k, g in grads.items():
        if k.startswith(frozen):
            assert g is None and not np.any(ref_grads[k]), k
            continue
        g, ref = g.astype(np.float64), ref_grads[k].astype(np.float64)
        if normed and PRE_NORM_BIAS.match(k):
            assert max(np.abs(g).max(), np.abs(ref).max()) <= 1e-5 * top, k
            continue
        num, den = num + np.sum((g - ref) ** 2), den + np.sum(ref ** 2)
        if normed and loose and k.startswith(ENCODERS):
            assert np.linalg.norm(g - ref) <= 5e-2 * np.linalg.norm(ref), k
        else:
            np.testing.assert_allclose(g, ref, rtol=0, atol=(1e-3 if loose else 1e-4)
                                       * np.abs(ref).max(), err_msg=k)
    assert np.sqrt(num) <= (2e-3 if loose else 1e-4) * np.sqrt(den)

    for k, g in grads.items():
        if k.startswith(frozen):
            continue
        a, ref, rg = after[k], ref_after[k], ref_grads[k]
        settled = ((g * rg > 0) & (np.abs(rg) > 1e-4 * np.abs(rg).max())
                   & (not normed or PRE_NORM_BIAS.match(k) is None)
                   & (not (normed and loose and k.startswith(ENCODERS))))
        np.testing.assert_allclose(a[settled], ref[settled], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(a, adam_after[k], rtol=0, atol=1e-6, err_msg=k)
    for k in after:
        if "running" in k:
            np.testing.assert_allclose(after[k], ref_after[k], rtol=0,
                                       atol=1e-5 * max(np.abs(ref_after[k]).max(), 1.0),
                                       err_msg=k)
        if k.startswith(frozen) or (fix == "flow" and "running" in k):
            assert np.array_equal(after[k], before[k]), k


def _port_grads_as_jax(model, params):
    """The port's gradients as a JAX tree shaped like ``params`` (zeros
    for the frozen subnet): through the port's reference-layout state dict
    and the JAX importer."""
    sd = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
          for k, p in model.named_parameters(remove_duplicate=False)}
    sd = weights.tie_ista_blocks(sd, model.cfg.depth)
    for k, v in model.state_dict().items():
        sd.setdefault(k, v.numpy())
    g, _ = ti.composite_params(sd, "cista-eiflow")
    return jax.tree_util.tree_map(lambda a, b: jnp.asarray(a, b.dtype), g, params)


