"""Training pieces of the port against the JAX package's on the CPU, in
f32: the train-mode BatchNorm, the kernels' ``autograd.Function``s (each
wrapper built as on the card, its kernel's forward swapped for the plain
version), the variant routes' gradients (K3a, K4s; K6 refuses one), the weight cache
across an optimizer step, the half-resolution warp flow, the phase
schedule, the optimizer across a freeze and an unfreeze, and
``python -m cista_flow_torch.train`` on a tiny simulated set.
tests/test_torch_train_step.py holds the composite in train mode and the
BPTT train step against ``make_train_step``.
"""
import os
import sys
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
from cista_flow_tpu.ops import conv as JC
from cista_flow_torch import weights
from cista_flow_torch.config import Config
from cista_flow_torch.data.sim import write_train_dataset
from cista_flow_torch.models import composite
from cista_flow_torch.ops import autograd as AG
from cista_flow_torch.ops import conv as TC
from cista_flow_torch.ops import (conv_tile, cuda_aug, cuda_conv, cuda_corr, cuda_ista, cuda_ista2,
                                  cuda_norm)
from cista_flow_torch.ops.corr import CorrPyramid
from cista_flow_torch.parallel import train_step as TS

REPO = Path(__file__).resolve().parent.parent
H, W = 48, 64
SMALL = dict(image_dim=(H, W), model_mode="cista-eiflow", depth=2, base_channels=16,
             flow_iters=2, len_sequence=3, batch_size=2, lr=1e-4)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


# ----------------------------- 0c: train-mode BatchNorm ---------------------

@pytest.mark.parametrize("shape", [(2, 6, 5, 4), (3, 4, 7, 16)])
def test_batch_norm_train_matches_jax(shape):
    """Output and the updated running statistics, to 1e-6 relative;
    ``num_batches_tracked`` counts the update, as torch's module does; inside
    ``frozen_bn_stats`` (remat's recompute) the output is the same and the
    statistics and the count stay."""
    rng = np.random.default_rng(sum(shape))
    b, h, w, c = shape
    x = (3.0 * rng.standard_normal(shape) + 1.0).astype(np.float32)
    p = {"scale": rng.random(c).astype(np.float32) + 0.5,
         "bias": rng.standard_normal(c).astype(np.float32)}
    s = {"mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.random(c).astype(np.float32) + 0.1}
    ref, ref_state = JC.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                                   {k: jnp.asarray(v) for k, v in s.items()},
                                   jnp.asarray(x), train=True)
    bn = torch.nn.BatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    out = TC.batch_norm(nchw(x), bn)
    np.testing.assert_allclose(nhwc(out), ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_state["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_state["var"], rtol=1e-6, atol=1e-7)
    assert int(bn.num_batches_tracked) == 1
    stats = [t.clone() for t in bn.buffers()]
    with TC.frozen_bn_stats():
        again = TC.batch_norm(nchw(x), bn)
    assert torch.equal(again, out)
    assert all(torch.equal(a, b) for a, b in zip(bn.buffers(), stats))
    bn.eval()                                  # eval mode leaves the statistics alone
    before = bn.running_var.clone()
    TC.batch_norm(nchw(x), bn)
    assert torch.equal(bn.running_var, before)


# ----------------------------- 0a: the kernels' Functions -------------------

def _kernel_cases(dtype):
    """name -> (module, {kernel forward: its plain stand-in}, the wrapper's
    call, the plain version's call, tensor inputs) at tiny shapes."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, dtype=dtype)).requires_grad_(True)

    levels = [r(6, 5, 6), r(6, 3, 3), r(6, 2, 2), r(6, 1, 1)]
    coords = (torch.rand(1, 2, 2, 3, generator=g, dtype=dtype) * 5.0 - 0.5).requires_grad_(True)
    pyr = CorrPyramid(tuple(levels), 1, 2, 3)

    def k1(plain):
        def call(coords, weight, bias, *lv):
            fn = cuda_corr.lookup_plain if plain else cuda_corr.lookup
            return fn(pyr._replace(levels=lv), coords, weight, bias)
        return call

    def k3(plain):
        def call(dw, db, pw, pb, lam, gw, gb, x1, z):
            fn = cuda_ista2.fused_ista_dg_plain if plain else cuda_ista2.fused_ista_dg
            return fn((dw, db, pw, pb, lam), gw, gb, x1, z, 2)
        return call

    def k3a(plain):
        def call(dw, db, pw, pb, lam, x1, z):
            fn = cuda_ista2.ista_loop_plain if plain else cuda_ista2.fused_ista_v2
            return fn((dw, db, pw, pb, lam), x1, z, 2)
        return call

    c = 2
    ista = (r(c, 2 * c, 3, 3, scale=0.3), r(c), r(2 * c, c, 3, 3, scale=0.3), r(2 * c),
            (0.05 * torch.rand(2 * c, generator=g, dtype=dtype)).requires_grad_(True))
    return {
        "K1": (cuda_corr, {"_lookup_kernel": cuda_corr.lookup_plain}, k1(False), k1(True),
               (coords, r(256, 324, 1, 1, scale=0.05), r(256), *levels)),
        "K2": (cuda_aug, {"_warp_kernel": lambda img, flow, gate, sign:
                          cuda_aug.warp_reflect_plain(img, flow, sign, gate)},
               lambda img, flow, gate: cuda_aug.warp_reflect(img, flow, -1.0, gate),
               lambda img, flow, gate: cuda_aug.warp_reflect_plain(img, flow, -1.0, gate),
               (r(1, 3, 5, 6), r(1, 2, 5, 6, scale=2.0), torch.tensor(True))),
        "K3": (cuda_ista2, {"_fused_ista_dg_kernel": cuda_ista2.fused_ista_dg_plain}, k3(False),
               k3(True),
               (r(c, 2 * c, 3, 3, scale=0.3), r(c), r(2 * c, c, 3, 3, scale=0.3), r(2 * c),
                (0.05 * torch.rand(2 * c, generator=g, dtype=dtype)).requires_grad_(True),
                r(c, 2 * c, 3, 3, scale=0.3), r(c), r(1, c, 5, 6), r(1, 2 * c, 5, 6))),
        "K3a": (cuda_ista2, {"_fused_ista_v2_kernel": cuda_ista2.ista_loop_plain}, k3a(False),
                k3a(True), (*ista, r(1, c, 5, 6), r(1, 2 * c, 5, 6))),
        "K4": (cuda_norm, {"_instance_norm_kernel": cuda_norm.instance_norm_plain},
               lambda x: cuda_norm.instance_norm_fused(x, 1e-5, True),
               lambda x: cuda_norm.instance_norm_plain(x, 1e-5, True), (r(2, 3, 4, 5),)),
        # K4s: the statistics from the kernel, the normalise elementwise
        "K4s": (cuda_norm, {"instance_norm_stats": cuda_norm.instance_norm_stats_plain},
                lambda x: cuda_norm.instance_norm_from_stats(x, 1e-5, True),
                lambda x: cuda_norm.instance_norm_plain(x, 1e-5, True), (r(2, 3, 4, 5),)),
        "K5": (cuda_conv, {"_conv3x3_kernel": cuda_conv.conv3x3_plain},
               lambda x, w, b: cuda_conv.conv3x3(x, w, b, "reflect", True),
               lambda x, w, b: cuda_conv.conv3x3_plain(x, w, b, "reflect", True),
               (r(1, 4, 5, 6), r(4, 4, 3, 3, scale=0.3), r(4))),
    }


def _as_on_the_card(monkeypatch, key, dtype):
    """The wrapper as it runs on the card (``on_cpu`` answers False, so its
    ``autograd.Function`` is built as there), with its kernel's forward
    swapped for the plain version. Returns the case."""
    mod, swaps, wrapper, plain, inputs = _kernel_cases(dtype)[key]
    monkeypatch.setattr(mod, "on_cpu", lambda t: False)
    for name, fn in swaps.items():
        monkeypatch.setattr(mod, name, fn)
    return wrapper, plain, inputs


@pytest.mark.parametrize("key", ["K1", "K2", "K3", "K3a", "K4", "K4s", "K5"])
def test_kernel_function_gradcheck(monkeypatch, key):
    """Each wrapper's Function, with its plain version as the forward,
    passes ``gradcheck`` in float64 (fast mode: random projections of the
    Jacobian, every input that requires a gradient)."""
    wrapper, _, inputs = _as_on_the_card(monkeypatch, key, torch.float64)
    assert torch.autograd.gradcheck(wrapper, inputs, fast_mode=True, eps=1e-6, atol=1e-5,
                                    rtol=1e-3)


@pytest.mark.parametrize("key", ["K1", "K2", "K3", "K3a", "K4", "K4s", "K5"])
def test_kernel_function_grads_equal_plain_autograd(monkeypatch, key):
    """In f32, the Function's gradients are autograd's of the plain version
    bit for bit: its backward recomputes the same function on the same
    inputs."""
    wrapper, plain, inputs = _as_on_the_card(monkeypatch, key, torch.float32)
    wanted = [t for t in inputs if t.requires_grad]
    out = wrapper(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    assert all(type(o.grad_fn).__name__ == "KernelFunctionBackward" for o in outs)
    assert all(o.grad_fn.kernel == key for o in outs)
    cots = [torch.randn_like(o) for o in outs]
    got = torch.autograd.grad(outs, wanted, cots)
    ref_out = plain(*inputs)
    ref = torch.autograd.grad(ref_out if isinstance(ref_out, tuple) else (ref_out,), wanted, cots)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_apply_kernel_calls_the_forward_directly_without_grad():
    """Serving: grad mode off, or no input that requires a gradient, runs
    the forward alone and records nothing."""
    calls = []

    def fwd(x):
        calls.append(1)
        return x * 2.0
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert AG.apply_kernel("K0", fwd, None, x).grad_fn is None
    assert AG.apply_kernel("K0", fwd, None, torch.ones(3)).grad_fn is None
    assert AG.apply_kernel("K0", fwd, lambda t: t * 2.0, x).grad_fn is not None
    assert len(calls) == 3


@pytest.mark.parametrize("route", ["K3a", "K6", "K4s"])
def test_variant_routes_refuse_grad_on_the_card(monkeypatch, route):
    """On the card (``on_cpu`` made to answer False, as for a CUDA tensor)
    the variant routes take a gradient where the JAX package gives one: K3a
    (``pallas_ista2``'s ``custom_vjp``) and the K4s route
    ``instance_norm_from_stats`` (``instance_norm_statskernel``'s) build
    their ``KernelFunction`` (equal to autograd of the plain version and
    ``gradcheck``-ed in ``test_kernel_function_*``). K6, which has no
    ``custom_vjp`` in the JAX package, and the K4s statistics on their own
    raise before any launch."""
    w = tuple(torch.zeros(s, requires_grad=True) for s in
              ((16, 32, 3, 3), (16,), (32, 16, 3, 3), (32,), (32,)))
    x1, z = torch.zeros(1, 16, 4, 4), torch.zeros(1, 32, 4, 4)
    x = torch.zeros(1, 4, 4, 4, requires_grad=True)
    mod = {"K3a": cuda_ista2, "K6": cuda_ista, "K4s": cuda_norm}[route]
    monkeypatch.setattr(mod, "on_cpu", lambda t: False)
    if route == "K6":
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_ista.fused_ista(w, x1, z, 1)
        return
    if route == "K4s":
        with pytest.raises(RuntimeError, match="no backward"):
            cuda_norm.instance_norm_stats(x)
    monkeypatch.setattr(mod, *{"K3a": ("_fused_ista_v2_kernel", cuda_ista2.ista_loop_plain),
                               "K4s": ("instance_norm_stats",
                                       cuda_norm.instance_norm_stats_plain)}[route])
    out = (cuda_ista2.fused_ista_v2(w, x1, z, 1) if route == "K3a"
           else cuda_norm.instance_norm_from_stats(x, relu=True))
    assert type(out.grad_fn).__name__ == "KernelFunctionBackward"
    assert out.grad_fn.kernel == route


@pytest.mark.parametrize("route", ["K3a", "K4s"])
def test_variant_route_grads_match_jax(monkeypatch, route):
    """The port's gradient through K3a and the K4s route (as on the card,
    each kernel's forward swapped for its plain version) against
    ``jax.grad`` through the JAX package's ``pallas_ista2.fused_ista_v2``
    and ``pallas_norm.instance_norm_statskernel`` (interpret mode, as its
    own tests run them), to 1e-5 of each gradient's largest magnitude."""
    from cista_flow_tpu.nn import layers as JL
    from cista_flow_tpu.ops import pallas_ista2 as JPI
    from cista_flow_tpu.ops import pallas_norm as JPN
    rng = np.random.default_rng(31)
    if route == "K4s":
        x = (rng.standard_normal((2, 8, 16, 32)) + 0.3).astype(np.float32)
        cot = rng.standard_normal(x.shape).astype(np.float32)
        ref = jax.grad(lambda a: jnp.sum(JPN.instance_norm_statskernel(a, 1e-5, True, True)
                                         * cot))(jnp.asarray(x))
        monkeypatch.setattr(cuda_norm, "on_cpu", lambda t: False)
        monkeypatch.setattr(cuda_norm, "instance_norm_stats", cuda_norm.instance_norm_stats_plain)
        xt = nchw(x).requires_grad_(True)
        (cuda_norm.instance_norm_from_stats(xt, relu=True) * nchw(cot)).sum().backward()
        got, want = [nhwc(xt.grad)], [np.asarray(ref)]
    else:
        c = 32
        params = jax.tree_util.tree_map(
            np.asarray, JL.ista_block_init(jax.random.PRNGKey(4), base_channels=c))
        params["Lambda"] = np.full_like(params["Lambda"], 0.02)
        x1 = rng.standard_normal((1, 8, 16, c)).astype(np.float32)
        z = (0.1 * rng.standard_normal((1, 8, 16, 2 * c))).astype(np.float32)
        assert JPI.supported(x1.shape, z.shape)
        cot = rng.standard_normal(z.shape).astype(np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, params)
        ref = jax.grad(lambda p, a, b: jnp.sum(JPI.fused_ista_v2(p, a, b, 2) * cot),
                       argnums=(0, 1, 2))(jp, jnp.asarray(x1), jnp.asarray(z))
        monkeypatch.setattr(cuda_ista2, "on_cpu", lambda t: False)
        monkeypatch.setattr(cuda_ista2, "_fused_ista_v2_kernel", cuda_ista2.ista_loop_plain)
        w = [torch.tensor(np.transpose(params[k]["w"], (3, 2, 0, 1))) if i % 2 == 0
             else torch.tensor(params[k]["b"]) for i, k in enumerate(("D", "D", "P", "P"))]
        w.append(torch.tensor(params["Lambda"].reshape(-1)))
        ts = [t.clone().requires_grad_(True) for t in (*w, nchw(x1), nchw(z))]
        (cuda_ista2.fused_ista_v2(tuple(ts[:5]), ts[5], ts[6], 2) * nchw(cot)).sum().backward()
        jg, (jx1, jz) = ref[0], ref[1:]
        got = [t.grad.numpy() for t in ts[:5]] + [nhwc(ts[5].grad), nhwc(ts[6].grad)]
        want = [np.transpose(np.asarray(jg["D"]["w"]), (3, 2, 0, 1)), np.asarray(jg["D"]["b"]),
                np.transpose(np.asarray(jg["P"]["w"]), (3, 2, 0, 1)), np.asarray(jg["P"]["b"]),
                np.asarray(jg["Lambda"]).reshape(-1), np.asarray(jx1), np.asarray(jz)]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * float(np.abs(b).max()))


def test_weight_cache_sees_the_optimizer_step():
    """The packed-weight cache keys on the weight's version counter. The
    port's Adam (foreach) bumps it, so the next call repacks; the fused
    implementation does not, which is why ``make_optimizer`` names foreach."""
    conv_tile.clear_cache()
    model = torch.nn.Conv2d(64, 64, 3)
    opt = TS.make_optimizer(model, 1e-2)
    w = model.weight
    first = conv_tile.packed_weights(w, torch.float32)
    assert conv_tile.packed_weights(w, torch.float32) is first
    model.weight.grad = torch.ones_like(w)
    model.bias.grad = torch.ones_like(model.bias)
    opt.step()
    again = conv_tile.packed_weights(w, torch.float32)
    assert again is not first
    assert torch.equal(again, conv_tile.pack_weights(w.detach()))
    fused = torch.optim.Adam([w], lr=1e-2, fused=True)
    version = w._version
    fused.step()
    assert w._version == version
    conv_tile.clear_cache()


def test_half_flow_matches_the_composed_route():
    """The sparse-code warp's half-resolution flow: the port resizes the
    unpadded full-resolution flow (``interpolate_scale``); the JAX training
    path composes the same linear maps from the 1/8 flow
    (``_half_flow_composed``). Equal in value and in gradient, to 1e-5 of
    their largest magnitude."""
    from cista_flow_torch.ops.pad import ImagePadder
    from cista_flow_torch.ops.resize import interpolate_scale, upflow
    jcfg = JConfig(image_dim=(H, W))
    rng = np.random.default_rng(8)
    f8 = (3.0 * rng.standard_normal((2, 8, 8, 2))).astype(np.float32)
    cot = rng.standard_normal((2, H // 2, W // 2, 2)).astype(np.float32)
    jval, vjp = jax.vjp(lambda f: JCOMP._half_flow_composed(f, jcfg), jnp.asarray(f8))
    (jgrad,) = vjp(jnp.asarray(cot))
    t8 = nchw(f8).requires_grad_(True)
    half = interpolate_scale(ImagePadder((H, W), 32).unpad(upflow(t8, 8)), 0.5,
                             align_corners=True)
    (half * nchw(cot)).sum().backward()
    np.testing.assert_allclose(nhwc(half), jval, rtol=0,
                               atol=1e-5 * float(np.abs(jval).max()))
    np.testing.assert_allclose(nhwc(t8.grad), jgrad, rtol=0,
                               atol=1e-5 * float(np.abs(jgrad).max()))


# ----------------------------- schedule and optimizer -----------------------

@pytest.mark.parametrize("flow_epoch,rec_epoch", [(1, 1), (2, 3), (0, 4)])
def test_phase_for_epoch_matches_jax(flow_epoch, rec_epoch):
    """The schedule of every mode the JAX trainer trains (the three flow
    composites' three phases; cista-lstc and cista-gtflow on the GT flow)
    equals ``train.phase_for_epoch`` of the JAX package; an unknown mode is
    refused."""
    sys.path.insert(0, str(REPO))
    import train as jtrain
    from cista_flow_torch import train as ttrain
    for mode in ("cista-eiflow", "cista-eraft", "cista-idnet", "cista-lstc", "cista-gtflow"):
        kw = dict(model_mode=mode, flow_epoch=flow_epoch, rec_epoch=rec_epoch)
        for epoch in range(13):
            assert ttrain.phase_for_epoch(Config(**kw), epoch) == \
                jtrain.phase_for_epoch(JConfig(**kw), epoch)
    with pytest.raises(ValueError, match="unknown model_mode"):
        ttrain.phase_for_epoch(Config(model_mode="cista-raft"), 0)


class _Two(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.cista_net = torch.nn.Linear(3, 2)
        self.event_flownet = torch.nn.Linear(2, 4)


def test_optimizer_matches_adam_per_subtree():
    """torch's Adam under the port's freeze against the JAX package's
    per-subtree Adam with its frozen-subtree restore, over a schedule that
    freezes, unfreezes and trains both, on synthetic gradients (the flow
    net's bias left out of the 'loss' on some steps: a zero gradient that
    still advances its moments, as JAX's). Step counts equal, moments and
    parameters to 1e-6."""
    model = _Two()
    tree = lambda m: {"w": m.weight.detach().numpy().copy(),  # noqa: E731
                      "b": m.bias.detach().numpy().copy()}
    params = {"cista": tree(model.cista_net), "flow": tree(model.event_flownet)}
    opt = TS.make_optimizer(model, 1e-2)
    jopt = JP.make_optimizer(1e-2)
    jstate = jopt.init(params)
    rng = np.random.default_rng(9)
    for i, fix in enumerate(["rec", "rec", "flow", None, "flow", "rec", None]):
        grads = {k: {n: rng.standard_normal(a.shape).astype(np.float32) for n, a in v.items()}
                 for k, v in params.items()}
        if i % 2:
            grads["flow"]["b"][:] = 0.0
        frozen = {"rec": "cista", "flow": "flow"}.get(fix)
        for k in grads:
            if k == frozen:
                grads[k] = {n: np.zeros_like(a) for n, a in grads[k].items()}
        updates, new_state = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, params)
        if frozen is not None:
            updates = JP.train_step._select_frozen(
                frozen, updates, jax.tree_util.tree_map(jnp.zeros_like, updates))
            new_state = JP.train_step._select_frozen(frozen, new_state, jstate)
        params = np_tree(optax.apply_updates(params, updates))
        jstate = new_state

        TS.freeze(model, fix)
        opt.zero_grad(set_to_none=True)
        for sub, key in (("cista_net", "cista"), ("event_flownet", "flow")):
            m = getattr(model, sub)
            if key != frozen:
                m.weight.grad = torch.from_numpy(grads[key]["w"])
                if not (key == "flow" and i % 2):
                    m.bias.grad = torch.from_numpy(grads[key]["b"])
        TS.optimizer_step(model, opt)
        for sub, key in (("cista_net", "cista"), ("event_flownet", "flow")):
            m = getattr(model, sub)
            inner = jstate.inner_state
            for n, p in (("w", m.weight), ("b", m.bias)):
                np.testing.assert_allclose(p.detach().numpy(), params[key][n], rtol=0, atol=1e-6)
                st = opt.state.get(p, {})
                assert int(st.get("step", 0)) == int(inner.count[key])
                if st:
                    np.testing.assert_allclose(st["exp_avg"].numpy(), inner.mu[key][n],
                                               rtol=1e-6, atol=1e-7)
                    # JAX takes 1 - b2 in f32 (1 - 0.999f = 9.99987e-4, 1.3e-5
                    # under 0.001) and its bias correction 1 - b2^t as well,
                    # so its second moment is 1.3e-5 smaller and its update
                    # the same
                    np.testing.assert_allclose(st["exp_avg_sq"].numpy(), inner.nu[key][n],
                                               rtol=2e-5, atol=1e-9)


# ----------------------------- the trainer ----------------------------------

@pytest.fixture
def one_torch_thread():
    """One intra-op thread for a tiny CPU run: the test runner's workers
    share the machine's cores, and torch's thread pools then wait on one
    another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["cista-eraft", "cista-idnet", "cista-gtflow", "cista-lstc"])
def test_train_cli_trains_every_mode(tmp_path, capsys, mode, one_torch_thread):
    """``python -m cista_flow_torch.train --device cpu --model_mode M`` for
    every mode but cista-eiflow (the test below): three epochs (phase 1,
    phase 2, phase 3's flow half for the flow composites; the GT-flow
    reconstructor for the others) with ``--remat``, ``--save_every_steps``
    and ``--orbax_ckpt``; the reference-layout checkpoints of epochs 1 and
    2, each loaded strictly by the port and through the JAX importer, whose
    export gives back its key set; the full-state saves of both kinds."""
    from cista_flow_torch import ckpt, train
    data = tmp_path / "data"
    write_train_dataset(str(data), 2, 4, H, W, seed=1)
    assert train.main(["--device", "cpu", "--model_mode", mode, "--path_to_train_data",
                       str(data), "--path_to_model", str(tmp_path / "models"), "--image_dim",
                       str(H), str(W), "-c", "16", "-d", "2", "--flow_iters", "1", "-s", "3",
                       "--batch_size", "2", "--flow_epoch", "1", "--rec_epoch", "1",
                       "--epochs", "3", "--remat", "--save_every_steps", "2",
                       "--orbax_ckpt"]) == 0
    assert capsys.readouterr().out.count("Train Epoch:") == 3
    name = f"{mode}_b5_d2_c16"
    root = tmp_path / "models" / name
    assert sorted(f for f in os.listdir(root) if f.endswith(".pth.tar")) == \
        [f"{name}_{e}.pth.tar" for e in (1, 2)]
    assert ckpt.steps(str(root / "full_state")) == [1, 2]
    assert ckpt.steps(str(root / "full_state_steps")) == [2]
    for e in (1, 2):
        path = str(root / f"{name}_{e}.pth.tar")
        model = composite.init(Config(**{**SMALL, "model_mode": mode}), device="cpu")
        model.load_reference_state(weights.load_state_dict(path))
        jp, js = ti.composite_params(ti.load_state_dict(path), mode)
        assert set(torch.load(path, map_location="cpu", weights_only=True)["state_dict"]) \
            == set(ti.composite_export(jp, js, mode, depth=2))


def test_train_cli_runs_every_phase_and_writes_reference_checkpoints(tmp_path, capsys,
                                                                     one_torch_thread):
    """``python -m cista_flow_torch.train --device cpu`` (its ``main``, in
    this process) on a tiny simulated set over every phase (flow_epoch 1,
    rec_epoch 1, epochs 5: phase 1, phase 2, then both halves of phase 3)
    writes the checkpoints of the reference's schedule (epochs 1, 2, 4);
    each loads strictly into the port's composite and through the JAX
    importer, with the key set of the JAX package's export."""
    from cista_flow_torch import train
    data = tmp_path / "data"
    write_train_dataset(str(data), 2, 4, H, W, seed=1)
    assert train.main(["--device", "cpu", "--model_mode", "cista-eiflow",
                       "--path_to_train_data", str(data),
                       "--path_to_model", str(tmp_path / "models"), "--image_dim", str(H), str(W),
                       "-c", "16", "-d", "2", "--flow_iters", "2", "-s", "3", "--batch_size", "2",
                       "--flow_epoch", "1", "--rec_epoch", "1", "--epochs", "5"]) == 0
    assert capsys.readouterr().out.count("Train Epoch:") == 5
    name = "cista-eiflow_b5_d2_c16"
    saved = sorted(os.listdir(tmp_path / "models" / name))
    assert saved == [f"{name}_{e}.pth.tar" for e in (1, 2, 4)]
    params, mstate = JCOMP.init(jax.random.PRNGKey(0), JConfig(**SMALL))
    export = set(ti.composite_export(params, mstate, "cista-eiflow", depth=2))
    for fname in saved:
        path = str(tmp_path / "models" / name / fname)
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        assert set(ckpt) == {"epoch", "state_dict"}
        assert set(ckpt["state_dict"]) == export
        model = composite.init(Config(**SMALL), device="cpu")
        model.load_reference_state(weights.load_state_dict(path))
        jp, js = ti.composite_params(ti.load_state_dict(path), "cista-eiflow")
        assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(params)
        assert jax.tree_util.tree_structure(js) == jax.tree_util.tree_structure(mstate)
