"""Group norm in the port's encoders and the flow resizes, on the CPU,
against the JAX package.

- ``ops.conv.group_norm`` against ``cista_flow_tpu.ops.conv.group_norm``:
  f32 within 1e-5 of the output's largest magnitude; bf16 (both compute in
  f32 and round once at the end) within one bf16 step, 2^-7 relative.
- ``ResidualBlock`` (stride 1 and 2), ``BottleneckBlock`` (stride 1 and 2)
  and ``BasicEncoder`` with ``norm_fn="group"`` against the JAX functions
  (jitted), their weights carried over by ``weights.*_from_jax`` and loaded
  with ``strict=True``, f32 within 1e-5 of the output's largest magnitude;
  the ``BasicEncoder`` also in bf16 (parameters and input cast, as the
  port's bf16 paths cast them) within a relative L2 of 3e-2, the bound
  SmallEncoder's seven instance norms set (``SmallEncoder`` with "group":
  tests/test_torch_surface.py).
- The group counts per norm site, read from the JAX trees: stems 8, a
  residual block's three norms its output width // 8, a bottleneck block's
  four norms its ``conv3`` width // 8 (the mid-width ones too).
- The reference's key layout (``norm3`` / ``norm4`` also as
  ``downsample.1``) loads with ``strict=True``.
- Under a row band, group norm refuses, naming the encoder.
- ``ops.resize.resize_flow`` and ``downflow`` at factors 2, 4, 8 against
  JAX in f32 (1e-5 of the output's largest magnitude: JAX resizes by
  constant-matrix products, whose sums round in another order) and bf16
  (one bf16 step), and ``upflow`` through
  ``resize_flow`` bit for bit the plain resize times the factor.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cista_flow_tpu.nn import encoders as JENC
from cista_flow_tpu.ops import conv as JCONV
from cista_flow_tpu.ops import resize as JRESIZE
from cista_flow_torch import weights
from cista_flow_torch.nn import encoders
from cista_flow_torch.ops import bands, resize
from cista_flow_torch.ops.conv import group_norm
from test_torch_surface import close, module_from, nhwc, random_tree, randn

BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(y):
    return np.moveaxis(np.asarray(jnp.asarray(y, jnp.float32)), -1, 1)


# ------------------------------- group_norm -----------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,groups", [(64, 8), (24, 12), (32, 4)])
def test_group_norm_matches_jax(dtype, c, groups):
    rng = np.random.default_rng(c)
    x = randn(rng, 2, c, 9, 13, scale=3.0) + 1.5
    scale = (0.5 + rng.random(c)).astype(np.float32)
    bias = randn(rng, c, scale=0.2)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = JCONV.group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                           nhwc(x).astype(jdt), groups)
    out = group_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                     torch.from_numpy(bias), groups)
    assert out.dtype == tdt and ref.dtype == jdt
    if dtype == "float32":
        close(out, nchw(ref), of_scale=True)
    else:
        np.testing.assert_allclose(out.float().numpy(), nchw(ref), rtol=BF16_STEP, atol=1e-6)


# ------------------------------ encoder modules -------------------------------

def check_block(make, jinit, japply, to_sd, cin, cout, stride, hw=(12, 16), seed=0):
    rng = np.random.default_rng(seed)
    p, s = random_tree(jinit, cin, cout, "group", stride, seed=seed)
    x = randn(rng, 2, cin, *hw)
    ref, _ = jax.jit(japply, static_argnums=(3, 4, 5))(p, s, nhwc(x), "group", stride, False)
    block = module_from(make(cin, cout, "group", stride), to_sd(p, s, "group"))
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    close(out, nchw(ref), of_scale=True)


@pytest.mark.parametrize("cin,cout,stride", [(64, 64, 1), (64, 96, 2)])
def test_residual_block_group_matches_jax(cin, cout, stride):
    check_block(encoders.ResidualBlock, JENC.residual_block_init, JENC.residual_block,
                weights.residual_block_from_jax, cin, cout, stride)


@pytest.mark.parametrize("cin,cout,stride", [(32, 32, 1), (32, 64, 2)])
def test_bottleneck_block_group_matches_jax(cin, cout, stride):
    check_block(encoders.BottleneckBlock, JENC.bottleneck_block_init, JENC.bottleneck_block,
                weights.bottleneck_block_from_jax, cin, cout, stride, seed=1)


@pytest.fixture(scope="module")
def basic_group():
    return random_tree(JENC.basic_encoder_init, 3, 64, "group", seed=5)


def test_basic_encoder_group_matches_jax(basic_group):
    p, s = basic_group
    rng = np.random.default_rng(5)
    x = randn(rng, 2, 3, 48, 64)
    run = jax.jit(JENC.basic_encoder, static_argnums=(3, 4, 5))
    ref, _ = run(p, s, nhwc(x), "group", 8, False)
    enc = module_from(encoders.BasicEncoder(3, 64, "group"),
                      weights.basic_encoder_from_jax(p, s, "group"))
    with torch.no_grad():
        out = enc(torch.from_numpy(x))
    assert out.shape == (2, 64, 6, 8)
    close(out, nchw(ref), of_scale=True)
    # bf16: the parameters and the input cast, against the f32 output
    enc16 = module_from(encoders.BasicEncoder(3, 64, "group"),
                        weights.basic_encoder_from_jax(p, s, "group")).to(torch.bfloat16)
    with torch.no_grad():
        out16 = enc16(torch.from_numpy(x).to(torch.bfloat16)).float()
    rel = float(torch.linalg.vector_norm(out16 - out) / torch.linalg.vector_norm(out))
    assert rel < 3e-2, rel


def _groups(module):
    """Each GroupNorm once (``downsample.1`` is ``norm3`` / ``norm4``)."""
    return {name: (m.num_groups, m.num_channels) for name, m in module.named_modules()
            if isinstance(m, torch.nn.GroupNorm)}


def test_group_counts_per_site(basic_group):
    """Every GroupNorm's group count equals the one the JAX functions use:
    8 at the stems, a residual block's ``conv1`` width // 8, a bottleneck
    block's ``conv3`` width // 8 on all four norms."""
    p, _ = basic_group
    want = {"norm1": (8, 64)}
    for i in (1, 2, 3):
        for j, suf in ((0, "a"), (1, "b")):
            w = p[f"layer{i}{suf}"]["conv1"]["w"].shape[-1]
            for k in ("norm1", "norm2") + (("norm3",) if j == 0 and i > 1 else ()):
                want[f"layer{i}.{j}.{k}"] = (w // 8, w)
    assert _groups(encoders.BasicEncoder(3, 64, "group")) == want
    assert {g for g, _ in want.values()} == {8, 12, 16}

    q, _ = random_tree(JENC.small_encoder_init, 3, 128, "group")
    want = {"norm1": (8, 32)}
    for i in (1, 2, 3):
        for j, suf in ((0, "a"), (1, "b")):
            bp = q[f"layer{i}{suf}"]
            g = bp["conv3"]["w"].shape[-1] // 8
            for k in ("norm1", "norm2", "norm3", "norm4"):
                if k in bp:
                    want[f"layer{i}.{j}.{k}"] = (g, bp[k]["scale"].shape[0])
    assert _groups(encoders.SmallEncoder(3, 128, "group")) == want
    assert want["layer1.0.norm1"] == (4, 8) and want["layer3.0.norm1"] == (12, 24)


def test_reference_keys_load_strict():
    """The reference's ``state_dict`` keys of a group-norm residual block
    at stride 2 and a bottleneck block at stride 2 (the downsample's norm
    under both names), loaded with ``strict=True``."""
    res = {f"{m}.{t}" for m in ("conv1", "conv2", "norm1", "norm2", "norm3", "downsample.0",
                                "downsample.1") for t in ("weight", "bias")}
    bott = {f"{m}.{t}" for m in ("conv1", "conv2", "conv3", "norm1", "norm2", "norm3", "norm4",
                                 "downsample.0", "downsample.1") for t in ("weight", "bias")}
    for block, keys in ((encoders.ResidualBlock(64, 96, "group", 2), res),
                        (encoders.BottleneckBlock(32, 64, "group", 2), bott)):
        assert set(block.state_dict()) == keys
        same = {k: torch.randn_like(v) for k, v in block.state_dict().items()
                if not k.startswith("downsample.1")}
        norm = "norm4" if "norm4.weight" in keys else "norm3"
        for t in ("weight", "bias"):
            same[f"downsample.1.{t}"] = same[f"{norm}.{t}"]
        block.load_state_dict(same, strict=True)
        assert block.downsample[1] is getattr(block, norm)
        assert torch.equal(getattr(block, norm).weight, same[f"{norm}.weight"])


def test_group_norm_refuses_a_row_band():
    """No model path runs a group-norm encoder on row bands: its
    statistics span the whole frame, so a band's own would be wrong."""
    band = types.SimpleNamespace(halo=lambda x, top, bottom: (None, None))
    x = torch.randn(1, 3, 32, 32)
    for enc in (encoders.BasicEncoder(3, 64, "group"), encoders.SmallEncoder(3, 64, "group")):
        with bands.rows(band), pytest.raises(ValueError, match=type(enc).__name__):
            enc(x)
    block = encoders.ResidualBlock(64, 64, "group")
    with bands.rows(band), pytest.raises(ValueError, match="ResidualBlock: group norm"):
        block(torch.randn(1, 64, 8, 8))


# ------------------------------- flow resizes ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_flow_and_downflow_match_jax(dtype, factor):
    rng = np.random.default_rng(factor)
    flow = randn(rng, 2, 2, 64, 96, scale=5.0)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jf, tf = nhwc(flow).astype(jdt), torch.from_numpy(flow).to(tdt)
    small = flow[:, :, :64 // factor, :96 // factor]
    cases = [(resize.downflow(tf, factor), JRESIZE.downflow(jf, factor)),
             (resize.upflow(torch.from_numpy(small).to(tdt), factor),
              JRESIZE.upflow(nhwc(small).astype(jdt), factor)),
             (resize.resize_flow(tf, (64 // factor + 3, 96 // factor + 5)),
              JRESIZE.resize_flow(jf, (64 // factor + 3, 96 // factor + 5))),
             (resize.resize_flow(tf, (40, 50), scale=1.0 / 3),
              JRESIZE.resize_flow(jf, (40, 50), scale=1.0 / 3))]
    for ours, ref in cases:
        assert ours.dtype == tdt and tuple(ours.shape[2:]) == tuple(ref.shape[1:3])
        if dtype == "float32":
            close(ours, nchw(ref), of_scale=True)
        else:
            np.testing.assert_allclose(ours.float().numpy(), nchw(ref), rtol=BF16_STEP,
                                       atol=1e-6)
    assert resize.downflow(tf, factor).shape[2:] == (64 // factor, 96 // factor)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upflow_through_resize_flow_is_bit_for_bit(dtype):
    """``upflow`` now goes through ``resize_flow``: the same bits as the
    align_corners=True resize (in f32, cast back) times the factor."""
    flow = torch.randn(2, 2, 12, 16).to(dtype)
    for factor in (2, 4, 8, 16):
        plain = F.interpolate(flow.float(), size=(12 * factor, 16 * factor), mode="bilinear",
                              align_corners=True).to(dtype) * float(factor)
        assert torch.equal(resize.upflow(flow, factor), plain)
