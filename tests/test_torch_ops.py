"""Parity of the PyTorch port's ops (cista_flow_torch.ops) with the JAX
package on the CPU, and the guards around the CUDA kernels.

Inputs come from a numpy seed and feed both packages; layouts convert at
the boundary (JAX NHWC/HWIO, the port NCHW/OIHW). On the CPU each kernel
wrapper runs its plain PyTorch version, which is what is held here against
the JAX function; the kernels themselves are held against the same plain
versions on the card (chip_smoke.py, and the ``cuda`` test below).

Tolerance: 1e-5 abs for single f32 ops on O(1) values (the two packages
sum in different orders), 1e-4 where an op sums over a few hundred terms.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.ops import conv as JC
from cista_flow_tpu.ops import corr as JCORR
from cista_flow_tpu.ops import pad as JPAD
from cista_flow_tpu.ops import pallas_aug as JAUG
from cista_flow_tpu.ops import pallas_conv as JPCONV
from cista_flow_tpu.ops import pallas_ista as JISTA1
from cista_flow_tpu.ops import pallas_ista2 as JISTA
from cista_flow_tpu.ops import pool as JPOOL
from cista_flow_tpu.ops import resize as JRS
from cista_flow_tpu.ops import upsample as JUP
from cista_flow_tpu.ops import warp as JW
from cista_flow_torch.ops import conv as TC
from cista_flow_torch.ops import corr as TCORR
from cista_flow_torch.ops import (cuda_aug, cuda_conv, cuda_corr, cuda_ista, cuda_ista2,
                                  cuda_norm)
from cista_flow_torch.ops import pool as TPOOL
from cista_flow_torch.ops import resize as TRS
from cista_flow_torch.ops import upsample as TUP
from cista_flow_torch.ops import warp as TW
from cista_flow_torch.ops.pad import ImagePadder

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-5


def nchw(a):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    """NCHW torch -> NHWC numpy."""
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def oihw(w):
    """HWIO numpy -> OIHW torch."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


@pytest.mark.parametrize("dim", [(180, 240), (37, 50), (64, 64)])
def test_image_padder(dim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *dim, 3)).astype(np.float32)
    jp, tp = JPAD.ImagePadder(dim, 32), ImagePadder(dim, 32)
    assert tp.padded_dim == jp.padded_dim
    close(nhwc(tp.pad(nchw(x))), jp.pad(jnp.asarray(x)), 0)
    padded = tp.pad(nchw(x))
    close(nhwc(tp.unpad(padded)), x, 0)


@pytest.mark.parametrize("mode,stride,k", [("reflect", 1, 3), ("reflect", 2, 3),
                                           ("zeros", 1, 3), ("zeros", 2, 7),
                                           ("zeros", 1, 1)])
def test_conv2d(mode, stride, k):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, 17, 6)).astype(np.float32)
    w = (rng.standard_normal((k, k, 6, 5)) / (3 * k)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    pad = k // 2
    ref = JC.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, pad, mode)
    out = TC.conv2d(nchw(x), oihw(w), torch.from_numpy(b), stride, pad, mode)
    close(nhwc(out), ref)


def test_batch_norm_eval():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    p = {"scale": rng.random(4).astype(np.float32) + 0.5,
         "bias": rng.standard_normal(4).astype(np.float32)}
    s = {"mean": rng.standard_normal(4).astype(np.float32),
         "var": rng.random(4).astype(np.float32) + 0.1}
    ref, _ = JC.batch_norm({k: jnp.asarray(v) for k, v in p.items()},
                           {k: jnp.asarray(v) for k, v in s.items()},
                           jnp.asarray(x), train=False)
    bn = torch.nn.BatchNorm2d(4).eval()
    bn.weight.data[:] = torch.from_numpy(p["scale"])
    bn.bias.data[:] = torch.from_numpy(p["bias"])
    bn.running_mean[:] = torch.from_numpy(s["mean"])
    bn.running_var[:] = torch.from_numpy(s["var"])
    close(nhwc(TC.batch_norm(nchw(x), bn).detach()), ref)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 16, 8), (1, 24, 32, 3)])
def test_instance_norm_k4_plain(shape, relu):
    """K4's plain version (the port's CPU path) vs conv.instance_norm f32."""
    rng = np.random.default_rng(3)
    x = (2.0 * rng.standard_normal(shape) + 0.7).astype(np.float32)
    ref = JC.instance_norm(jnp.asarray(x), relu=relu)
    close(nhwc(TC.instance_norm(nchw(x), relu=relu)), ref)
    close(nhwc(cuda_norm.instance_norm_fused(nchw(x), relu=relu)), ref)


def test_instance_norm_stats_k4s_plain():
    """K4s's plain version vs the Pallas stats kernel in interpret mode (a
    one-pass variance: 1e-5 on O(1) statistics)."""
    from cista_flow_tpu.ops import pallas_norm as JPN
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 8, 16, 64)) + 0.3).astype(np.float32)
    jm, ji = JPN.instance_norm_stats(jnp.asarray(x), 1e-5, interpret=True)
    tm, ti = cuda_norm.instance_norm_stats(nchw(x))
    close(tm.numpy(), jm)
    close(ti.numpy(), ji)


@pytest.mark.parametrize("out_hw,ac,pad", [((24, 32), False, 1), ((24, 32), True, 0),
                                           ((6, 9), True, 0), ((13, 16), False, 0)])
def test_resize_bilinear(out_hw, ac, pad):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, 16, 3)).astype(np.float32)
    ref = JRS.resize_bilinear(jnp.asarray(x), out_hw, align_corners=ac, reflect_pad=pad)
    out = TRS.resize_bilinear(nchw(x), out_hw, align_corners=ac, reflect_pad=pad)
    close(nhwc(out), ref)


def test_upflow_and_interpolate_scale():
    rng = np.random.default_rng(6)
    f = (3 * rng.standard_normal((2, 6, 8, 2))).astype(np.float32)
    close(nhwc(TRS.upflow(nchw(f), 8)), JRS.upflow(jnp.asarray(f), 8), 1e-4)
    g = (3 * rng.standard_normal((2, 45, 60, 2))).astype(np.float32)
    close(nhwc(TRS.interpolate_scale(nchw(g), 0.5, True)),
          JRS.interpolate_scale(jnp.asarray(g), 0.5, True))


@pytest.mark.parametrize("c,hw", [(1, (18, 24)), (128, (9, 12))])
@pytest.mark.parametrize("mode", ["forward", "backward"])
def test_frame_warp_k2_plain(c, hw, mode):
    """K2's plain version: the reflection warp with the reference's
    2*(x/W - 0.5) normalization, C=1 (frame) and C=128 (sparse code)."""
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, *hw, c)).astype(np.float32)
    flow = (4 * rng.standard_normal((2, *hw, 2))).astype(np.float32)
    flow[0, 0, 0] = (40.0, -35.0)           # far outside: several reflections
    ref = JW.frame_warp(jnp.asarray(img), jnp.asarray(flow), mode=mode)
    out = TW.frame_warp(nchw(img), nchw(flow), mode=mode)
    close(nhwc(out), ref)


def test_build_aug_matches_xla_staging():
    """The TPU kernel's own contract: K2's staging rows (pallas_aug)."""
    rng = np.random.default_rng(8)
    flat = rng.standard_normal((6 * 7, 5)).astype(np.float32)
    ref = JAUG.build_aug_xla(jnp.asarray(flat), 7)
    close(cuda_aug.build_aug(torch.from_numpy(flat), 7).numpy(), ref, 0)


def test_bilinear_sampler_zeros():
    rng = np.random.default_rng(9)
    img = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    coords = (rng.random((2, 4, 5, 2)) * 14 - 3).astype(np.float32)
    ref = JW.bilinear_sampler(jnp.asarray(img), jnp.asarray(coords))
    close(nhwc(TW.bilinear_sampler(nchw(img), nchw(coords))), ref)


def test_coords_grid():
    ref = JCORR.coords_grid(2, 3, 5)
    close(nhwc(TCORR.coords_grid(2, 3, 5)), ref, 0)


def _pyramids(rng, b=2, h=8, w=16, d=32):
    f1 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, d)).astype(np.float32)
    jp = JCORR.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    tp = TCORR.build_corr_pyramid(nchw(f1), nchw(f2), 4)
    return jp, tp


def test_corr_pyramid():
    jp, tp = _pyramids(np.random.default_rng(10))
    for jl, tl in zip(jp.levels, tp.levels):
        close(tl.numpy(), np.asarray(jl)[..., 0], 1e-4)


def test_lookup_corr_k1_plain():
    """K1's plain lookup vs corr.lookup_corr: level-major, x-offset-major
    channels, zeros outside, coordinates far outside included."""
    rng = np.random.default_rng(11)
    jp, tp = _pyramids(rng)
    coords = np.asarray(JCORR.coords_grid(2, 8, 16)) + 3 * rng.standard_normal(
        (2, 8, 16, 2)).astype(np.float32)
    coords[0, 0, :3] = ((-50.0, 7.5), (900.0, -2.0), (-4.5, 3.0))
    ref = JCORR.lookup_corr(jp, jnp.asarray(coords), 4)
    out = cuda_corr.lookup(tp, nchw(coords))
    assert out.shape == (2, 324, 8, 16)
    close(nhwc(out), ref, 1e-4)


def test_lookup_corr_k1_projected():
    """K1 with ``proj``: relu(convc1(lookup)) in one call."""
    rng = np.random.default_rng(12)
    jp, tp = _pyramids(rng)
    coords = np.asarray(JCORR.coords_grid(2, 8, 16)) + 2 * rng.standard_normal(
        (2, 8, 16, 2)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 324, 256)) / 18).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    look = JCORR.lookup_corr(jp, jnp.asarray(coords), 4)
    ref = jnp.maximum(JC.conv2d(look, jnp.asarray(w), jnp.asarray(b)), 0.0)
    out = cuda_corr.lookup(tp, nchw(coords), oihw(w), torch.from_numpy(b))
    assert out.shape == (2, 256, 8, 16)
    close(nhwc(out), ref, 1e-4)


@pytest.mark.parametrize("depth", [1, 5])
def test_fused_ista_dg_k3_plain(depth):
    """K3's plain version vs pallas_ista2._xla_loop_dg (the XLA loop)."""
    rng = np.random.default_rng(13)
    c = 16
    x1 = rng.standard_normal((2, 10, 12, c)).astype(np.float32)
    z = (0.1 * rng.standard_normal((2, 10, 12, 2 * c))).astype(np.float32)

    def conv(cin, cout):
        return {"w": (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32),
                "b": (0.05 * rng.standard_normal(cout)).astype(np.float32)}
    ista = {"D": conv(2 * c, c), "P": conv(c, 2 * c),
            "Lambda": (0.01 * rng.random((1, 1, 1, 2 * c))).astype(np.float32)}
    dg = conv(2 * c, c)
    jt = lambda t: {k: (jt(v) if isinstance(v, dict) else jnp.asarray(v)) for k, v in t.items()}
    rz, rrec = JISTA._xla_loop_dg(jt(ista), jt(dg), jnp.asarray(x1), jnp.asarray(z), depth)
    w = (oihw(ista["D"]["w"]), torch.from_numpy(ista["D"]["b"]),
         oihw(ista["P"]["w"]), torch.from_numpy(ista["P"]["b"]),
         torch.from_numpy(ista["Lambda"].reshape(-1)))
    tz, trec = cuda_ista2.fused_ista_dg(w, oihw(dg["w"]), torch.from_numpy(dg["b"]),
                                        nchw(x1), nchw(z), depth)
    close(nhwc(tz), rz, 1e-4)
    close(nhwc(trec), rrec, 1e-4)


def _ista_inputs(rng, c, h, w, b=2):
    x1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    z = (0.1 * rng.standard_normal((b, h, w, 2 * c))).astype(np.float32)

    def conv(cin, cout):
        return {"w": (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32),
                "b": (0.05 * rng.standard_normal(cout)).astype(np.float32)}
    ista = {"D": conv(2 * c, c), "P": conv(c, 2 * c),
            "Lambda": (0.01 * rng.random((1, 1, 1, 2 * c))).astype(np.float32)}
    w = (oihw(ista["D"]["w"]), torch.from_numpy(ista["D"]["b"]),
         oihw(ista["P"]["w"]), torch.from_numpy(ista["P"]["b"]),
         torch.from_numpy(ista["Lambda"].reshape(-1)))
    jista = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()} if isinstance(v, dict)
                 else jnp.asarray(v)) for k, v in ista.items()}
    return x1, z, jista, w


@pytest.mark.parametrize("depth", [1, 3])
def test_fused_ista_v2_k3a_plain(depth):
    """K3a's plain version vs the Pallas v2 kernel in interpret mode, called
    as tests/test_pallas_ista.py calls it (here in f32: 1e-4 over ``depth``
    chained convs)."""
    x1, z, jista, w = _ista_inputs(np.random.default_rng(20), 32, 16, 24)
    assert JISTA.supported(x1.shape, z.shape)
    dw, db, pw, pb, lam = JISTA._prep_weights(jista, jnp.float32)
    ref = JISTA._fused_pallas(jnp.asarray(x1), jnp.asarray(z), dw, db, pw, pb, lam,
                              depth, True)
    z_in = nchw(z)
    out = cuda_ista2.fused_ista_v2(w, nchw(x1), z_in, depth)
    close(nhwc(out), ref, 1e-4)
    close(nhwc(out), JISTA._xla_loop(jista, jnp.asarray(x1), jnp.asarray(z), depth), 1e-4)
    close(nhwc(z_in), z, 0)                      # the input is not modified


def test_fused_ista_k6_plain():
    """K6's plain version vs the Pallas v1 kernel in interpret mode, called
    as tests/test_pallas_ista.py calls it."""
    x1, z, jista, w = _ista_inputs(np.random.default_rng(21), 32, 16, 24)
    ref = JISTA1.fused_ista_pallas(
        jnp.asarray(x1), jnp.asarray(z), jista["D"]["w"], jista["D"]["b"],
        jista["P"]["w"], jista["P"]["b"], jista["Lambda"], depth=3, interpret=True)
    close(nhwc(cuda_ista.fused_ista(w, nchw(x1), nchw(z), 3)), ref, 1e-4)


@pytest.mark.parametrize("mode,relu", [("zeros", False), ("reflect", False), ("zeros", True)])
def test_conv3x3_k5_plain(mode, relu):
    """K5's plain version vs the Pallas im2col kernel in interpret mode, as
    tests/test_pallas_conv.py runs it; 1e-4 on sums of 9*64 products."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((1, 24, 32, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    assert JPCONV.supported(x.shape, w.shape)
    ref = JPCONV.conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mode, relu=relu)
    out = cuda_conv.conv3x3(nchw(x), oihw(w), torch.from_numpy(b), mode, relu)
    close(nhwc(out), ref, 1e-4)
    # conv2d sends this shape to the same function
    close(nhwc(TC.conv2d(nchw(x), oihw(w), torch.from_numpy(b), 1, 1, mode, relu=relu)),
          nhwc(out), 0)
    if not relu:
        close(nhwc(cuda_conv.conv3x3(nchw(x), oihw(w), None, mode)), np.asarray(ref) - b, 1e-4)


@pytest.mark.parametrize("w_shape,stride,padding,routed", [
    ((64, 64, 3, 3), 1, 1, True),        # encoder layer1, CISTA upsamp
    ((128, 128, 3, 3), 1, 1, True),      # encoder layer3
    ((96, 96, 3, 3), 1, 1, False),       # layer2: not a routed width
    ((128, 96, 3, 3), 2, 1, False),      # stride 2, cin != cout
    ((64, 64, 3, 3), 2, 1, False),       # CISTA W0
    ((64, 128, 3, 3), 1, 1, False),      # ISTA D / Dg (inside K3)
    ((128, 64, 3, 3), 1, 1, False),      # ISTA P
    ((64, 64, 3, 3), 1, 0, False),       # no padding
    ((64, 64, 1, 1), 1, 0, False),
    ((128, 128, 1, 5), 1, (0, 2), False),
    ((256, 128, 3, 3), 1, 1, False),     # flow head
])
def test_conv2d_dispatch_rule(w_shape, stride, padding, routed):
    """Where conv2d routes to K5: the JAX dispatch's shape rule
    (cista_flow_tpu/ops/conv.py, pallas_conv.CHANNELS), and the result is
    the plain conv either way."""
    s2 = (stride, stride)
    p2 = padding if isinstance(padding, tuple) else (padding, padding)
    assert TC.routes_to_conv3x3(w_shape, s2, p2) is routed
    assert cuda_conv.CHANNELS == JPCONV.CHANNELS
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((1, w_shape[1], 9, 11)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.standard_normal(w_shape)).astype(np.float32))
    out = TC.conv2d(x, w, None, stride, padding, relu=True)
    ref = torch.relu(torch.nn.functional.conv2d(x, w, None, stride, p2))
    close(out.numpy(), ref.numpy(), 1e-5)


@pytest.mark.parametrize("shape", [(3, 6, 8, 1), (3, 5, 7, 1), (3, 1, 2, 1), (2, 3, 1, 1)])
def test_avg_pool2(shape):
    """Odd trailing rows/cols dropped; a size-1 dim pools to an empty
    level, as the JAX pool returns it."""
    rng = np.random.default_rng(24)
    x = rng.standard_normal(shape).astype(np.float32)
    ref = np.asarray(JPOOL.avg_pool2(jnp.asarray(x)))
    out = TPOOL.avg_pool2(torch.from_numpy(x[..., 0]))
    assert tuple(out.shape) == ref.shape[:3]
    close(out.numpy(), ref[..., 0], 1e-6)


def test_lookup_corr_with_an_empty_level():
    """A 4x8 map: levels 4x8, 2x4, 1x2 and 0x1. The empty level's 81
    channels are zeros, as in the JAX lookup; with and without convc1."""
    rng = np.random.default_rng(25)
    jp, tp = _pyramids(rng, b=1, h=4, w=8)
    assert tuple(tp.levels[3].shape) == (32, 0, 1)
    coords = np.asarray(JCORR.coords_grid(1, 4, 8)) + rng.standard_normal(
        (1, 4, 8, 2)).astype(np.float32)
    ref = JCORR.lookup_corr(jp, jnp.asarray(coords), 4)
    out = cuda_corr.lookup(tp, nchw(coords))
    close(nhwc(out), ref, 1e-4)
    assert float(out[:, 243:].abs().max()) == 0.0
    w = (rng.standard_normal((1, 1, 324, 256)) / 18).astype(np.float32)
    b = (0.1 * rng.standard_normal(256)).astype(np.float32)
    ref = jnp.maximum(JC.conv2d(ref, jnp.asarray(w), jnp.asarray(b)), 0.0)
    close(nhwc(cuda_corr.lookup(tp, nchw(coords), oihw(w), torch.from_numpy(b))), ref, 1e-4)


@pytest.mark.parametrize("factor,flow_scale", [(8, None), (4, 8)])
def test_convex_upsample(factor, flow_scale):
    """Random mask logits (not zeros), so the channel order tap*r*r + window
    and the unfold tap order are both held."""
    rng = np.random.default_rng(26)
    flow = (2 * rng.standard_normal((2, 5, 6, 2))).astype(np.float32)
    mask = (2 * rng.standard_normal((2, 5, 6, 9 * factor * factor))).astype(np.float32)
    ref = JUP.convex_upsample(jnp.asarray(flow), jnp.asarray(mask), factor, flow_scale)
    out = TUP.convex_upsample(nchw(flow), nchw(mask), factor, flow_scale)
    assert out.shape == (2, 2, 5 * factor, 6 * factor)
    close(nhwc(out), ref)


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_from_stats_matches_fused(relu):
    """The K4s route (stats, then the elementwise normalise) against the
    fused K4 route and against the JAX package's statskernel route."""
    from cista_flow_tpu.ops import pallas_norm as JPN
    rng = np.random.default_rng(27)
    x = (rng.standard_normal((2, 8, 16, 64)) + 0.3).astype(np.float32)
    out = cuda_norm.instance_norm_from_stats(nchw(x), relu=relu)
    close(out.numpy(), cuda_norm.instance_norm_fused(nchw(x), relu=relu).numpy(), 1e-6)
    ref = JPN.instance_norm_statskernel(jnp.asarray(x), 1e-5, relu, True)
    close(nhwc(out), ref)
    const = torch.full((1, 4, 6, 6), 0.25)      # a zero voxel's planes: variance 0
    assert float(cuda_norm.instance_norm_from_stats(const).abs().max()) == 0.0
    assert float(cuda_norm.instance_norm_fused(const).abs().max()) == 0.0


# ------------------------- guards: no fallback, no JAX ----------------------

def test_wrappers_raise_off_cpu_rather_than_fall_back():
    """A tensor that is not on the CPU reaches the kernel or raises: here a
    ``meta`` tensor (no kernel for it) must raise, not take the plain path."""
    x = torch.empty((1, 4, 8, 8), device="meta")
    flow = torch.empty((1, 2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_norm.instance_norm_fused(x)
    with pytest.raises(ValueError):
        cuda_norm.instance_norm_stats(x)
    with pytest.raises(ValueError):
        cuda_aug.warp_reflect(x, flow, -1.0)
    coords = torch.empty((1, 2, 8, 8), device="meta")
    pyr = TCORR.CorrPyramid(tuple(torch.empty((64, 8 >> i, 8 >> i), device="meta")
                                  for i in range(4)), 1, 8, 8)
    with pytest.raises(ValueError):
        cuda_corr.lookup(pyr, coords)
    w = tuple(torch.empty(s, device="meta") for s in
              ((16, 32, 3, 3), (16,), (32, 16, 3, 3), (32,), (32,)))
    with pytest.raises(ValueError):
        cuda_ista2.fused_ista_dg(w, w[0], w[1], torch.empty((1, 16, 8, 8), device="meta"),
                                 torch.empty((1, 32, 8, 8), device="meta"), 1)
    for loop in (cuda_ista2.fused_ista_v2, cuda_ista.fused_ista):
        with pytest.raises(ValueError):
            loop(w, torch.empty((1, 16, 8, 8), device="meta"),
                 torch.empty((1, 32, 8, 8), device="meta"), 1)
    with pytest.raises(ValueError):
        cuda_conv.conv3x3(torch.empty((1, 64, 8, 8), device="meta"),
                          torch.empty((64, 64, 3, 3), device="meta"))
    with pytest.raises(ValueError):
        TC.conv2d(torch.empty((1, 64, 8, 8), device="meta"),
                  torch.empty((64, 64, 3, 3), device="meta"), padding=1)


def test_kernel_build_needs_nvcc():
    """The CUDA libraries build only where nvcc is: elsewhere loading one
    raises instead of returning a stand-in."""
    import shutil
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc present: the build itself is exercised by chip_smoke.py")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_norm.KERNEL.lib()
    assert all(k.so_path().name.startswith(k.name) for k in
               (cuda_norm.KERNEL, cuda_aug.KERNEL, cuda_corr.KERNEL, cuda_ista2.KERNEL,
                cuda_conv.KERNEL, cuda_ista.KERNEL))
    # the wrappers that share a library count their own launches
    assert cuda_ista2.KERNEL_V2.kernel is cuda_ista2.KERNEL
    assert cuda_norm.KERNEL_STATS.kernel is cuda_norm.KERNEL


def test_entry_points_default_to_cuda():
    from cista_flow_torch.config import Config
    from cista_flow_torch.device import resolve_device
    from cista_flow_torch.runner import Reconstructor
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Reconstructor(Config(image_dim=(32, 32), depth=1, flow_iters=1))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_statically():
    files = sorted((REPO / "cista_flow_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 21
    assert {"eraft.py", "upsample.py", "pool.py", "cuda_conv.py", "cuda_ista.py"} <= {f.name for f in files}
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cista_flow_tpu"), (f, mod)


def test_port_imports_no_jax_at_runtime():
    """Importing every module of the port (and chip_smoke) pulls in neither
    ``jax`` nor ``cista_flow_tpu``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cista_flow_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(cista_flow_torch.__path__, 'cista_flow_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'cista_flow_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('cista_flow_torch')]), bad)\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 24


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    """With no GPU, or copied alone into an empty directory, chip_smoke.py
    exits non-zero and prints no result."""
    import shutil
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs = [alone] if torch.cuda.is_available() else [REPO / "chip_smoke.py", alone]
    for script in runs:
        r = subprocess.run([sys.executable, str(script)], cwd=script.parent, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """On a CUDA card: each kernel against its plain version at small
    shapes, f32 with TF32 off (the full-size check is chip_smoke.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    x = torch.randn(2, 16, 12, 20, generator=g)
    close(cuda_norm.instance_norm_fused(x.to(dev), relu=True).cpu().numpy(),
          cuda_norm.instance_norm_plain(x, relu=True).numpy())
    img, flow = torch.randn(2, 3, 12, 20, generator=g), 4 * torch.randn(2, 2, 12, 20, generator=g)
    close(cuda_aug.warp_reflect(img.to(dev), flow.to(dev), -1.0).cpu().numpy(),
          cuda_aug.warp_reflect_plain(img, flow, -1.0).numpy())
    pyr = TCORR.build_corr_pyramid(torch.randn(2, 32, 8, 16, generator=g),
                                   torch.randn(2, 32, 8, 16, generator=g))
    coords = TCORR.coords_grid(2, 8, 16) + 3 * torch.randn(2, 2, 8, 16, generator=g)
    wp, bp = torch.randn(256, 324, 1, 1, generator=g) / 18, torch.randn(256, generator=g)
    pyr_d = TCORR.CorrPyramid(tuple(lv.to(dev) for lv in pyr.levels), 2, 8, 16)
    close(cuda_corr.lookup(pyr_d, coords.to(dev), wp.to(dev), bp.to(dev)).cpu().numpy(),
          cuda_corr.lookup_plain(pyr, coords, wp, bp).numpy(), 1e-4)
    c = 16
    w = (torch.randn(c, 2 * c, 3, 3, generator=g) / 12, torch.randn(c, generator=g) / 20,
         torch.randn(2 * c, c, 3, 3, generator=g) / 12, torch.randn(2 * c, generator=g) / 20,
         torch.rand(2 * c, generator=g) / 100)
    x1, z = torch.randn(2, c, 10, 12, generator=g), torch.randn(2, 2 * c, 10, 12, generator=g)
    out = cuda_ista2.fused_ista_dg(tuple(t.to(dev) for t in w), w[0].to(dev), w[1].to(dev),
                                   x1.to(dev), z.to(dev), 2)
    ref = cuda_ista2.fused_ista_dg_plain(w, w[0], w[1], x1, z, 2)
    for o, r in zip(out, ref):
        close(o.cpu().numpy(), r.numpy(), 1e-4)
    wd = tuple(t.to(dev) for t in w)
    for loop in (cuda_ista2.fused_ista_v2, cuda_ista.fused_ista):
        close(loop(wd, x1.to(dev), z.to(dev), 2).cpu().numpy(), ref[0].numpy(), 1e-4)
    xc = torch.randn(2, 64, 13, 21, generator=g)
    wc, bc = torch.randn(64, 64, 3, 3, generator=g) / 24, torch.randn(64, generator=g)
    for mode, relu in (("zeros", False), ("reflect", True)):
        close(cuda_conv.conv3x3(xc.to(dev), wc.to(dev), bc.to(dev), mode, relu).cpu().numpy(),
              cuda_conv.conv3x3_plain(xc, wc, bc, mode, relu).numpy(), 1e-4)
