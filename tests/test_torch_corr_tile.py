"""What the port prepares outside its correlation-lookup kernel K1
(cista_flow_torch/ops/corr_tile.py, csrc/corr.cu), on the CPU: the convc1
weight packed for wgmma and its cache, the kernel's patch formulation of
the window (held against the plain lookup and the JAX package's), and the
rounding points of the bf16 fused projection (held against the JAX Pallas
kernel in interpret mode).

Inputs come from a numpy seed. Layout and product tests use small
integers, so that sums are exact in f32 whatever their order. The patch
window picks the same corners and fractions as ``corr.lookup_corr`` and
blends them in the same order, so on the CPU the two are equal bit for
bit; against the JAX einsum lookup the tolerance is 1e-5 (its selection
matmuls sum the same four corners in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.ops import conv as JC
from cista_flow_tpu.ops import corr as JCORR
from cista_flow_tpu.ops import pallas_corr as JPC
from cista_flow_torch.ops import conv_tile, corr_tile, cuda_corr
from cista_flow_torch.ops import corr as TCORR


def ints(rng, *shape, lo=-3, hi=4):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


@pytest.fixture(autouse=True)
def fresh_cache():
    conv_tile.clear_cache()
    yield
    conv_tile.clear_cache()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_corr_weights_layout_and_zero_pads(dtype):
    """packed[g, o, c] = w[o, 8*g + c] for 8*g + c < 324, and 0 beyond."""
    w = ints(np.random.default_rng(40), 256, 324, 1, 1, lo=-100, hi=100).to(dtype)
    p = corr_tile.pack_corr_weights(w)
    assert p.shape == (42, 256, 8) and p.dtype == dtype and p.is_contiguous()
    g, o, c = np.meshgrid(np.arange(42), np.arange(256), np.arange(8), indexing="ij")
    k = 8 * g + c
    wk = np.concatenate([w.float().numpy().reshape(256, 324), np.zeros((256, 12))], 1)
    np.testing.assert_array_equal(p.float().numpy(), wk[o, k])
    assert float(p[40, :, 4:].float().abs().max()) == 0.0
    assert float(p[41].float().abs().max()) == 0.0


def test_pack_corr_weights_refuses_other_shapes():
    with pytest.raises(ValueError):
        corr_tile.pack_corr_weights(torch.zeros(256, 320, 1, 1))
    with pytest.raises(ValueError):
        corr_tile.pack_corr_weights(torch.zeros(128, 324, 1, 1))


@pytest.mark.parametrize("n", [1, 64, 131])
def test_product_from_packed_equals_conv2d(n):
    """The sum over the 42 groups of the packed weight (the windows padded
    with zeros to 336) is the 1x1 conv, exactly on integers."""
    rng = np.random.default_rng(41 + n)
    win = ints(rng, n, 324)
    w = ints(rng, 256, 324, 1, 1)
    out = corr_tile.project_from_packed(win, corr_tile.pack_corr_weights(w))
    ref = torch.nn.functional.conv2d(win.reshape(1, n, 324).permute(0, 2, 1)[..., None], w)
    torch.testing.assert_close(out, ref[0, :, :, 0].t(), rtol=0, atol=0)


def test_packed_corr_weights_cache_hit_and_in_place_miss():
    """The same tensor gives the same packed object; an in-place update of
    the weight (as a fine-tune step makes) gives a fresh pack."""
    w = ints(np.random.default_rng(42), 256, 324, 1, 1)
    a = corr_tile.packed_corr_weights(w, torch.bfloat16)
    assert corr_tile.packed_corr_weights(w, torch.bfloat16) is a
    assert a.dtype == torch.bfloat16
    f = corr_tile.packed_corr_weights(w, torch.float32)
    assert f is not a and f.dtype == torch.float32
    w.mul_(-2.0)
    b = corr_tile.packed_corr_weights(w, torch.bfloat16)
    assert b is not a
    torch.testing.assert_close(b.float(), corr_tile.pack_corr_weights(w).float(), rtol=0, atol=0)
    torch.testing.assert_close(b.float(), -2.0 * a.float(), rtol=0, atol=0)


def _case(name, seed):
    """(levels as (fmap1, fmap2) numpy NHWC, coords (B, H1, W1, 2)) for one
    of the patch formulation's cases."""
    rng = np.random.default_rng(seed)
    b, h, w = {"ragged n": (3, 6, 7), "empty level": (1, 4, 8)}.get(name, (2, 8, 16))
    f1 = rng.standard_normal((b, h, w, 32)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, 32)).astype(np.float32)
    coords = np.asarray(JCORR.coords_grid(b, h, w)) + 3 * rng.standard_normal(
        (b, h, w, 2)).astype(np.float32)
    if name == "far":
        coords[0, 0, :6] = ((-1e4, 5e3), (3e4, -2e4), (40.5, -4.5), (-9.0, 30.0),
                            (-50.0, 7.5), (900.0, -2.0))
    if name == "round across":
        # c/2^l + d rounds up to an integer for some offsets d: the floor
        # of those offsets moves one on
        below = lambda v: np.nextafter(np.float32(v), np.float32(-1e9))  # noqa: E731
        coords[0, 0, :5] = ((below(4.0), -1e-8), (-1e-8, below(2.0)), (below(16.0), below(8.0)),
                            (-3e-8, -1e-7), (below(32.0), below(0.5)))
    return f1, f2, coords


CASES = ["far", "round across", "empty level", "ragged n"]


@pytest.mark.parametrize("name", CASES)
def test_window_by_patch_matches_plain_lookup(name):
    """The kernel's patch gather (11 rows, each x offset's own floor, a
    row picked one on where an offset's floor moves) against the plain
    gather: bit for bit."""
    f1, f2, coords = _case(name, 43)
    pyr = TCORR.build_corr_pyramid(nchw(f1), nchw(f2), 4)
    c = nchw(coords)
    if name == "round across":
        cx = c[0, 0, 0, :5]
        d = torch.arange(-4.0, 5.0)
        moved = torch.floor(cx[:, None] + d) - (torch.floor(cx)[:, None] + d)
        assert float(moved.max()) == 1.0        # the case really occurs
    if name == "empty level":
        assert pyr.levels[3].numel() == 0
    ref = TCORR.lookup_corr(pyr, c).permute(0, 2, 3, 1).reshape(-1, 324)
    out = corr_tile.window_by_patch(pyr.levels, c)
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("name", CASES)
def test_window_by_patch_matches_jax_lookup(name):
    """The same patch gather against the JAX package's lookup_corr."""
    f1, f2, coords = _case(name, 44)
    jp = JCORR.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    tp = TCORR.build_corr_pyramid(nchw(f1), nchw(f2), 4)
    ref = np.asarray(JCORR.lookup_corr(jp, jnp.asarray(coords), 4)).reshape(-1, 324)
    out = corr_tile.window_by_patch(tp.levels, nchw(coords)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_lookup_plain_rounds_as_the_jax_kernel():
    """In bf16 the plain version rounds the window and the weight to bf16,
    keeps the bias in f32 and rounds the output once: an f32 weight and
    bias give what their bf16 weight and f32 bias give."""
    f1, f2, coords = _case("far", 45)
    pyr = TCORR.build_corr_pyramid(nchw(f1).bfloat16(), nchw(f2).bfloat16(), 4)
    rng = np.random.default_rng(46)
    w = torch.from_numpy((rng.standard_normal((256, 324, 1, 1)) / 18).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(256) + 1e-3).astype(np.float32))
    out = cuda_corr.lookup_plain(pyr, nchw(coords), w, b)
    assert out.dtype == torch.bfloat16
    same = cuda_corr.lookup_plain(pyr, nchw(coords), w.bfloat16(), b)
    torch.testing.assert_close(out, same, rtol=0, atol=0)
    # the projection of the bf16 window, from the packed bf16 weight, in f32
    win = cuda_corr.lookup_plain(pyr, nchw(coords)).float().permute(0, 2, 3, 1).reshape(-1, 324)
    y = corr_tile.project_from_packed(win, corr_tile.pack_corr_weights(w.bfloat16()).float())
    ref = torch.relu(y + b).bfloat16().float()
    got = out.float().permute(0, 2, 3, 1).reshape(-1, 256)
    # summation order alone: one bf16 rounding step of the output
    assert float((got - ref).abs().max()) <= 2 * 2.0 ** -8 * max(float(ref.abs().max()), 1.0)


def test_bf16_fused_projection_matches_pallas_kernel():
    """lookup_plain with convc1 on a bf16 pyramid against the JAX Pallas
    kernel's proj= route in interpret mode. The two round the window to
    bf16 and contract bf16 x bf16 into f32 with an f32 bias, but the Pallas
    kernel blends the window in bf16 arithmetic where the port blends in
    f32 and rounds once; the window values differ by up to a few bf16
    steps, so the outputs agree to 0.05 relative + 0.02 absolute (the
    JAX package's own fused-projection test allows 0.05 and 0.01 against
    its separate conv)."""
    b, h1, w1 = 1, 8, 8
    rng = np.random.default_rng(47)
    f1 = rng.standard_normal((b, h1, w1, 32)).astype(np.float32)
    f2 = rng.standard_normal((b, h1, w1, 32)).astype(np.float32)
    coords = np.asarray(JCORR.coords_grid(b, h1, w1)) + 4 * rng.standard_normal(
        (b, h1, w1, 2)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 324, 256)) / 18).astype(np.float32)
    bias = (0.1 * rng.standard_normal(256)).astype(np.float32)
    jp = JCORR.build_corr_pyramid(jnp.asarray(f1, jnp.bfloat16), jnp.asarray(f2, jnp.bfloat16))
    proj = {"w": jnp.asarray(w, jnp.bfloat16), "b": jnp.asarray(bias)}
    ref = np.asarray(JPC.lookup_corr_pallas(JPC.pad_pyramid_t(jp), jnp.asarray(coords),
                                            proj=proj), np.float32)
    levels = tuple(torch.from_numpy(np.asarray(lv[..., 0], np.float32)).bfloat16()
                   for lv in jp.levels)
    tp = TCORR.CorrPyramid(levels, b, h1, w1)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))).bfloat16()
    out = cuda_corr.lookup(tp, nchw(coords), wt, torch.from_numpy(bias))
    assert out.dtype == torch.bfloat16 and out.shape == (b, 256, h1, w1)
    np.testing.assert_allclose(out.float().numpy().transpose(0, 2, 3, 1), ref,
                               rtol=0.05, atol=0.02)
    # and both against the f32 separate conv of the f32 window
    look = JCORR.lookup_corr(jp, jnp.asarray(coords)).astype(jnp.float32)
    sep = np.asarray(jnp.maximum(JC.conv2d(look, jnp.asarray(w), jnp.asarray(bias)), 0.0))
    np.testing.assert_allclose(ref, sep, rtol=0.05, atol=0.02)
