"""What the port prepares outside its tensor-core conv tile
(cista_flow_torch/ops/conv_tile.py, csrc/conv3x3_mma.cuh), on the CPU: the
weight repack and its cache, the channel-grouped layout K3 keeps between its
launches, and the wrappers' orchestration of the launches with the kernel
call replaced by plain PyTorch on the same layouts.

Inputs come from a numpy seed. Layout tests use small integers, so that sums
are exact in f32 whatever their order and ``equal`` means equal. Against
the JAX package the tolerance is 1e-4 (f32 sums of 9*64 to 9*128 products
taken in another order, chained over ``depth`` convs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cista_flow_tpu.ops import pallas_conv as JPCONV
from cista_flow_tpu.ops import pallas_ista2 as JISTA
from cista_flow_torch.ops import conv_tile, cuda_conv, cuda_ista2

SHAPES = [(64, 64), (64, 128), (128, 64)]          # (Cout, Cin)


def ints(rng, *shape, lo=-3, hi=4):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.float32))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))


@pytest.fixture(autouse=True)
def fresh_cache():
    conv_tile.clear_cache()
    yield
    conv_tile.clear_cache()


@pytest.mark.parametrize("cout,cin", SHAPES)
def test_pack_weights_layout(cout, cin):
    """Every entry lands where the documented layout says:
    packed[g, 3*ky + kx, o, c] = w[o, 8*g + c, ky, kx]."""
    w = ints(np.random.default_rng(30), cout, cin, 3, 3, lo=-100, hi=100)
    p = conv_tile.pack_weights(w)
    assert p.shape == (cin // 8, 9, cout, 8) and p.is_contiguous()
    g, t, o, c = np.meshgrid(np.arange(cin // 8), np.arange(9), np.arange(cout),
                             np.arange(8), indexing="ij")
    want = w.numpy()[o, 8 * g + c, t // 3, t % 3]
    np.testing.assert_array_equal(p.numpy(), want)


@pytest.mark.parametrize("mode", ["zeros", "reflect"])
@pytest.mark.parametrize("cout,cin", SHAPES)
def test_conv_from_packed_weights_equals_conv2d(cout, cin, mode):
    """A plain conv computed from the repacked weights (an einsum over the
    documented axes) equals F.conv2d exactly."""
    rng = np.random.default_rng(31)
    w, x = ints(rng, cout, cin, 3, 3), ints(rng, 2, cin, 9, 11)
    ref = cuda_conv.conv3x3_plain(x, w, None, mode)
    out = conv_tile.conv3x3_from_packed(x, conv_tile.pack_weights(w), mode)
    assert torch.equal(out, ref)


def test_pack_weights_refuses_other_shapes():
    with pytest.raises(ValueError):
        conv_tile.pack_weights(torch.zeros(64, 60, 3, 3))
    with pytest.raises(ValueError):
        conv_tile.pack_weights(torch.zeros(64, 64, 1, 1))
    with pytest.raises(ValueError):
        conv_tile.to_grouped(torch.zeros(1, 12, 4, 4))


def test_packed_weights_cache_same_tensor_same_object():
    w = ints(np.random.default_rng(32), 64, 64, 3, 3)
    a = conv_tile.packed_weights(w, torch.float32)
    assert conv_tile.packed_weights(w, torch.float32) is a
    assert torch.equal(a, conv_tile.pack_weights(w))
    # another tensor of the same shape and values is another entry
    assert conv_tile.packed_weights(w.clone(), torch.float32) is not a


def test_packed_weights_cache_repacks_after_inplace_update():
    w = ints(np.random.default_rng(33), 64, 128, 3, 3)
    a = conv_tile.packed_weights(w, torch.float32)
    w.add_(1.0)
    b = conv_tile.packed_weights(w, torch.float32)
    assert b is not a
    assert torch.equal(b, conv_tile.pack_weights(w))
    assert conv_tile.packed_weights(w, torch.float32) is b


def test_packed_weights_cache_per_dtype():
    w = ints(np.random.default_rng(34), 128, 64, 3, 3)
    a = conv_tile.packed_weights(w, torch.float32)
    wb = w.to(torch.bfloat16)
    b = conv_tile.packed_weights(wb, torch.bfloat16)
    assert b is not a and b.dtype == torch.bfloat16
    assert conv_tile.packed_weights(wb, torch.bfloat16) is b
    # the cast is folded into the repack: f32 weights, bf16 activations
    c = conv_tile.packed_weights(w, torch.bfloat16)
    assert c.dtype == torch.bfloat16 and c is not a and c is not b
    assert torch.equal(c, b)
    assert conv_tile.packed_weights(w, torch.float32) is a


def test_cast_cached():
    b = ints(np.random.default_rng(35), 64)
    assert conv_tile.cast_cached(b, torch.float32) is b
    h = conv_tile.cast_cached(b, torch.bfloat16)
    assert h.dtype == torch.bfloat16 and conv_tile.cast_cached(b, torch.bfloat16) is h
    b.mul_(2.0)
    h2 = conv_tile.cast_cached(b, torch.bfloat16)
    assert h2 is not h and torch.equal(h2, b.to(torch.bfloat16))


def test_cache_is_bounded_and_keeps_its_sources_alive():
    """An entry holds its source, so a freed tensor's address cannot come
    back under the same key with other values; the oldest entries go."""
    for i in range(conv_tile.CACHE_ENTRIES + 10):
        w = torch.full((8, 8, 3, 3), float(i))
        p = conv_tile.packed_weights(w, torch.float32)
        assert float(p[0, 0, 0, 0]) == float(i)
    assert len(conv_tile._CACHE) == conv_tile.CACHE_ENTRIES


@pytest.mark.parametrize("shape", [(2, 64, 9, 11), (1, 128, 2, 2), (3, 8, 5, 40)])
def test_grouped_layout_round_trip(shape):
    x = ints(np.random.default_rng(36), *shape, lo=-100, hi=100)
    g = conv_tile.to_grouped(x)
    b, c, h, w = shape
    assert g.shape == (b, c // 8, h, w, 8) and g.is_contiguous()
    assert float(g[0, c // 8 - 1, h - 1, 1, 5]) == float(x[0, c - 3, h - 1, 1])
    back = conv_tile.from_grouped(g)
    assert back.is_contiguous() and torch.equal(back, x)


@pytest.mark.parametrize("hw,y0,x0,tile_w", [
    ((21, 45), 0, 0, 32), ((21, 45), 16, 32, 32), ((21, 45), 8, 40, 8),
    ((2, 2), 0, 0, 8), ((90, 120), 88, 96, 32)])
def test_staged_tile_reflect_halo_equals_pad(hw, y0, x0, tile_w):
    """The staging index rule gives F.pad(mode='reflect') wherever the tile
    lies inside the frame's 1-pixel halo (past a ragged edge it is clamped:
    those pixels are never stored)."""
    h, w = hw
    x = ints(np.random.default_rng(37), 1, 16, h, w, lo=-100, hi=100)
    tile = conv_tile.from_grouped(conv_tile.staged_tile(conv_tile.to_grouped(x), y0, x0, tile_w))
    assert tile.shape == (1, 16, conv_tile.TILE_ROWS + 2, tile_w + 2)
    pad = F.pad(x, (1, 1, 1, 1), mode="reflect")
    ny, nx = min(tile.shape[2], h + 2 - y0), min(tile.shape[3], w + 2 - x0)
    assert torch.equal(tile[:, :, :ny, :nx], pad[:, :, y0:y0 + ny, x0:x0 + nx])


def test_staged_tile_zero_halo_equals_pad():
    x = ints(np.random.default_rng(38), 1, 8, 12, 20, lo=1, hi=100)
    tile = conv_tile.from_grouped(
        conv_tile.staged_tile(conv_tile.to_grouped(x), 8, 16, 8, reflect=False))
    pad = F.pad(x, (1, 1, 1, 1))
    assert torch.equal(tile[:, :, :6, :6], pad[:, :, 8:14, 16:22])
    assert float(tile[:, :, 5:, :].abs().max()) == 0.0       # below the frame


@pytest.mark.parametrize("dtype,c,mma", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True), (torch.bfloat16, 32, False),
    (torch.bfloat16, 96, False), (torch.float32, 64, False)])
def test_which_inner_product(dtype, c, mma):
    assert cuda_conv.uses_mma_tile(dtype, c) is mma


def plain_conv_mma(kernel, mode, src, packed, bias, aux, lam, out):
    """What csrc/ista.cu ``cista_ista_conv_mma`` computes, in plain PyTorch on
    the same layouts (grouped in; grouped out, NCHW in mode G)."""
    y = conv_tile.conv3x3_from_packed(conv_tile.from_grouped(src), packed, "reflect")
    y = y + bias[None, :, None, None]
    if mode == cuda_ista2.MODE_G:
        out.copy_(torch.relu(y))
        return
    a = conv_tile.from_grouped(aux)
    if mode == cuda_ista2.MODE_D:
        y = a - y
    else:
        y = cuda_ista2.softshrink(y + a, lam[None, :, None, None])
    out.copy_(conv_tile.to_grouped(y))


def ista_inputs(rng, c, h, w, b=2):
    x1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    z = (0.1 * rng.standard_normal((b, h, w, 2 * c))).astype(np.float32)

    def conv(cin, cout):
        return {"w": (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32),
                "b": (0.05 * rng.standard_normal(cout)).astype(np.float32)}
    ista = {"D": conv(2 * c, c), "P": conv(c, 2 * c),
            "Lambda": (0.01 * rng.random((1, 1, 1, 2 * c))).astype(np.float32)}
    dg = conv(2 * c, c)
    w = (oihw(ista["D"]["w"]), torch.from_numpy(ista["D"]["b"]),
         oihw(ista["P"]["w"]), torch.from_numpy(ista["P"]["b"]),
         torch.from_numpy(ista["Lambda"].reshape(-1)))
    jt = lambda t: {k: (jt(v) if isinstance(v, dict) else jnp.asarray(v)) for k, v in t.items()}
    return x1, z, jt(ista), jt(dg), w, oihw(dg["w"]), torch.from_numpy(dg["b"])


@pytest.mark.parametrize("depth", [1, 3])
def test_grouped_ista_loop_matches_jax(monkeypatch, depth):
    """The launches of the tensor-core route, as the wrapper orders them
    (D into x1 - D(z), P into z in place, Dg into NCHW), each replaced by
    plain PyTorch on the grouped layout, vs pallas_ista2._xla_loop_dg; the
    caller's z is not modified."""
    monkeypatch.setattr(cuda_ista2, "_conv_mma", plain_conv_mma)
    monkeypatch.setattr(cuda_ista2, "_to_grouped", lambda kernel, t: conv_tile.to_grouped(t))
    x1, z, jista, jdg, w, gw, gb = ista_inputs(np.random.default_rng(39), 16, 10, 12)
    rz, rrec = JISTA._xla_loop_dg(jista, jdg, jnp.asarray(x1), jnp.asarray(z), depth)
    tx1, tz = nchw(x1), nchw(z)
    zg = cuda_ista2._loop_mma(None, w, tx1, tz, depth)
    rec = torch.empty_like(tx1)
    cuda_ista2._conv_mma(None, cuda_ista2.MODE_G, zg, conv_tile.packed_weights(gw, tx1.dtype),
                         gb, None, w[4], rec)
    np.testing.assert_allclose(nhwc(conv_tile.from_grouped(zg)), np.asarray(rz), rtol=0, atol=1e-4)
    np.testing.assert_allclose(nhwc(rec), np.asarray(rrec), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(nhwc(tz), z)
    # and it is the plain version's function (the einsum sums in another
    # order than F.conv2d: 1e-4 over the chained convs, as above)
    pz, prec = cuda_ista2.fused_ista_dg_plain(w, gw, gb, tx1, tz, depth)
    np.testing.assert_allclose(conv_tile.from_grouped(zg).numpy(), pz.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rec.numpy(), prec.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["zeros", "reflect"])
def test_conv_from_packed_matches_jax_conv3x3(mode):
    """The tile's arithmetic (packed weights, taps of a padded input) vs the
    Pallas im2col kernel in interpret mode, as tests/test_pallas_conv.py
    runs it."""
    rng = np.random.default_rng(40)
    x = rng.standard_normal((1, 16, 24, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal((3, 3, 64, 64))).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    assert JPCONV.supported(x.shape, w.shape)
    ref = JPCONV.conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), mode)
    out = conv_tile.conv3x3_from_packed(nchw(x), conv_tile.pack_weights(oihw(w)), mode)
    out = out + torch.from_numpy(b)[None, :, None, None]
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=0, atol=1e-4)
