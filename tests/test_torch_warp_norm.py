"""The warp (K2) with its zero-flow gate, and the instance norm (K4, K4s) with
its launch rule: the port against the JAX package on the CPU.

On the CPU the wrappers run their plain versions (the kernels are held
against the same plain versions on the card by chip_smoke.py). What the
kernels decide outside their arithmetic is checked here: the gate's select,
the reflect fold without fmodf in range, the rule that maps a plane size to
the instance norm's launch; also how the kernel timing reads a profiler
trace. Inputs come from numpy seeds; tolerance 1e-5 abs on O(1) f32 values
(the two packages sum in different orders).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_tpu.models.cista_lstc import CistaState as JState
from cista_flow_tpu.ops import conv as JC
from cista_flow_tpu.ops import warp as JW
from cista_flow_torch.config import Config
from cista_flow_torch.models import composite as TCOMP
from cista_flow_torch.models.cista_lstc import CistaState
from cista_flow_torch.ops import cuda_aug, cuda_norm
from cista_flow_torch.ops import warp as TW

ATOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0, atol=atol)


# ----------------------------- K2 and its gate ------------------------------

@pytest.mark.parametrize("code_channels", [1, 128])
@pytest.mark.parametrize("flow_kind", ["zero", "one_pixel", "dense"])
def test_warp_inputs_matches_jax(code_channels, flow_kind):
    """``_Composite._warp_inputs`` (both warps and the zero-flow select)
    against ``composite._warp_inputs`` of the JAX package, f32. At zero
    flow both return their inputs bit for bit; one moving pixel turns the
    warp on everywhere, where it is not the identity."""
    rng = np.random.default_rng(40)
    b, h, w = 2, 18, 26
    rec = rng.random((b, h, w, 1)).astype(np.float32)
    code = rng.standard_normal((b, h // 2, w // 2, code_channels)).astype(np.float32)
    other = rng.standard_normal((b, h // 2, w // 2, code_channels)).astype(np.float32)
    flow = np.zeros((b, h, w, 2), np.float32)
    if flow_kind == "one_pixel":
        flow[1, 5, 7] = (2.5, -1.25)
    elif flow_kind == "dense":
        flow = (3 * rng.standard_normal((b, h, w, 2))).astype(np.float32)

    jstate = JState(*(jnp.asarray(a) for a in (other, code, other, other)))
    jcfg = JConfig(image_dim=(h, w), model_mode="cista-eiflow")
    ji, jst = JCOMP._warp_inputs(jnp.asarray(rec), jstate, jnp.asarray(flow), jcfg)
    tstate = CistaState(*(nchw(a) for a in (other, code, other, other)))
    owner = SimpleNamespace(cfg=Config(image_dim=(h, w)))
    ti, tst = TCOMP._Composite._warp_inputs(owner, nchw(rec), tstate, nchw(flow))
    close(nhwc(ti), ji)
    close(nhwc(tst.sparse_code), jst.sparse_code)
    if flow_kind == "zero":
        assert torch.equal(ti, nchw(rec)) and torch.equal(tst.sparse_code, nchw(code))
        np.testing.assert_array_equal(np.asarray(ji), rec)
    else:
        assert not torch.equal(ti, nchw(rec))
        assert float((ti - nchw(rec))[0].abs().max()) > 0.0   # sample 0 has no flow
    assert tst.lstc_cell is tstate.lstc_cell


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 3, 128])
def test_warp_gate_selects(dtype, c):
    """The plain warp with its gate: False gives the input, True the
    ungated warp, bit for bit, through ``frame_warp`` in both modes."""
    rng = np.random.default_rng(41)
    img = torch.from_numpy(rng.standard_normal((2, c, 9, 13)).astype(np.float32)).to(dtype)
    flow = torch.from_numpy((4 * rng.standard_normal((2, 2, 9, 13))).astype(np.float32))
    for mode, sign in (("forward", -1.0), ("backward", 1.0)):
        plain = cuda_aug.warp_reflect_plain(img, flow, sign)
        assert torch.equal(TW.frame_warp(img, flow, mode), plain)
        assert torch.equal(TW.frame_warp(img, flow, mode, gate=torch.tensor(True)), plain)
        off = TW.frame_warp(img, flow, mode, gate=torch.tensor(False))
        assert torch.equal(off, img) and off.dtype == dtype
    with pytest.raises(ValueError, match="gate"):
        cuda_aug.warp_reflect(img.to("meta"), flow.to("meta"), -1.0,
                              torch.tensor([True], device="meta"))


def _fold_as_kernel(c: torch.Tensor, span: float) -> torch.Tensor:
    """warp.cu's reflect_coord in f32: fmod only beyond two periods, the
    subtraction (exact by Sterbenz) between one and two."""
    two = torch.tensor(2.0 * span, dtype=torch.float32)
    a = c.abs()
    r = torch.where(a < two, a, torch.where(a < 2 * two, a - two, torch.fmod(a, two)))
    return torch.where(r > span, two - r, r)


@pytest.mark.parametrize("size", [2, 13, 120, 240])
def test_reflect_fold_is_fmod_bit_for_bit(size):
    """The kernel's fold equals the plain ``_reflect`` (torch.fmod, as JAX's
    ``%`` on non-negative values) bit for bit around 0, the span, two and
    four spans and 1e4, on both sides, including -0.0."""
    span = float(size - 1)
    centres = [0.0, span, 2 * span, 3 * span, 4 * span, 8 * span, 1e4, 12345.678]
    pts = []
    for x in centres + [-v for v in centres]:
        v = np.float32(x)
        pts += [v, np.nextafter(v, np.float32(np.inf)), np.nextafter(v, np.float32(-np.inf))]
        pts += list(v + np.linspace(-1.5, 1.5, 31, dtype=np.float32))
    pts.append(np.float32(-0.0))
    pts = np.array(pts, np.float32)
    # the plain versions flush subnormal inputs to zero; the card does not
    pts = pts[(pts == 0) | (np.abs(pts) >= np.finfo(np.float32).tiny)]
    c = torch.from_numpy(pts)
    got = _fold_as_kernel(c, span)
    want = TW._reflect(c, 0.0, span)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    jref = np.asarray(JW._reflect(jnp.asarray(c.numpy()), 0.0, span))
    np.testing.assert_array_equal(got.numpy().view(np.int32), jref.view(np.int32))


# ------------------------------- K4, K4s ------------------------------------

def _covered(nv, threads, hw, vec):
    """The elements norm.cu's vector route gives the threads of one plane:
    thread t holds vectors j*threads + t (j < nv) below hw/vec."""
    t = np.arange(threads)[:, None]
    j = np.arange(nv)[None, :]
    vecs = (j * threads + t).ravel()
    vecs = vecs[vecs < hw // vec]
    return (vecs[:, None] * vec + np.arange(vec)[None, :]).ravel()


@pytest.mark.parametrize("elem_size", [2, 4])
def test_norm_launch_rule_covers_each_element_once(elem_size):
    """For every plane size 1..13000 (and some up to 100000) the rule picks a
    template that norm.cu instantiates, whose threads hold each element of a
    plane exactly once; sizes that are not whole 16-byte vectors, and
    misaligned tensors, take the generic route."""
    vec = 16 // elem_size
    routes = dict(cuda_norm.VECTOR_ROUTES[elem_size])
    largest = max(t * max(ns) for t, ns in routes.items())
    seen = set()
    for hw in list(range(1, 13001)) + [20000, 30000, 40000, 65536, 100000]:
        nv, threads, per_block = cuda_norm.launch_rule(hw, elem_size)
        assert cuda_norm.launch_rule(hw, elem_size, aligned=False) == (
            0, cuda_norm.LOOP_THREADS, 1)
        if nv == 0:
            assert (threads, per_block) == (cuda_norm.LOOP_THREADS, 1)
            assert hw % vec or hw // vec > largest
            continue
        assert hw % vec == 0 and nv in routes[threads]
        assert per_block == (cuda_norm.WARP_PLANES if threads == 32 else 1)
        # the smallest template: one fewer vector per thread would not cover
        smaller = [n for n in routes[threads] if n < nv]
        assert not smaller or max(smaller) * threads * vec < hw
        idx = _covered(nv, threads, hw, vec)
        assert len(idx) == hw and (np.bincount(idx, minlength=hw) == 1).all()
        seen.add((nv, threads))
    assert {(n, t) for t, ns in routes.items() for n in ns} == seen
    # each template is the one an encoder plane takes (768 and 3072 bf16
    # values a warp each; f32 3072 on a block, 12288 on 512 threads)
    want = {2: {768: (3, 32, 4), 3072: (12, 32, 4), 12288: (6, 256, 1)},
            4: {768: (6, 32, 4), 3072: (3, 256, 1), 12288: (6, 512, 1)}}[elem_size]
    assert {hw: cuda_norm.launch_rule(hw, elem_size) for hw in want} == want


@pytest.mark.parametrize("records, want", [
    ([(20, 100.0), (40, 400.0)], 25.0),           # every record: 5 + 2 x 10 us a call
    ([(19, 95.0), (38, 380.0)], 25.0),            # a few records lost
    ([(20, 100.0), (3, 9.0), (1, 50.0)], 5.0),    # strays of an earlier trace
    ([(20, 100.0), (30, 300.0)], None),           # half a name's records lost
    ([(2, 10.0)], None),                          # no kernel of the timed call
    ([], None),
])
def test_device_ms_reads_a_trace_per_kernel_name(records, want):
    """The kernel timing's reading of a profiler trace of 20 calls."""
    from cista_flow_torch.profile_kernels import per_call_us
    got = per_call_us(records, 20)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("shape", [(2, 3, 96, 128), (2, 4, 48, 64), (1, 5, 24, 32),
                                   (2, 3, 1, 1), (2, 3, 1, 7), (1, 4, 1, 769)])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_and_stats_match_jax(shape, relu):
    """``instance_norm_fused`` (plain on the CPU) against JAX
    ``conv.instance_norm`` (its f32 two-pass path), and ``instance_norm_stats``
    against that path's mean and 1/sqrt(var + eps), at the encoders' three
    plane sizes, ragged sizes and on constant planes."""
    rng = np.random.default_rng(42)
    b, c, h, w = shape
    x = (2.0 * rng.standard_normal((b, h, w, c)) + 0.7).astype(np.float32)
    x[0, ..., 0] = 0.3                                  # one constant plane
    ref = np.asarray(JC.instance_norm(jnp.asarray(x), relu=relu))
    out = cuda_norm.instance_norm_fused(nchw(x), relu=relu)
    close(nhwc(out)[..., 1:], ref[..., 1:])
    close(nhwc(out)[1:], ref[1:])
    # the constant plane: variance 0, so an f32 rounding of its mean (a few
    # 1e-7 in JAX's sum, 3e-8 in the port's) is scaled by 1/sqrt(eps) = 316
    close(nhwc(out)[0, ..., 0], ref[0, ..., 0], 1e-3)
    assert float(out[0, 0].abs().max()) <= 1e-4
    mean, inv = cuda_norm.instance_norm_stats(nchw(x))
    jm = np.asarray(jnp.mean(jnp.asarray(x), axis=(1, 2)))
    jinv = 1.0 / np.sqrt(np.asarray(jnp.var(jnp.asarray(x), axis=(1, 2))) + 1e-5)
    close(mean.numpy(), jm)
    close(inv.numpy(), jinv, 1e-5 * max(1.0, float(np.abs(jinv).max())))
