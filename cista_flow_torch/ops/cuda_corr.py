"""K1: correlation window lookup with the fused convc1 (csrc/corr.cu).

Counterpart of cista_flow_tpu/ops/pallas_corr.py ``lookup_corr_pallas``.
CUDA tensors go to the kernel (or raise); CPU tensors take the plain
version below. Both round where the JAX kernel does: the window to the
pyramid's dtype, the weight to it too, the products summed and the bias
added in f32, one rounding at the end. The kernel takes the convc1 weight
packed once per weight tensor (``corr_tile.packed_corr_weights``) and the
bias as f32 (``conv_tile.cast_cached``), so a call launches K1 alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .autograd import apply_kernel, at_least_f32
from .conv_tile import cast_cached
from .corr import CorrPyramid, lookup_corr
from .corr_tile import packed_corr_weights
from .cuda_build import DTYPE_CODES, I, Kernel, P, check_cuda, on_cpu

KERNEL = Kernel("corr.cu", {"cista_corr_lookup": [I, I, P, P, P, P, I, I, I, I,
                                                  I, I, I, I, P, P, P, P, I, I, P]})
RADIUS = 4
LEVELS = 4
PROJ_CHANNELS = 256   # the kernel's fused output width


def lookup_plain(pyr: CorrPyramid, coords: torch.Tensor, weight=None,
                 bias=None) -> torch.Tensor:
    """lookup_corr, then relu(1x1 conv + bias) when ``weight`` is given:
    the window and the weight in the pyramid's dtype, the sum and the bias
    in f32, rounded once."""
    c = lookup_corr(pyr, coords, RADIUS)
    if weight is None:
        return c
    y = F.conv2d(at_least_f32(c), at_least_f32(weight.to(c.dtype)), at_least_f32(bias))
    return torch.relu(y).to(c.dtype)


def lookup(pyr: CorrPyramid, coords: torch.Tensor, weight=None,
           bias=None) -> torch.Tensor:
    """coords: (B, 2, H1, W1) f32 level-0 pixel coords. Without ``weight``
    returns the (B, 324, H1, W1) windows; with the convc1 ``weight``
    (256, 324, 1, 1) and ``bias`` (256,) returns relu(convc1(windows)),
    (B, 256, H1, W1). Output in the pyramid's dtype. A level may be empty
    (0 rows or columns: a frame under 64 px); it contributes zeros, as taps
    outside a level do. Differentiable in the levels, the coords and the
    convc1 parameters: the gradient is autograd of ``lookup_plain``."""
    if on_cpu(coords):
        return lookup_plain(pyr, coords, weight, bias)

    def unpacked(fn):
        return lambda coords, weight, bias, *levels: fn(
            pyr._replace(levels=levels), coords, weight, bias)
    return apply_kernel("K1", unpacked(_lookup_kernel), unpacked(lookup_plain),
                        coords, weight, bias, *pyr.levels)


def _lookup_kernel(pyr: CorrPyramid, coords, weight, bias):
    levels = pyr.levels
    b, two, h1, w1 = coords.shape
    n = b * h1 * w1
    if len(levels) != LEVELS or two != 2 or coords.dtype != torch.float32:
        raise ValueError("corr kernel needs 4 levels and f32 (B, 2, H1, W1) coords")
    for lv in levels:
        if lv.dim() != 3 or lv.shape[0] != n:
            raise ValueError(f"corr kernel: level shape {tuple(lv.shape)} does not "
                             f"match {n} samples")
    dt = levels[0].dtype
    check_cuda("corr_lookup", DTYPE_CODES, *levels, coords)
    if any(lv.dtype != dt for lv in levels):
        raise ValueError("corr kernel: levels differ in dtype")
    proj = weight is not None
    if proj:
        if weight.shape != (PROJ_CHANNELS, LEVELS * 81, 1, 1) or bias.shape != (PROJ_CHANNELS,):
            raise ValueError(f"corr kernel projects 324 -> {PROJ_CHANNELS} only")
        wt = packed_corr_weights(weight, dt)
        bias = cast_cached(bias, torch.float32)
        check_cuda("corr_lookup", (dt,), wt, levels[0])
        check_cuda("corr_lookup", (torch.float32,), bias, coords)
        out = torch.empty((b, PROJ_CHANNELS, h1, w1), dtype=dt, device=coords.device)
    else:
        wt = bias = None
        out = torch.empty((b, LEVELS * 81, h1, w1), dtype=dt, device=coords.device)
    hs = [lv.shape[1] for lv in levels]
    ws = [lv.shape[2] for lv in levels]
    KERNEL.launch("cista_corr_lookup", DTYPE_CODES[dt], int(proj),
                  *[lv.data_ptr() for lv in levels], *hs, *ws,
                  coords.data_ptr(), wt.data_ptr() if proj else None,
                  bias.data_ptr() if proj else None, out.data_ptr(),
                  n, h1 * w1, device=coords.device)
    return out
