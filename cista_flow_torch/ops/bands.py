"""Row bands: the banded forms of the ops a row-sharded serving step runs.

Under ``--mesh_shape N --mesh_axes spatial`` each of N ranks holds a band of
rows of every activation and of the recurrent state
(``parallel/spatial.py``). While a rank steps, ``active()`` is its band (a
``parallel.spatial.RowBand``); on one process it is None, and every op
below is then the unbanded op itself.

The rule for convs: a conv, or a run of n convs, of vertical radius r takes
r*n halo rows from each neighbour (``widen``), runs unchanged on the
widened band (K5 with its own zeros or reflect padding, cuDNN elsewhere)
and drops the rows its padding contaminated (``crop``). At an interior edge
whatever the padding touches lies in the dropped rows; at the frame's own
top and bottom there is no halo, and the padding is the frame's. A stride-2
conv takes an even halo (``conv_halo``), so that the widened band starts on
the unsharded output grid.

Instance norm takes each band's statistics (K4s on the card), combines
them across ranks in f32 by element counts (``combine_stats``) and
normalises with the frame's. Resizes map rows globally: ``resize_rows``
computes a band's output rows of a bilinear resize of the whole frame from
the input rows around them. The functions take their halos and the other
ranks' statistics as arguments, so one process can check them by cutting a
tensor into bands; ``RowBand`` exchanges them.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import resize as _resize
from . import upsample as _upsample
from .autograd import at_least_f32

_ACTIVE = None         # the band of the step this process runs, or None


def active():
    """The ``RowBand`` of the sharded step running here, or None."""
    return _ACTIVE


@contextlib.contextmanager
def rows(band):
    """Run the block on ``band``: convs, norms, resizes, the correlation
    target and the warps below take it."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, band
    try:
        yield
    finally:
        _ACTIVE = outer


@contextlib.contextmanager
def local():
    """Run the block as on one process: for a call on a widened band whose
    halo was exchanged once for a run of convs (the ISTA loop)."""
    with rows(None):
        yield


# ------------------------------- convs ---------------------------------------

def conv_halo(kernel_h: int, stride: int, padding: int) -> int:
    """Halo rows a conv needs from each neighbour: its padding, which for a
    'same' conv of stride 1 is its radius; at stride 2 the padding rounded
    up to even, so the widened band's first row keeps the output grid."""
    if stride == 1:
        if kernel_h != 2 * padding + 1:
            raise ValueError(f"a banded conv of stride 1 must keep the rows: kernel "
                             f"{kernel_h}, padding {padding}")
        return padding
    if stride != 2 or kernel_h - padding - 2 > padding + padding % 2:
        raise ValueError(f"no banded conv of kernel {kernel_h}, stride {stride}, "
                         f"padding {padding}")
    return padding + padding % 2


def widen(x: torch.Tensor, top, bottom) -> torch.Tensor:
    """The band with its halos (None at the frame's edge) along the rows
    (dim -2)."""
    parts = [t for t in (top, x, bottom) if t is not None]
    return x if len(parts) == 1 else torch.cat(parts, dim=-2)


def crop(y: torch.Tensor, top, rows: int, stride: int = 1) -> torch.Tensor:
    """The band's ``rows // stride`` output rows of ``y``, computed on the
    band widened by ``top`` above, contiguous (as the kernels take them)."""
    if rows % stride:
        raise ValueError(f"a band of {rows} rows under a stride-{stride} conv")
    first = 0 if top is None else top.shape[-2] // stride
    return y[..., first:first + rows // stride, :].contiguous()


# ------------------------------ instance norm --------------------------------

def band_stats(mean: torch.Tensor, inv: torch.Tensor, count: int, eps: float) -> torch.Tensor:
    """(3, B, C) f32: a band's mean, variance (from K4s's inverse std) and
    element count, as the ranks exchange them."""
    var = inv.reciprocal().square() - eps
    return torch.stack([mean, var, torch.full_like(mean, float(count))])


def combine_stats(stats: torch.Tensor, eps: float):
    """The frame's (mean, inverse std), each (B, C) f32, from the bands'
    ``band_stats`` stacked in rank order (N, 3, B, C): the means weighted
    by counts, the variances through the squared deviations of the band
    means from the frame's."""
    mean_i, var_i, n_i = stats[:, 0], stats[:, 1], stats[:, 2]
    n = n_i.sum(0)
    mean = (n_i * mean_i).sum(0) / n
    var = (n_i * (var_i + (mean_i - mean).square())).sum(0) / n
    return mean, torch.rsqrt(var + eps)


def normalise(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
              relu: bool) -> torch.Tensor:
    y = (at_least_f32(x) - mean[:, :, None, None]) * inv[:, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


# ------------------------------- resizes -------------------------------------

def source_rows(rows, in_size: int, out_size: int, align_corners: bool):
    """(first, second, weight of the second) source row of each output row
    of a bilinear resize from ``in_size`` to ``out_size`` rows, computed as
    PyTorch's kernel computes them (f32 scale and index, ATen's
    ``area_pixel_compute_source_index`` and ``guard_index_and_lambda``)."""
    dst = torch.arange(rows[0], rows[1], dtype=torch.float32)
    if align_corners:
        scale = (torch.tensor(float(in_size - 1)) / (out_size - 1) if out_size > 1
                 else torch.tensor(0.0))
        src = dst * scale
    else:
        scale = torch.tensor(float(in_size)) / out_size
        src = ((dst + 0.5) * scale - 0.5).clamp(min=0.0)
    y0 = torch.floor(src).clamp(max=in_size - 1)
    lam = (src - y0).clamp(0.0, 1.0)
    y1 = y0 + (y0 < in_size - 1).to(y0.dtype)
    return y0.long(), y1.long(), lam


def resize_rows(x: torch.Tensor, first: int, in_h: int, out_hw, rows,
                align_corners: bool) -> torch.Tensor:
    """Output rows ``rows`` = [r0, r1) of ``resize_bilinear`` of a frame of
    ``in_h`` rows to ``out_hw``, from ``x`` holding the frame's rows
    [first, first + x.shape[-2]) (a band with its halo, or the whole frame).
    The columns are resized first (the rows unchanged), then the rows are
    blended, in f32; the result is in x's dtype."""
    y0, y1, lam = source_rows(rows, in_h, int(out_hw[0]), align_corners)
    lo, hi = int(y0.min()) - first, int(y1.max()) - first
    if lo < 0 or hi >= x.shape[-2]:
        raise ValueError(f"rows {rows} read source rows {lo + first}..{hi + first}, "
                         f"outside the {x.shape[-2]} rows from {first}")
    xf = x.float()
    if int(out_hw[1]) != x.shape[-1]:
        xf = F.interpolate(xf, size=(x.shape[-2], int(out_hw[1])), mode="bilinear",
                           align_corners=align_corners)
    lam = lam.to(x.device)[:, None]
    a = xf.index_select(-2, (y0 - first).to(x.device))
    b = xf.index_select(-2, (y1 - first).to(x.device))
    return (a * (1.0 - lam) + b * lam).to(x.dtype)


def convex_upsample_rows(flow: torch.Tensor, top, bottom, mask: torch.Tensor,
                         factor: int, flow_scale: int | None = None) -> torch.Tensor:
    """``ops.upsample.convex_upsample`` of a band of the coarse flow whose
    3x3 zero-padded neighbourhood takes one halo row from each neighbour
    (None at the frame's edge, where the padding's zeros are the frame's)."""
    b, _, h, w = flow.shape
    r = factor
    scale = float(factor if flow_scale is None else flow_scale)
    wide = widen(flow, top, bottom)
    first = 0 if top is None else top.shape[-2]
    m = torch.softmax(mask.float().view(b, 1, 9, r, r, h, w), dim=2)
    nbr = F.unfold(wide.float() * scale, kernel_size=3, padding=1)
    nbr = nbr.view(b, 2, 9, wide.shape[-2], w)[:, :, :, first:first + h]
    up = (m * nbr.reshape(b, 2, 9, 1, 1, h, w)).sum(dim=2)
    up = up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, h * r, w * r)
    return up.to(flow.dtype)


# ------------------- the ops as a model calls them ---------------------------

def first_row(scale: int, padded: bool) -> int:
    """This band's first row in the frame at 1/``scale`` (the flow net's
    padded frame or the unpadded one); 0 on one process."""
    return 0 if _ACTIVE is None else _ACTIVE.rows(scale, padded)[0]


def gather(x: torch.Tensor, scale: int, padded: bool) -> torch.Tensor:
    """The whole frame of the bands ``x`` at 1/``scale``; ``x`` on one
    process."""
    return x if _ACTIVE is None else _ACTIVE.gather_rows(x, scale, padded)


def resize(x: torch.Tensor, scale_in: int, scale_out: int, padded: bool,
           align_corners: bool) -> torch.Tensor:
    """The band's rows at 1/``scale_out`` of the frame's bilinear resize
    from 1/``scale_in``, from the band and one row of each neighbour: the
    resizes here (x8, x0.5 and x2 with align_corners, x2 and x0.5 without) read at most
    one row beyond a band's (``resize_rows`` raises otherwise)."""
    band = _ACTIVE
    top, bottom = band.halo(x, 1, 1)
    first = band.rows(scale_in, padded)[0] - (0 if top is None else top.shape[-2])
    r0, r1, out_h = band.rows(scale_out, padded)
    out_w = x.shape[-1] * scale_in // scale_out
    return resize_rows(widen(x, top, bottom), first, band.rows(scale_in, padded)[2],
                       (out_h, out_w), (r0, r1), align_corners)


def upflow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """``ops.resize.upflow`` from the flow net's 1/``factor`` padded frame."""
    if _ACTIVE is None:
        return _resize.upflow(flow, factor)
    return resize(flow, factor, 1, True, True) * float(factor)


def rescale(x: torch.Tensor, scale_in: int, scale_out: int,
            align_corners: bool) -> torch.Tensor:
    """``ops.resize.interpolate_scale`` by ``scale_in / scale_out`` of a map
    at 1/``scale_in`` of the unpadded frame (``flow_half``'s x0.5 and x2);
    on a row band, the band's rows of it."""
    if _ACTIVE is None:
        return _resize.interpolate_scale(x, scale_in / scale_out, align_corners)
    return resize(x, scale_in, scale_out, False, align_corners)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int,
                    flow_scale: int | None = None) -> torch.Tensor:
    """``ops.upsample.convex_upsample`` of E-RAFT's and IDNet's coarse flows."""
    if _ACTIVE is None:
        return _upsample.convex_upsample(flow, mask, factor, flow_scale)
    top, bottom = _ACTIVE.halo(flow, 1, 1)
    return convex_upsample_rows(flow, top, bottom, mask, factor, flow_scale)
