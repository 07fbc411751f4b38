"""Plain PyTorch operations of the reference: convs, norms, resizes, the
reflection warp, the correlation pyramid and its window lookup, convex
upsampling.

A frozen copy of the arithmetic of CISTA-Flow's published models
(lsying009/CISTA-Flow: ``e2v/base_layers.py``, ``utils/flow_utils.py``,
``DCEIFlow/core``, ``ERAFT``), written on ``torch.nn.functional`` alone: no
custom kernel, no cache, no batching trick. Every product goes through
``Ops.conv2d`` or ``Ops.matmul``, so that a lower-precision control can
round their operands (``fp8_rounding``) while everything else stays f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0          # the largest finite float8_e4m3fn


def fp8_rounding(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one per-tensor scale (its
    largest magnitude to 448), as an fp8 inference path scales a tensor
    before its GEMM; the product itself then sums in f32."""
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Ops:
    """The products of the reference. ``rounding`` (None, or a function of
    a tensor) is applied to both operands of every conv and matmul: None
    is the f32 reference, ``fp8_rounding`` its fp8 control."""

    def __init__(self, params: dict, rounding=None):
        self.p = params
        self.rounding = rounding

    def _r(self, t):
        return t if self.rounding is None else self.rounding(t)

    def conv(self, x, name, stride=1, padding=0, reflect=False):
        """The conv ``name`` (``name.weight``, ``name.bias``) of x."""
        w = self.p[name + ".weight"]
        b = self.p.get(name + ".bias")
        ph, pw = (padding, padding) if isinstance(padding, int) else padding
        if reflect and (ph or pw):
            x = F.pad(x, (pw, pw, ph, ph), mode="reflect")
            ph = pw = 0
        return F.conv2d(self._r(x), self._r(w), b, stride=stride, padding=(ph, pw))

    def matmul(self, a, b):
        return torch.matmul(self._r(a), self._r(b))


def instance_norm(x, eps=1e-5):
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def batch_norm_eval(x, p: dict, name: str, eps=1e-5):
    mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    inv = torch.rsqrt(var + eps) * p[name + ".weight"]
    return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
        + p[name + ".bias"][None, :, None, None]


def resize(x, out_hw, align_corners):
    if tuple(out_hw) == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=align_corners)


def upflow(flow, factor):
    """RAFT's ``upflow8``: align_corners resize, magnitudes times ``factor``."""
    h, w = flow.shape[2:]
    return resize(flow, (h * factor, w * factor), True) * float(factor)


def pad_to(x, multiple=32):
    """Zeros on the top and the left up to a multiple (E-RAFT's ImagePadder)."""
    h, w = x.shape[2:]
    ph, pw = (-h) % multiple, (-w) % multiple
    return F.pad(x, (pw, 0, ph, 0)) if (ph or pw) else x


def unpad(x, hw):
    return x[:, :, x.shape[2] - hw[0]:, x.shape[3] - hw[1]:]


def frame_warp(img, flow, gate):
    """CISTA-Flow's forward frame warp (utils/flow_utils.py ``warp_frame``):
    ``grid_sample`` at grid - flow normalised by 2*(x/W - 0.5),
    reflection padding, align_corners=True; the input itself where
    ``gate`` (any nonzero flow) is false."""
    b, _, h, w = img.shape
    xx = torch.arange(w, dtype=flow.dtype, device=flow.device)[None, None, :]
    yy = torch.arange(h, dtype=flow.dtype, device=flow.device)[None, :, None]
    gx = 2.0 * ((xx - flow[:, 0]) / w - 0.5)
    gy = 2.0 * ((yy - flow[:, 1]) / h - 0.5)
    out = F.grid_sample(img, torch.stack([gx, gy], -1), mode="bilinear",
                        padding_mode="reflection", align_corners=True)
    return torch.where(gate, out, img)


def coords_grid(b, h, w, device):
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys])[None].expand(b, 2, h, w)


def corr_pyramid(ops: Ops, fmap1, fmap2, levels=4):
    """All-pairs correlation / sqrt(D), then 2x2 average pools."""
    b, d, h, w = fmap1.shape
    corr = ops.matmul(fmap1.reshape(b, d, h * w).transpose(1, 2),
                      fmap2.reshape(b, d, h * w)) / math.sqrt(d)
    corr = corr.reshape(b * h * w, 1, h, w)
    pyr = [corr]
    for _ in range(levels - 1):
        pyr.append(F.avg_pool2d(pyr[-1], 2, stride=2))
    return pyr


def corr_lookup(pyr, coords, radius=4):
    """RAFT's window lookup: (2r+1)^2 bilinear samples around ``coords``
    at every level, zeros outside, level-major then x-offset-major.
    Returns (B, levels*(2r+1)^2, H, W)."""
    b, _, h, w = coords.shape
    n = b * h * w
    k = 2 * radius + 1
    cx = coords[:, 0].reshape(n)
    cy = coords[:, 1].reshape(n)
    d = torch.arange(-radius, radius + 1, dtype=cx.dtype, device=coords.device)
    out = []
    for i, level in enumerate(pyr):
        hl, wl = level.shape[2:]
        px = (cx / 2.0 ** i)[:, None] + d[None]
        py = (cy / 2.0 ** i)[:, None] + d[None]
        x0, y0 = torch.floor(px), torch.floor(py)
        fx = (px - x0)[:, :, None]
        fy = (py - y0)[:, None, :]
        flat = level.reshape(n, hl * wl)

        def tap(xi, yi):
            xi = xi[:, :, None].expand(n, k, k)
            yi = yi[:, None, :].expand(n, k, k)
            inside = (xi >= 0) & (xi <= wl - 1) & (yi >= 0) & (yi <= hl - 1)
            lin = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()
            g = torch.gather(flat, 1, lin.reshape(n, k * k)).reshape(n, k, k)
            return torch.where(inside, g, torch.zeros_like(g))

        win = (((1.0 - fy) * tap(x0, y0) + fy * tap(x0, y0 + 1)) * (1.0 - fx)
               + ((1.0 - fy) * tap(x0 + 1, y0) + fy * tap(x0 + 1, y0 + 1)) * fx)
        out.append(win.reshape(n, k * k))
    return torch.cat(out, 1).reshape(b, h, w, -1).permute(0, 3, 1, 2)


def convex_upsample(flow, mask, factor=8):
    """RAFT's convex upsampling: a 9-way softmax over the zero-padded 3x3
    neighbourhood of the coarse flow (in fine pixels) per fine pixel."""
    b, _, h, w = flow.shape
    r = factor
    m = torch.softmax(mask.reshape(b, 1, 9, r, r, h, w), dim=2)
    nbr = F.unfold(flow * r, kernel_size=3, padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = (m * nbr).sum(dim=2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, h * r, w * r)
