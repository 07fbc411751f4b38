"""Grid sampling and flow warping (NCHW) with torch ``grid_sample`` semantics.

Counterpart of cista_flow_tpu/ops/warp.py. The frame and state warps use
align_corners=True, reflection padding and the reference's non-standard
grid normalization ``2*(x/W - 0.5)`` (W, not W-1); on the card they run as
one fused kernel (ops/cuda_aug.py). ``bilinear_sampler`` is RAFT's lookup
sampler (zeros padding, pixel coordinates).
"""
from __future__ import annotations

import torch


def _reflect(coords: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Reflect coordinates into [lo, hi] (torch reflect_coordinates)."""
    rng = hi - lo
    if rng <= 0:
        return torch.zeros_like(coords) + lo
    two = 2.0 * rng
    x = torch.fmod(torch.abs(coords - lo), two)   # exact, as C fmodf
    return torch.where(x > rng, two - x, x) + lo


def sample_pixel_coords(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                        padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample of NCHW ``img`` at float pixel coords (gx, gy), each
    (B, Hg, Wg) f32, with grid_sample's align_corners=True geometry.
    Returns (B, C, Hg, Wg) in img's dtype; the corner blend accumulates in
    f32."""
    b, c, h, w = img.shape
    gx = gx.float()
    gy = gy.float()
    if padding_mode == "reflection":
        gx = _reflect(gx, 0.0, float(w - 1))
        gy = _reflect(gy, 0.0, float(h - 1))
        gx = gx.clamp(0.0, float(w - 1))
        gy = gy.clamp(0.0, float(h - 1))
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode {padding_mode}")

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    flat = img.reshape(b, c, h * w)

    def corner(xi, yi, wt):
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            wt = torch.where(valid, wt, torch.zeros_like(wt))
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        lin = (yc * w + xc).reshape(b, 1, -1).expand(b, c, -1)
        g = torch.gather(flat, 2, lin).reshape(b, c, *gx.shape[1:])
        return g.float() * wt[:, None]

    out = (corner(x0, y0, wx0 * wy0) + corner(x0 + 1, y0, wx1 * wy0)
           + corner(x0, y0 + 1, wx0 * wy1) + corner(x0 + 1, y0 + 1, wx1 * wy1))
    return out.to(img.dtype)


def frame_warp_coords(flow: torch.Tensor, sign: float):
    """Pixel sample coords of the reference frame warps: ``grid + sign *
    flow`` through the non-standard normalization 2*(x/W - 0.5)
    (ref: utils/flow_utils.py:113-119), mapped back to pixels as
    grid_sample(align_corners=True) does."""
    b, _, h, w = flow.shape
    f = flow.float()
    xx = torch.arange(w, dtype=torch.float32, device=flow.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=flow.device)[None, :, None]
    gx = xx + sign * f[:, 0]
    gy = yy + sign * f[:, 1]
    nx = 2.0 * (gx / w - 0.5)
    ny = 2.0 * (gy / h - 0.5)
    return (nx + 1.0) * 0.5 * (w - 1), (ny + 1.0) * 0.5 * (h - 1)


def frame_warp(img: torch.Tensor, flow: torch.Tensor, mode: str = "forward",
               gate: torch.Tensor | None = None) -> torch.Tensor:
    """``FrameWarp.warp_frame`` (ref: utils/flow_utils.py:193-221):
    mode='forward' samples at grid - flow, 'backward' at grid + flow.
    img (B, C, H, W); flow (B, 2, H, W) f32. ``gate``: None, or a 0-dim
    bool tensor on img's device; where it is false the result is ``img``
    unchanged (the reference's zero-flow short-circuit, selected on the
    device inside the kernel)."""
    from . import cuda_aug
    if mode == "forward":
        return cuda_aug.warp_reflect(img, flow, -1.0, gate)
    if mode == "backward":
        return cuda_aug.warp_reflect(img, flow, 1.0, gate)
    raise ValueError(f"unknown warp mode {mode}")


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """RAFT lookup sampler: pixel coords (B, 2, Hg, Wg) as (x, y), zeros
    padding, align_corners=True (ref: DCEIFlow/utils/sample_utils.py:38-52)."""
    return sample_pixel_coords(img, coords[:, 0], coords[:, 1],
                               padding_mode="zeros")
