"""All-pairs correlation volume + pyramid window lookup (RAFT), NCHW.

Counterpart of cista_flow_tpu/ops/corr.py (ref:
DCEIFlow/core/corr/raft_corr.py:15-65). ``lookup_corr`` here is the plain
gather formulation; on the card the lookup runs as kernel K1
(ops/cuda_corr.py).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .pool import avg_pool2


class CorrPyramid(NamedTuple):
    levels: tuple   # each (B*H1*W1, h_l, w_l); a small frame's last may be empty
    batch: int
    h1: int
    w1: int


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> CorrPyramid:
    """fmap1/fmap2: (B, D, H, W) -> pyramid of correlation slices, stored in
    the input dtype."""
    b, d, h, w = fmap1.shape
    a = fmap1.reshape(b, d, h * w).transpose(1, 2)
    m = fmap2.reshape(b, d, h * w)
    corr = torch.matmul(a, m).float() / (float(d) ** 0.5)
    corr = corr.to(fmap1.dtype).reshape(b * h * w, h, w)
    levels = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool2(corr)
        levels.append(corr)
    return CorrPyramid(tuple(levels), b, h, w)


def lookup_corr(pyr: CorrPyramid, coords: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
    """(2r+1)^2 bilinear windows around ``coords`` at every level, zeros
    outside. coords: (B, 2, H1, W1) level-0 pixel coords (x, y). Returns
    (B, levels*(2r+1)^2, H1, W1) in the pyramid's dtype: level-major, then
    x-offset-major (the reference's meshgrid quirk)."""
    b, _, h1, w1 = coords.shape
    n = b * h1 * w1
    k = 2 * radius + 1
    cx = coords[:, 0].reshape(n).float()
    cy = coords[:, 1].reshape(n).float()
    d = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=coords.device)
    out = []
    for i, level in enumerate(pyr.levels):
        _, hl, wl = level.shape
        if hl * wl == 0:                     # an empty level is all outside
            out.append(torch.zeros((n, k * k), device=coords.device))
            continue
        px = (cx / (2.0 ** i))[:, None] + d[None]        # (n, k) by x offset
        py = (cy / (2.0 ** i))[:, None] + d[None]        # (n, k) by y offset
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = (px - x0)[:, :, None]                       # (n, bx, 1)
        fy = (py - y0)[:, None, :]                       # (n, 1, ay)
        flat = level.reshape(n, hl * wl).float()

        def tap(xi, yi):
            xi = xi[:, :, None].expand(n, k, k)
            yi = yi[:, None, :].expand(n, k, k)
            valid = (xi >= 0) & (xi <= wl - 1) & (yi >= 0) & (yi <= hl - 1)
            lin = (yi.clamp(0, hl - 1) * wl + xi.clamp(0, wl - 1)).long()
            g = torch.gather(flat, 1, lin.reshape(n, k * k)).reshape(n, k, k)
            return torch.where(valid, g, torch.zeros_like(g))

        win = (((1.0 - fy) * tap(x0, y0) + fy * tap(x0, y0 + 1)) * (1.0 - fx)
               + ((1.0 - fy) * tap(x0 + 1, y0) + fy * tap(x0 + 1, y0 + 1)) * fx)
        out.append(win.reshape(n, k * k))
    win = torch.cat(out, dim=1).reshape(b, h1, w1, -1).permute(0, 3, 1, 2)
    return win.contiguous().to(pyr.levels[0].dtype)


def coords_grid(batch: int, h: int, w: int, device=None) -> torch.Tensor:
    """(B, 2, H, W) grid of (x, y) pixel coords, f32
    (ref: DCEIFlow/utils/sample_utils.py:55-58)."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=0)[None].expand(batch, 2, h, w).contiguous()
