"""All-pairs correlation volume + pyramid window lookup (RAFT), NCHW.

Counterpart of cista_flow_tpu/ops/corr.py (ref:
DCEIFlow/core/corr/raft_corr.py:15-65). ``lookup_corr`` here is the plain
gather formulation; on the card the lookup runs as kernel K1
(ops/cuda_corr.py). ``EfficientCorr`` is the reference's on-the-fly
variant (plain PyTorch: the JAX function reaches no Pallas kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .autograd import at_least_f32
from .pool import avg_pool2


class CorrPyramid(NamedTuple):
    levels: tuple   # each (B*H1*W1, h_l, w_l); a small frame's last may be empty
    batch: int
    h1: int
    w1: int


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> CorrPyramid:
    """fmap1 (B, D, H1, W1), fmap2 (B, D, H2, W2) -> pyramid of correlation
    slices (B*H1*W1, H2 / 2^l, W2 / 2^l), stored in the input dtype. On one
    process both maps are the frame's; a row band correlates its ``fmap1``
    rows with the whole frame's ``fmap2`` (the pooling is over the target
    only, so the band's slices are the frame's)."""
    b, d, h, w = fmap1.shape
    h2, w2 = fmap2.shape[2:]
    a = fmap1.reshape(b, d, h * w).transpose(1, 2)
    m = fmap2.reshape(b, d, h2 * w2)
    corr = torch.matmul(a, m).float() / (float(d) ** 0.5)
    corr = corr.to(fmap1.dtype).reshape(b * h * w, h2, w2)
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
    cx = at_least_f32(coords[:, 0].reshape(n))
    cy = at_least_f32(coords[:, 1].reshape(n))
    d = torch.arange(-radius, radius + 1, dtype=cx.dtype, device=coords.device)
    out = []
    for i, level in enumerate(pyr.levels):
        _, hl, wl = level.shape
        if hl * wl == 0:                     # an empty level is all outside
            out.append(torch.zeros((n, k * k), dtype=cx.dtype, device=coords.device))
            continue
        px = (cx / (2.0 ** i))[:, None] + d[None]        # (n, k) by x offset
        py = (cy / (2.0 ** i))[:, None] + d[None]        # (n, k) by y offset
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = (px - x0)[:, :, None]                       # (n, bx, 1)
        fy = (py - y0)[:, None, :]                       # (n, 1, ay)
        flat = at_least_f32(level.reshape(n, hl * wl))

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


class EfficientCorr(NamedTuple):
    """The on-the-fly correlation: the feature pyramid of ``fmap2`` instead
    of the (H1*W1) x (H2*W2) volume (ref: DCEIFlow/core/corr/raft_corr.py:
    121-172; the JAX package's ``EfficientCorr``), O(B*H*W*D*levels) memory
    instead of O(B*(H*W)^2). Both maps in f32."""
    fmap1: torch.Tensor         # (B, D, H, W)
    fmap2_levels: tuple         # each (B, D, h_l, w_l)


def build_efficient_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
                         num_levels: int = 4) -> EfficientCorr:
    levels = [fmap2.float()]
    for _ in range(num_levels - 1):
        levels.append(avg_pool2(levels[-1]))
    return EfficientCorr(fmap1.float(), tuple(levels))


def lookup_efficient_corr(ec: EfficientCorr, coords: torch.Tensor,
                          radius: int = 4) -> torch.Tensor:
    """Sample ``fmap2``'s (2r+1)^2 window at each level and contract it
    with ``fmap1`` on the fly: ``lookup_corr`` over the materialised
    volume, in the same window order (level-major, then x-offset-major)
    and normalisation (1/sqrt(D)), in f32. coords: (B, 2, H1, W1) level-0
    pixel coords (x, y); returns (B, levels*(2r+1)^2, H1, W1).

    Each level is sampled by ``F.grid_sample`` at RAFT's convention
    (align_corners=True, zeros outside); a level under 2 pixels on a side
    is first zero-padded to 2, which leaves zeros-outside sampling as it
    was and keeps the normalisation's 2 / (size - 1) finite."""
    b, d, h1, w1 = ec.fmap1.shape
    k = 2 * radius + 1
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=coords.device)
    dx = offs[:, None].expand(k, k).reshape(-1)          # x-offset-major
    dy = offs[None, :].expand(k, k).reshape(-1)
    cx, cy = coords[:, 0].float(), coords[:, 1].float()
    out = []
    for i, level in enumerate(ec.fmap2_levels):
        hl, wl = level.shape[2:]
        level = F.pad(level, (0, max(0, 2 - wl), 0, max(0, 2 - hl)))
        hp, wp = level.shape[2:]
        px = (cx / (2.0 ** i))[..., None] + dx              # (B, H1, W1, K)
        py = (cy / (2.0 ** i))[..., None] + dy
        grid = torch.stack([2.0 * px / (wp - 1) - 1.0, 2.0 * py / (hp - 1) - 1.0], -1)
        sampled = F.grid_sample(level, grid.reshape(b, h1, w1 * k * k, 2), mode="bilinear",
                                padding_mode="zeros", align_corners=True)
        sampled = sampled.reshape(b, d, h1, w1, k * k)
        corr = torch.einsum("bdhw,bdhwk->bkhw", ec.fmap1, sampled)
        out.append(corr / (float(d) ** 0.5))
    return torch.cat(out, dim=1)


def coords_grid(batch: int, h: int, w: int, device=None, row0: int = 0) -> torch.Tensor:
    """(B, 2, H, W) grid of (x, y) pixel coords, f32
    (ref: DCEIFlow/utils/sample_utils.py:55-58); a row band's starts at its
    first row ``row0`` of the frame (the lookup's coordinates are the
    target frame's)."""
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=0)[None].expand(batch, 2, h, w).contiguous()
