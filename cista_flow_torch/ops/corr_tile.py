"""What K1 (csrc/corr.cu) wants prepared outside the kernel, as plain PyTorch
that also runs on the CPU: the convc1 weight packed once per weight tensor,
and a model of the kernel's patch gather.

Layouts:
 * packed weight ``(42, 256, 8)``: ``packed[g, o, c] = w[o, 8*g + c]`` for
   the (256, 324, 1, 1) convc1 weight, and 0 for ``8*g + c >= 324`` (K
   padded to 336 = 21 k16 steps). For one group of 8 window channels, 8
   neighbouring outputs are 128 contiguous bytes in bf16: one core matrix
   of wgmma's B operand, as in ``conv_tile.pack_weights``. The pads are
   zero so that the padded products add nothing, whatever shared memory
   held before.
 * the patch gather: the 81 taps of one (sample, level) read the 11x11
   patch of the level whose corner is (floor(x) - 4, floor(y) - 4) at
   (x, y) = coords / 2^l. Each x offset takes its floor and fraction as
   ``corr.lookup_corr`` does (``frac(c/2^l + d)``); where c/2^l + d rounds
   up to an integer the floor moves one column or row on, which the 11th
   column and row cover.
"""
from __future__ import annotations

import torch

from .conv_tile import _cached

RADIUS = 4
WIN = 2 * RADIUS + 1            # 9
LEVELS = 4
CHANNELS = LEVELS * WIN * WIN   # 324
K_PADDED = 336                  # 21 k16 steps
GROUP = 8
PROJ_CHANNELS = 256


def pack_corr_weights(w: torch.Tensor) -> torch.Tensor:
    """(256, 324, 1, 1) -> (42, 256, 8), the pad rows zero, contiguous."""
    if tuple(w.shape) != (PROJ_CHANNELS, CHANNELS, 1, 1):
        raise ValueError(f"pack_corr_weights: {tuple(w.shape)} is not "
                         f"({PROJ_CHANNELS}, {CHANNELS}, 1, 1)")
    wk = torch.zeros((PROJ_CHANNELS, K_PADDED), dtype=w.dtype, device=w.device)
    wk[:, :CHANNELS] = w.reshape(PROJ_CHANNELS, CHANNELS)
    return wk.reshape(PROJ_CHANNELS, K_PADDED // GROUP, GROUP).permute(1, 0, 2).contiguous()


def packed_corr_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_corr_weights(w)`` in ``dtype``, prepared once per weight
    tensor (``conv_tile``'s cache: a hit until ``w`` changes in place)."""
    return _cached("corr", w, dtype, lambda t: pack_corr_weights(t.detach().to(dtype)))


def project_from_packed(win: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """(n, 324) windows times the packed weight, as the kernel sums them:
    the windows padded with zeros to 336, then over the 42 groups of 8."""
    n = win.shape[0]
    a = torch.zeros((n, K_PADDED), dtype=win.dtype, device=win.device)
    a[:, :CHANNELS] = win
    return torch.einsum("ngc,goc->no", a.reshape(n, K_PADDED // GROUP, GROUP), packed)


def window_by_patch(levels, coords: torch.Tensor) -> torch.Tensor:
    """The window as csrc/corr.cu gathers it: (n, 324) f32, level-major then
    x-offset-major, from ``levels`` (each (n, h_l, w_l), possibly empty) and
    (B, 2, H1, W1) coords. Per (sample, level, x offset) the two columns of
    the offset's floor are read over the patch's 11 rows, and tap ay takes
    rows ay and ay + 1 of them, or ay + 1 and ay + 2 where its own floor
    lies one row on."""
    b, _, h1, w1 = coords.shape
    n = b * h1 * w1
    cx = coords[:, 0].reshape(n).float()
    cy = coords[:, 1].reshape(n).float()
    d = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=coords.device)
    rows = torch.arange(WIN + 2, device=coords.device)
    out = []
    for lvl, level in enumerate(levels):
        _, hl, wl = level.shape
        cxs, cys = cx / 2.0 ** lvl, cy / 2.0 ** lvl
        px = cxs[:, None] + d[None]                                   # (n, bx)
        x0f = torch.floor(px)
        fx = px - x0f
        x0 = x0f.clamp(-2, wl).long()                                 # (n, bx)
        ybf = torch.floor(cys)
        y0 = (ybf - RADIUS).clamp(-WIN - 3, hl).long()                # (n,)
        r = y0[:, None] + rows[None]                                  # (n, 11)
        flat = level.reshape(n, hl * wl).float()

        def column(xc):                                               # (n, bx, 11)
            ok = ((r[:, None, :] >= 0) & (r[:, None, :] < hl)
                  & (xc[:, :, None] >= 0) & (xc[:, :, None] < wl))
            if hl * wl == 0:
                return torch.zeros(ok.shape, device=coords.device)
            lin = (r.clamp(0, max(hl - 1, 0))[:, None, :] * wl
                   + xc.clamp(0, max(wl - 1, 0))[:, :, None])
            g = torch.gather(flat, 1, lin.reshape(n, -1)).reshape(ok.shape)
            return torch.where(ok, g, torch.zeros_like(g))

        a, bcol = column(x0), column(x0 + 1)
        py = cys[:, None] + d[None]                                   # (n, ay)
        yf = torch.floor(py)
        fy = (py - yf)[:, None, :]                                    # (n, 1, ay)
        up = ((yf - ybf[:, None]) > d[None] + 0.5).long()             # (n, ay)
        top = (torch.arange(WIN, device=coords.device)[None] + up)[:, None, :].expand(n, WIN, WIN)

        def pick(col, shift):
            return torch.gather(col, 2, top + shift)

        fxc = fx[:, :, None]
        win = (((1.0 - fy) * pick(a, 0) + fy * pick(a, 1)) * (1.0 - fxc)
               + ((1.0 - fy) * pick(bcol, 0) + fy * pick(bcol, 1)) * fxc)
        out.append(win.reshape(n, WIN * WIN))
    return torch.cat(out, dim=1)
