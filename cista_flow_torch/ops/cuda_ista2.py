"""K3 and K3a: the tied ISTA loop, with and without the Dg conv (csrc/ista.cu).

Counterpart of cista_flow_tpu/ops/pallas_ista2.py: ``fused_ista_dg`` (K3) is
``depth`` iterations of z <- softshrink(P(x1 - D(z)) + z, lambda), then
rec = relu(Dg(z)); ``fused_ista_v2`` (K3a) is the loop alone. All convs are
3x3 reflect-padded. On the card one call is 2*depth (+ 1) launches of one
conv kernel with the epilogues fused; each wrapper's launch count counts
its calls. CPU tensors take the plain versions.

In bf16 at C % 64 == 0 the launches are the tensor-core tile: x1, x1 - D(z)
and the running z are private to the call, so they are kept channel-grouped
(``conv_tile.to_grouped``) between the launches and converted at the call's
two ends (two small layout kernels in the same source), and the weights go in repacked (``conv_tile.packed_weights``, once
per weight tensor). Otherwise the direct tile works on NCHW and OIHW.
"""
from __future__ import annotations

import torch

from .conv import conv2d
from .conv_tile import packed_weights
from .cuda_build import (DTYPE_CODES, I, Kernel, P, SharedKernel, check_cuda, on_cpu,
                         stream_ptr)
from .cuda_conv import uses_mma_tile

KERNEL = Kernel("ista.cu", {"cista_ista_conv": [I, I, P, P, P, P, P, P,
                                                I, I, I, I, I, P],
                            "cista_ista_conv_mma": [I, P, P, P, P, P, P,
                                                    I, I, I, I, I, P],
                            "cista_regroup": [I, P, P, I, I, I, I, P]})
KERNEL_V2 = SharedKernel(KERNEL)        # K3a: the same source, its own count
MODE_D, MODE_P, MODE_G = 0, 1, 2


def softshrink(x: torch.Tensor, lambd: torch.Tensor) -> torch.Tensor:
    """ISTA proximal op: relu(x-l) - relu(-x-l) (ref: e2v/base_layers.py:11)."""
    return torch.relu(x - lambd) - torch.relu(-x - lambd)


def ista_iteration_plain(w, x1, z):
    """One tied ISTA step; ``w`` = (dw, db, pw, pb, lam) with lam (2C,)."""
    dw, db, pw, pb, lam = w
    tmp = conv2d(z, dw, db, padding=1, padding_mode="reflect")
    x = conv2d(x1 - tmp, pw, pb, padding=1, padding_mode="reflect")
    return softshrink(x + z, lam[None, :, None, None])


def ista_loop_plain(w, x1, z, depth: int):
    for _ in range(depth):
        z = ista_iteration_plain(w, x1, z)
    return z


def fused_ista_dg_plain(w, gw, gb, x1, z, depth: int):
    z = ista_loop_plain(w, x1, z, depth)
    rec = torch.relu(conv2d(z, gw, gb, padding=1, padding_mode="reflect"))
    return z, rec


def check_ista_args(name: str, w, x1: torch.Tensor, z: torch.Tensor, depth: int):
    """What every ISTA kernel needs of (w, x1, z, depth); raises otherwise."""
    dw, db, pw, pb, lam = w
    b, c, h, wd = x1.shape
    if z.shape != (b, 2 * c, h, wd) or dw.shape != (c, 2 * c, 3, 3) \
            or pw.shape != (2 * c, c, 3, 3) or db.shape != (c,) \
            or pb.shape != (2 * c,) or lam.shape != (2 * c,) or depth < 1:
        raise ValueError(f"{name}: shapes do not match x1 (B, C, H, W), "
                         "z (B, 2C, H, W), D (C, 2C, 3, 3), P (2C, C, 3, 3)")
    if c % 16 != 0 or h < 2 or wd < 2:
        raise ValueError(f"{name} needs C % 16 == 0 and H, W >= 2")
    if x1.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {x1.dtype}")
    check_cuda(name, (x1.dtype,), x1, z, dw, db, pw, pb, lam)


def _conv(kernel, mode, src, wt, bias, aux, lam, out):
    b, cin, h, wd = src.shape
    kernel.call("cista_ista_conv", mode, DTYPE_CODES[src.dtype], src.data_ptr(),
                wt.data_ptr(), bias.data_ptr(),
                aux.data_ptr() if aux is not None else None, lam.data_ptr(),
                out.data_ptr(), b, cin, wt.shape[0], h, wd, stream_ptr(src.device))


def _loop(kernel, w, x1, z, depth):
    """2*depth launches; returns a new z (the input is not modified)."""
    dw, db, pw, pb, lam = w
    xd = torch.empty_like(x1)          # x1 - D(z)
    zn = torch.empty_like(z)           # z, updated in place after iteration 1
    zin = z
    for _ in range(depth):
        _conv(kernel, MODE_D, zin, dw, db, x1, lam, xd)
        _conv(kernel, MODE_P, xd, pw, pb, zin, lam, zn)
        zin = zn
    return zn


def _conv_mma(kernel, mode, src, packed, bias, aux, lam, out):
    """One launch of the tensor-core tile; ``src`` and ``aux`` grouped."""
    b, groups, h, wd, _ = src.shape
    kernel.call("cista_ista_conv_mma", mode, src.data_ptr(), packed.data_ptr(),
                bias.data_ptr(), aux.data_ptr() if aux is not None else None,
                lam.data_ptr(), out.data_ptr(), b, groups * 8, packed.shape[2], h, wd,
                stream_ptr(src.device))


def _to_grouped(kernel, x):
    """``conv_tile.to_grouped`` of a bf16 NCHW tensor on the card."""
    b, c, h, wd = x.shape
    out = torch.empty((b, c // 8, h, wd, 8), dtype=x.dtype, device=x.device)
    kernel.call("cista_regroup", 1, x.data_ptr(), out.data_ptr(), b, c, h, wd,
                stream_ptr(x.device))
    return out


def _from_grouped(kernel, g):
    """``conv_tile.from_grouped`` of a bf16 grouped tensor on the card."""
    b, groups, h, wd, _ = g.shape
    out = torch.empty((b, groups * 8, h, wd), dtype=g.dtype, device=g.device)
    kernel.call("cista_regroup", 0, g.data_ptr(), out.data_ptr(), b, groups * 8, h, wd,
                stream_ptr(g.device))
    return out


def _loop_mma(kernel, w, x1, z, depth):
    """2*depth launches on grouped arrays; returns z grouped (a new array)."""
    dw, db, pw, pb, lam = w
    dwp, pwp = packed_weights(dw, x1.dtype), packed_weights(pw, x1.dtype)
    x1g, zg = _to_grouped(kernel, x1), _to_grouped(kernel, z)
    xd = torch.empty_like(x1g)         # x1 - D(z)
    for _ in range(depth):
        _conv_mma(kernel, MODE_D, zg, dwp, db, x1g, lam, xd)
        _conv_mma(kernel, MODE_P, xd, pwp, pb, zg, lam, zg)     # z in place
    return zg


def fused_ista_v2(w, x1: torch.Tensor, z: torch.Tensor, depth: int) -> torch.Tensor:
    """K3a. w = (dw (C, 2C, 3, 3), db (C,), pw (2C, C, 3, 3), pb (2C,),
    lam (2C,)); x1 (B, C, H, W); z (B, 2C, H, W). Returns z after ``depth``
    iterations; ``z`` is not modified."""
    if on_cpu(x1):
        return ista_loop_plain(w, x1, z, depth)
    check_ista_args("fused_ista_v2", w, x1, z, depth)
    with torch.cuda.device(x1.device):
        if uses_mma_tile(x1.dtype, x1.shape[1]):
            zn = _from_grouped(KERNEL_V2, _loop_mma(KERNEL_V2, w, x1, z, depth))
        else:
            zn = _loop(KERNEL_V2, w, x1, z, depth)
    KERNEL_V2.launches += 1
    return zn


def fused_ista_dg(w, gw, gb, x1: torch.Tensor, z: torch.Tensor, depth: int):
    """K3. ``w``, ``x1``, ``z`` as ``fused_ista_v2``; gw (C, 2C, 3, 3), gb
    (C,). Returns (z_final, rec). ``z`` is not modified."""
    if on_cpu(x1):
        return fused_ista_dg_plain(w, gw, gb, x1, z, depth)
    check_ista_args("fused_ista_dg", w, x1, z, depth)
    if gw.shape != w[0].shape or gb.shape != w[1].shape:
        raise ValueError("fused_ista_dg: Dg must have D's shapes, (C, 2C, 3, 3) and (C,)")
    check_cuda("fused_ista_dg", (x1.dtype,), gw, gb, x1)
    rec = torch.empty_like(x1)
    with torch.cuda.device(x1.device):
        if uses_mma_tile(x1.dtype, x1.shape[1]):
            zg = _loop_mma(KERNEL, w, x1, z, depth)
            _conv_mma(KERNEL, MODE_G, zg, packed_weights(gw, x1.dtype), gb, None, w[4], rec)
            zn = _from_grouped(KERNEL, zg)
        else:
            zn = _loop(KERNEL, w, x1, z, depth)
            _conv(KERNEL, MODE_G, zn, gw, gb, None, w[4], rec)
    KERNEL.launches += 1
    return zn, rec
