"""K3: the tied ISTA loop + the Dg conv (csrc/ista.cu).

Counterpart of cista_flow_tpu/ops/pallas_ista2.py ``fused_ista_dg``:
``depth`` iterations of z <- softshrink(P(x1 - D(z)) + z, lambda), then
rec = relu(Dg(z)); all convs 3x3 reflect-padded. On the card one call is
2*depth + 1 launches of one conv kernel with the epilogues fused; the
launch count below counts calls. CPU tensors take the plain version.
"""
from __future__ import annotations

import torch

from .conv import conv2d
from .cuda_build import DTYPE_CODES, I, Kernel, P, check_cuda, on_cpu, stream_ptr

KERNEL = Kernel("ista.cu", {"cista_ista_conv": [I, I, P, P, P, P, P, P,
                                                I, I, I, I, I, P]})
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


def fused_ista_dg_plain(w, gw, gb, x1, z, depth: int):
    for _ in range(depth):
        z = ista_iteration_plain(w, x1, z)
    rec = torch.relu(conv2d(z, gw, gb, padding=1, padding_mode="reflect"))
    return z, rec


def fused_ista_dg(w, gw, gb, x1: torch.Tensor, z: torch.Tensor, depth: int):
    """w = (dw (C, 2C, 3, 3), db (C,), pw (2C, C, 3, 3), pb (2C,), lam (2C,));
    gw (C, 2C, 3, 3), gb (C,); x1 (B, C, H, W); z (B, 2C, H, W).
    Returns (z_final, rec). ``z`` is not modified."""
    if on_cpu(x1):
        return fused_ista_dg_plain(w, gw, gb, x1, z, depth)
    dw, db, pw, pb, lam = w
    b, c, h, wd = x1.shape
    if z.shape != (b, 2 * c, h, wd) or dw.shape != (c, 2 * c, 3, 3) \
            or pw.shape != (2 * c, c, 3, 3) or gw.shape != (c, 2 * c, 3, 3) \
            or lam.shape != (2 * c,) or depth < 1:
        raise ValueError("ista kernel: shapes do not match x1 (B, C, H, W), "
                         "z (B, 2C, H, W), D/Dg (C, 2C, 3, 3), P (2C, C, 3, 3)")
    if c % 16 != 0 or h < 2 or wd < 2:
        raise ValueError("ista kernel needs C % 16 == 0 and H, W >= 2")
    if x1.dtype not in DTYPE_CODES:
        raise ValueError(f"ista kernel: dtype {x1.dtype}")
    check_cuda("fused_ista_dg", (x1.dtype,), x1, z, dw, db, pw, pb, lam, gw, gb)
    code = DTYPE_CODES[x1.dtype]
    xd = torch.empty_like(x1)          # x1 - D(z)
    zn = torch.empty_like(z)           # z, updated in place after iteration 1
    rec = torch.empty_like(x1)
    stream = stream_ptr(x1.device)

    def conv(mode, src, wt, bias, aux, out, cin, cout):
        KERNEL.call("cista_ista_conv", mode, code, src.data_ptr(), wt.data_ptr(),
                    bias.data_ptr(), aux.data_ptr() if aux is not None else None,
                    lam.data_ptr(), out.data_ptr(), b, cin, cout, h, wd, stream)

    with torch.cuda.device(x1.device):
        zin = z
        for _ in range(depth):
            conv(MODE_D, zin, dw, db, x1, xd, 2 * c, c)
            conv(MODE_P, xd, pw, pb, zin, zn, c, 2 * c)
            zin = zn
        conv(MODE_G, zn, gw, gb, None, rec, 2 * c, c)
    KERNEL.launches += 1
    return zn, rec
