"""K6: the tied ISTA loop in one cooperative launch (csrc/ista_loop.cu).

Counterpart of cista_flow_tpu/ops/pallas_ista.py ``fused_ista``: the same
function as K3a (``cuda_ista2.fused_ista_v2``), but the ``depth`` iterations
run inside one persistent kernel, separated by grid-wide barriers, with z
and x1 - D(z) in scratch allocated here. CPU tensors take K3a's plain
version, ``ista_loop_plain``.

The inner product goes by shape, as K3a's does (``cuda_conv.uses_mma_tile``):
in bf16 at C % 64 == 0 the wgmma tile, on channel-grouped scratch
(``conv_tile.to_grouped``'s layout) with the weights repacked once per
weight tensor (``conv_tile.packed_weights``), the moves from and to NCHW
inside the same launch; in f32 and at other widths the direct CUDA-core
tile on NCHW. Either way one call is one launch.
"""
from __future__ import annotations

import torch

from .autograd import refuse_grad
from .conv_tile import packed_weights
from .cuda_build import DTYPE_CODES, I, Kernel, P, on_cpu
from .cuda_conv import uses_mma_tile
from .cuda_ista2 import check_ista_args, ista_loop_plain

KERNEL = Kernel("ista_loop.cu", {"cista_ista_loop": [I, P, P, P, P, P, P, P, P, P,
                                                     I, I, I, I, I, P],
                                 "cista_ista_loop_mma": [P, P, P, P, P, P, P, P, P, P, P,
                                                         I, I, I, I, I, P]})


def fused_ista(w, x1: torch.Tensor, z: torch.Tensor, depth: int) -> torch.Tensor:
    """w = (dw (C, 2C, 3, 3), db (C,), pw (2C, C, 3, 3), pb (2C,), lam (2C,));
    x1 (B, C, H, W); z (B, 2C, H, W). Returns z after ``depth`` iterations;
    ``z`` is not modified. No backward: on the card it raises where an input
    requires a gradient."""
    if on_cpu(x1):
        return ista_loop_plain(w, x1, z, depth)
    refuse_grad("fused_ista (K6)", *w, x1, z)
    check_ista_args("fused_ista", w, x1, z, depth)
    dw, db, pw, pb, lam = w
    b, c, h, wd = x1.shape
    zn = torch.empty_like(z)           # the result
    if uses_mma_tile(x1.dtype, c):
        grouped = dict(dtype=x1.dtype, device=x1.device)
        x1g = torch.empty((b, c // 8, h, wd, 8), **grouped)
        xd = torch.empty_like(x1g)                                # x1 - D(z)
        zg = torch.empty((b, 2 * c // 8, h, wd, 8), **grouped)    # z, updated in place
        KERNEL.launch("cista_ista_loop_mma", x1.data_ptr(), z.data_ptr(),
                      packed_weights(dw, x1.dtype).data_ptr(), db.data_ptr(),
                      packed_weights(pw, x1.dtype).data_ptr(), pb.data_ptr(),
                      lam.data_ptr(), x1g.data_ptr(), xd.data_ptr(), zg.data_ptr(),
                      zn.data_ptr(), b, c, h, wd, depth, device=x1.device)
    else:
        xd = torch.empty_like(x1)  # scratch: x1 - D(z); zn updated in place
        KERNEL.launch("cista_ista_loop", DTYPE_CODES[x1.dtype], x1.data_ptr(),
                      z.data_ptr(), dw.data_ptr(), db.data_ptr(), pw.data_ptr(),
                      pb.data_ptr(), lam.data_ptr(), xd.data_ptr(), zn.data_ptr(),
                      b, c, h, wd, depth, device=x1.device)
    return zn
