"""K5: stride-1 3x3 conv C -> C with bias and optional relu (csrc/conv3x3.cu).

Counterpart of cista_flow_tpu/ops/pallas_conv.py ``conv3x3``. CUDA tensors
go to the kernel (or raise); CPU tensors take the plain version below.
``ops/conv.conv2d`` routes the square 64- and 128-channel convs here.

In bf16 at C % 64 == 0 the kernel is the tensor-core tile and takes the
weights repacked (``conv_tile.packed_weights``: once per weight tensor,
cast included); otherwise the direct tile takes them OIHW in x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .conv_tile import cast_cached, packed_weights
from .cuda_build import DTYPE_CODES, I, Kernel, P, check_cuda, on_cpu, stream_ptr

KERNEL = Kernel("conv3x3.cu", {"cista_conv3x3": [I, I, I, I, P, P, P, P, I, I, I, I, P]})
# the square widths ops/conv.conv2d routes here (pallas_conv.CHANNELS)
CHANNELS = (64, 128)


def uses_mma_tile(dtype: torch.dtype, c: int) -> bool:
    """Which inner product a conv of width ``c`` in ``dtype`` gets on the
    card: the tensor-core tile (bf16, C % 64 == 0) or the direct tile."""
    return dtype == torch.bfloat16 and c % 64 == 0


def conv3x3_plain(x, w, b=None, padding_mode: str = "zeros", relu: bool = False):
    if padding_mode == "reflect":
        y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), w, b)
    else:
        y = F.conv2d(x, w, b, padding=1)
    return torch.relu(y) if relu else y


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
            padding_mode: str = "zeros", relu: bool = False) -> torch.Tensor:
    """x (B, C, H, W); w (C, C, 3, 3); b (C,) or None. 'zeros' or 'reflect'
    padding of 1, resolved inside the kernel. Output in x's dtype (f32 or
    bf16; the weights are cast to it)."""
    if padding_mode not in ("zeros", "reflect"):
        raise ValueError(f"unknown padding_mode {padding_mode}")
    if on_cpu(x):
        return conv3x3_plain(x, w, b, padding_mode, relu)
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"conv3x3 kernel needs a non-empty NCHW tensor, got {tuple(x.shape)}")
    bsz, c, h, wd = x.shape
    if w.shape != (c, c, 3, 3) or (b is not None and b.shape != (c,)):
        raise ValueError(f"conv3x3 kernel: weight {tuple(w.shape)} is not "
                         f"({c}, {c}, 3, 3), or the bias is not ({c},)")
    if c % 16 != 0 or h < 2 or wd < 2:
        raise ValueError("conv3x3 kernel needs C % 16 == 0 and H, W >= 2")
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"conv3x3 kernel: dtype {x.dtype}")
    packed = uses_mma_tile(x.dtype, c)
    w = packed_weights(w, x.dtype) if packed else cast_cached(w, x.dtype)
    b = cast_cached(b, x.dtype) if b is not None else None
    check_cuda("conv3x3", (x.dtype,), x, w, *(() if b is None else (b,)))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        KERNEL.launch("cista_conv3x3", DTYPE_CODES[x.dtype],
                      int(padding_mode == "reflect"), int(relu), int(packed), x.data_ptr(),
                      w.data_ptr(), b.data_ptr() if b is not None else None,
                      out.data_ptr(), bsz, c, h, wd, stream_ptr(x.device))
    return out
