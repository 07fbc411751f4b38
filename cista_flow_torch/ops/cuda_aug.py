"""K2: the reflection warp, fused into one kernel (csrc/warp.cu).

Counterpart of cista_flow_tpu/ops/pallas_aug.py. The TPU kernel
(``build_aug``) stages the four bilinear corner rows of a flat image so
that XLA can do one row gather; on Hopper the kernel computes the warp the
staging serves (grid, reflect fold, 4-corner gather, f32 blend, and the
reference's zero-flow select through an optional device-side gate) and the
staged array is never built. ``build_aug`` itself is kept below as a plain
function so that the TPU kernel's own contract stays checkable.
"""
from __future__ import annotations

import torch

from . import warp as _warp
from .cuda_build import DTYPE_CODES, F, I, Kernel, P, check_cuda, on_cpu, stream_ptr

KERNEL = Kernel("warp.cu", {"cista_warp_reflect": [I, P, P, P, P, I, I, I, I, F, P]})


def build_aug(flat: torch.Tensor, w: int) -> torch.Tensor:
    """(N, C) -> (N, 4C) rows [x[n] | x[n+1] | x[n+W] | x[n+W+1]], zeros
    past N (pallas_aug.build_aug_xla)."""
    n, c = flat.shape
    flatp = torch.cat([flat, flat.new_zeros((w + 1, c))], dim=0)
    return torch.cat([flatp[off:n + off] for off in (0, 1, w, w + 1)], dim=-1)


def warp_reflect_plain(img: torch.Tensor, flow: torch.Tensor, sign: float,
                       gate: torch.Tensor | None = None) -> torch.Tensor:
    """Sample NCHW ``img`` at ``grid + sign * flow`` with the reference's
    2*(x/W - 0.5) normalization, reflection padding, align_corners=True;
    where the 0-dim bool ``gate`` is false, ``img`` itself."""
    gx, gy = _warp.frame_warp_coords(flow, sign)
    out = _warp.sample_pixel_coords(img, gx, gy, padding_mode="reflection")
    return out if gate is None else torch.where(gate, out, img)


def warp_reflect(img: torch.Tensor, flow: torch.Tensor, sign: float,
                 gate: torch.Tensor | None = None) -> torch.Tensor:
    """img: (B, C, H, W); flow: (B, 2, H, W) f32 pixel flow. ``gate``: None,
    or a 0-dim bool tensor on img's device, read by the kernel on the device
    (no host sync): where it is false the result is a copy of ``img``, else
    the warp. The reference's zero-flow short-circuit passes
    ``torch.any(flow != 0)``; a warp at zero flow is not the identity under
    this normalization, so the gate really selects."""
    if gate is not None and (gate.shape != () or gate.dtype != torch.bool):
        raise ValueError(f"warp gate must be a 0-dim bool tensor, got "
                         f"{tuple(gate.shape)} {gate.dtype}")
    if on_cpu(img):
        return warp_reflect_plain(img, flow, sign, gate)
    b, c, h, w = img.shape
    if flow.shape != (b, 2, h, w) or flow.dtype != torch.float32:
        raise ValueError(f"warp kernel needs f32 flow (B, 2, H, W), got "
                         f"{tuple(flow.shape)} {flow.dtype}")
    check_cuda("warp_reflect", DTYPE_CODES, img, flow)
    if gate is not None and gate.device != img.device:
        raise ValueError(f"warp_reflect: gate on {gate.device}, image on {img.device}")
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        KERNEL.launch("cista_warp_reflect", DTYPE_CODES[img.dtype], img.data_ptr(),
                      flow.data_ptr(), None if gate is None else gate.data_ptr(),
                      out.data_ptr(), b, c, h, w, float(sign), stream_ptr(img.device))
    return out
