"""Bilinear resizes with ``F.interpolate`` semantics (NCHW).

Counterpart of cista_flow_tpu/ops/resize.py, whose constant-matrix
contractions are a TPU formulation of these same interpolations. Both
align_corners conventions occur in the reference: flow resizes use True
(ref: DCEIFlow/utils/sample_utils.py:61-96), the CISTA decoder's x2
upsample False (ref: e2v/base_layers.py:200). Computed in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False,
                    reflect_pad: int = 0) -> torch.Tensor:
    """Resize to ``out_hw`` = (H_out, W_out); ``reflect_pad`` reflect-pads
    the result by that many pixels per side (the decoder's conv input)."""
    h_out, w_out = int(out_hw[0]), int(out_hw[1])
    y = x.float()
    if (h_out, w_out) != tuple(x.shape[2:]):
        y = F.interpolate(y, size=(h_out, w_out), mode="bilinear",
                          align_corners=align_corners)
    if reflect_pad:
        y = F.pad(y, (reflect_pad,) * 4, mode="reflect")
    return y.to(x.dtype)


def upflow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """``upflow{factor}``: align_corners=True resize, magnitudes x factor
    (ref: DCEIFlow/utils/sample_utils.py:61-78)."""
    _, _, h, w = flow.shape
    return resize_bilinear(flow, (h * factor, w * factor),
                           align_corners=True) * float(factor)


def interpolate_scale(x: torch.Tensor, scale_factor: float,
                      align_corners: bool) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=...)``: output size floor(in*scale)."""
    _, _, h, w = x.shape
    return resize_bilinear(x, (int(h * scale_factor), int(w * scale_factor)),
                           align_corners=align_corners)
