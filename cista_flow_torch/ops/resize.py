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


def resize_flow(flow: torch.Tensor, out_hw, scale: float | None = None) -> torch.Tensor:
    """A flow field (B, 2, H, W) resized to ``out_hw`` and its magnitude
    scaled, the reference's ``upflow{2,4,8,16}`` / ``downflow{2,4,8}``
    family (ref: DCEIFlow/utils/sample_utils.py:61-96; the JAX package's
    ``resize_flow``): bilinear with align_corners=True, times ``scale``
    (default ``out_h / in_h``) rounded to the flow's dtype, as JAX
    multiplies by ``jnp.asarray(scale, flow.dtype)``."""
    if scale is None:
        scale = out_hw[0] / flow.shape[2]
    scale = float(torch.tensor(scale, dtype=flow.dtype))
    return resize_bilinear(flow, out_hw, align_corners=True) * scale


def upflow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """``upflow{factor}``: align_corners=True resize, magnitudes x factor
    (ref: DCEIFlow/utils/sample_utils.py:61-78)."""
    _, _, h, w = flow.shape
    return resize_flow(flow, (h * factor, w * factor), scale=float(factor))


def downflow(flow: torch.Tensor, factor: int) -> torch.Tensor:
    """``downflow{factor}``: to (H // factor, W // factor), magnitudes /
    factor (ref: DCEIFlow/utils/sample_utils.py:81-91)."""
    _, _, h, w = flow.shape
    return resize_flow(flow, (h // factor, w // factor), scale=1.0 / factor)


def interpolate_scale(x: torch.Tensor, scale_factor: float,
                      align_corners: bool) -> torch.Tensor:
    """``F.interpolate(x, scale_factor=...)``: output size floor(in*scale)."""
    _, _, h, w = x.shape
    return resize_bilinear(x, (int(h * scale_factor), int(w * scale_factor)),
                           align_corners=align_corners)
