"""Flow Warp Loss (FWL): the variance of the flow-compensated event image.

Counterpart of cista_flow_tpu/losses/fwl.py (ref: loss.py:27-83,
``voxel_warping_flow_loss``). Each voxel bin i is warped along
``i/(C-1) * flow`` (reversed: ``1 - i/(C-1)``), the warped bins are
summed, and the loss is the unbiased variance of that image. The FWL eval
metric is var(warped) / var(unwarped) (ref: test_wo_flow.py:161). The grid
keeps the reference's normalisation ``2x/W - 1`` (W, not W - 1) with
``align_corners=True`` and zero padding (ref: loss.py:62-66). No Pallas
kernel computes it in the JAX package; here it is ``F.grid_sample``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def voxel_warping_flow_loss(voxel: torch.Tensor, flow: torch.Tensor,
                            reverse_time: bool = False) -> torch.Tensor:
    """voxel (B, C, H, W); flow (B, 2, H, W). Returns the scalar variance."""
    if reverse_time:
        flow = -flow
    b, c, h, w = voxel.shape
    voxel, flow = voxel.float(), flow.float()
    xx = torch.arange(w, dtype=torch.float32, device=voxel.device)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=voxel.device)[None, :, None]
    inc = 1.0 / (c - 1.0)
    warped_sum = torch.zeros((b, 1, h, w), dtype=torch.float32, device=voxel.device)
    for i in range(c):
        ratio = (1.0 - i * inc) if reverse_time else i * inc
        gx = (2.0 * (xx + flow[:, 0] * ratio)) / w - 1.0
        gy = (2.0 * (yy + flow[:, 1] * ratio)) / h - 1.0
        warped_sum = warped_sum + F.grid_sample(
            voxel[:, i:i + 1], torch.stack([gx, gy], dim=-1), mode="bilinear",
            padding_mode="zeros", align_corners=True)
    return warped_sum.var()            # unbiased, as torch's .var() in the reference


def fwl_metric(voxel: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """FWL = var(warped along flow) / var(warped along zero flow)."""
    return voxel_warping_flow_loss(voxel, flow) / voxel_warping_flow_loss(
        voxel, torch.zeros_like(flow))
