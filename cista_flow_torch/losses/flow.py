"""Flow eval metrics (counterpart of cista_flow_tpu/losses/flow.py
``validity_mask`` and ``flow_evaluate``; ref: loss.py:237-265, 398). The
warps are the port's ``ops.warp.frame_warp``, with the reference's
``2*(x/W - 0.5)`` normalization; on CPU tensors that is the plain version.
Tensors are NCHW; flows (B, 2, H, W) f32."""
from __future__ import annotations

import torch

from ..ops.warp import frame_warp

MAX_FLOW = 400.0


def validity_mask(gt_img0, gt_img1, gt_flow, warp_mode="forward"):
    """Soft validity exp(-50 * (warp(I0, gt_flow) - I1)^2) per pixel."""
    warped = frame_warp(gt_img0, gt_flow, mode=warp_mode)
    return torch.exp(-50.0 * (warped - gt_img1) ** 2)


def flow_evaluate(flow_final, batch_target, cfg) -> dict:
    """Photometric loss, masked EPE, >1/3/5 px outlier rates and the
    KITTI-style out% (``FlowL1LossDict.evaluate``). ``batch_target``:
    gt_img0, gt_img1 (B, 1, H, W), gt_flow (B, 2, H, W), optionally
    flow_valid."""
    if "flow_valid" in batch_target:
        valid_original = batch_target["flow_valid"]
    else:
        valid_original = validity_mask(batch_target["gt_img0"], batch_target["gt_img1"],
                                       batch_target["gt_flow"], cfg.warp_mode)
    gt_flow = batch_target["gt_flow"]
    mag = torch.sqrt(torch.sum(gt_flow ** 2, dim=1, keepdim=True))
    valid = valid_original * (mag < MAX_FLOW).to(gt_flow.dtype)

    photo = torch.mean(torch.abs(
        frame_warp(batch_target["gt_img0"], flow_final, cfg.warp_mode)
        - batch_target["gt_img1"]))
    epe = torch.sqrt(torch.sum(valid * (flow_final - gt_flow) ** 2, dim=1))
    out = ((epe > 3.0) & ((epe / mag[:, 0]) > 0.05)).float()
    ok = valid[:, 0] > 0
    cnt = torch.clamp(torch.sum(ok), min=1)

    def masked_mean(x):
        return torch.sum(torch.where(ok, x, torch.zeros_like(x))) / cnt

    return {"photo_loss": photo,
            "epe": masked_mean(epe),
            "1px": masked_mean((epe > 1).float()),
            "3px": masked_mean((epe > 3).float()),
            "5px": masked_mean((epe > 5).float()),
            "out": masked_mean(out) * 100.0}
