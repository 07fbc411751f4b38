"""The sequence flow loss and the flow eval metrics (counterpart of
cista_flow_tpu/losses/flow.py; ref: loss.py:119-303, 398): a gamma-weighted,
validity-masked L1 over the GRU iterations plus a photometric warp term at
every iteration, the x10 pseudo-feature L1 of DCEIFlow, and the eval's EPE
and outlier rates. The warps are the port's ``ops.warp.frame_warp`` (kernel
K2 on the card, differentiable), with the reference's ``2*(x/W - 0.5)``
normalization. Tensors are NCHW; flows (B, 2, H, W) f32."""
from __future__ import annotations

import torch

from ..ops.pad import ImagePadder
from ..ops.resize import resize_bilinear
from ..ops.warp import frame_warp

GAMMA = 0.8
MAX_FLOW = 400.0


def validity_mask(gt_img0, gt_img1, gt_flow, warp_mode="forward"):
    """Soft validity exp(-50 * (warp(I0, gt_flow) - I1)^2) per pixel."""
    warped = frame_warp(gt_img0, gt_flow, mode=warp_mode)
    return torch.exp(-50.0 * (warped - gt_img1) ** 2)


def _seq_loss(flow_preds, flow_gt, gt_img0, gt_img1, valid_original, warp_mode):
    """flow_preds: (iters, B, 2, H, W) or a list of (B, 2, H, W) (in any
    float dtype; the loss runs in f32), at the (padded) resolution of
    ``flow_gt`` or lower; a lower one takes the
    targets resized to it (align_corners), and its EPE is taken there too
    (the JAX package's ``_seq_loss`` subtracts the full-resolution target
    from the last prediction and raises at a lower one). Returns (loss,
    metrics)."""
    n = len(flow_preds)
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1, keepdim=True))
    valid = valid_original * (mag < MAX_FLOW).to(flow_gt.dtype)
    same_res = tuple(flow_preds[0].shape[2:]) == tuple(flow_gt.shape[2:])
    loss = 0.0
    for i in range(n):
        w = GAMMA ** (n - i - 1)
        pred = flow_preds[i].float()        # IDNet's are in its compute dtype
        if same_res:
            i_loss = torch.abs(pred - flow_gt)
            photo = torch.abs(frame_warp(gt_img0, pred, mode=warp_mode) - gt_img1)
            loss = loss + w * torch.mean(valid * i_loss) + w * torch.mean(photo)
        else:
            hw = pred.shape[2:]
            s_gt = resize_bilinear(flow_gt, hw, align_corners=True)
            s_i0 = resize_bilinear(gt_img0, hw, align_corners=True)
            s_i1 = resize_bilinear(gt_img1, hw, align_corners=True)
            i_loss = torch.abs(pred - s_gt)
            photo = torch.abs(frame_warp(s_i0, pred, mode=warp_mode) - s_i1)
            s_mag = torch.sqrt(torch.sum(s_gt ** 2, dim=1, keepdim=True))
            s_valid = (resize_bilinear(valid_original, hw, align_corners=True)
                       * (s_mag < MAX_FLOW).to(flow_gt.dtype))
            loss = loss + w * torch.mean(s_valid * i_loss) + w * torch.mean(photo)
    if not same_res:
        flow_gt, valid = s_gt, s_valid

    epe = torch.sqrt(torch.sum(valid * (flow_preds[-1].float() - flow_gt) ** 2, dim=1))
    ok = valid[:, 0] > 0
    mean_epe = (torch.sum(torch.where(ok, epe, torch.zeros_like(epe)))
                / torch.clamp(torch.sum(ok), min=1))
    return loss, {"flow_l1loss": loss, "epe": mean_epe}


def flow_sequence_loss(batch_flow, batch_target, cfg, is_bi: bool = False):
    """``FlowL1LossDict.forward`` (ref: loss.py:267-303). ``batch_target``:
    gt_img0, gt_img1, gt_flow, valid (+ gt_flow_bw, valid_bw with
    ``is_bi``) at the unpadded resolution, padded here as the reference
    does. Returns (loss, metrics)."""
    padder = ImagePadder(cfg.image_dim, min_size=32)
    gt_img0 = padder.pad(batch_target["gt_img0"])
    gt_img1 = padder.pad(batch_target["gt_img1"])
    flow_gt = padder.pad(batch_target["gt_flow"])
    valid = padder.pad(batch_target["valid"])

    loss_fw, metrics = _seq_loss(batch_flow["flow_preds"], flow_gt, gt_img0,
                                 gt_img1, valid, cfg.warp_mode)
    if batch_flow.get("fmap2_pseudo") is not None:
        pseudo = 10.0 * torch.mean(torch.abs(batch_flow["fmap2_pseudo"]
                                             - batch_flow["fmap2_gt"]))
        loss_fw = loss_fw + pseudo
        metrics["pseudo"] = pseudo
        metrics["flow_l1loss"] = loss_fw
    if not is_bi:
        return loss_fw, metrics

    flow_gt_bw = padder.pad(batch_target["gt_flow_bw"])
    valid_bw = padder.pad(batch_target["valid_bw"])
    loss_bw, _ = _seq_loss(batch_flow["flow_preds_bw"], flow_gt_bw, gt_img1,
                           gt_img0, valid_bw, cfg.warp_mode)
    if batch_flow.get("fmap1_pseudo") is not None:
        loss_bw = loss_bw + 10.0 * torch.mean(torch.abs(batch_flow["fmap1_pseudo"]
                                                        - batch_flow["fmap1_gt"]))
    total = 0.5 * (loss_fw + loss_bw)
    metrics["flow_l1loss"] = total
    return total, metrics


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
