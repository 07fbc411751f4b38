"""The reconstruction loss, the combined flow + reconstruction loss and the
reconstruction metrics (counterpart of cista_flow_tpu/losses/recon.py; ref:
loss.py:15-24, 306-411). With ``lpips_params`` (``losses/lpips.py``) the
reconstruction loss and metrics add LPIPS, as the reference does when its
weights are present."""
from __future__ import annotations

import torch

from ..ops.warp import frame_warp
from . import lpips as lpips_mod
from .flow import flow_sequence_loss, validity_mask
from .ssim import ssim


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """ref: loss.py:15-24; 100 dB where the mse is under 1e-10."""
    mse = torch.mean((img1 - img2) ** 2)
    return torch.where(mse < 1e-10, torch.full_like(mse, 100.0),
                       20.0 * torch.log10(data_range / torch.sqrt(mse)))


def recon_evaluate(rec_img: torch.Tensor, target_img: torch.Tensor,
                   lpips_params=None) -> dict:
    """{'mse', 'psnr', 'ssim'} of NCHW images, and 'lpips' with
    ``lpips_params`` (ref: loss.py:316-328)."""
    metrics = {"mse": torch.mean((rec_img - target_img) ** 2),
               "psnr": psnr(rec_img, target_img),
               "ssim": ssim(rec_img, target_img)}
    if lpips_params is not None:
        metrics["lpips"] = lpips_mod.lpips(lpips_params, rec_img, target_img, normalize=True)
    return metrics


def recon_loss(out, rec_img0, batch_target, cfg, lpips_params=None,
               is_loss_consis=True):
    """``ReconLoss.forward`` (ref: loss.py:331-354): LPIPS (with
    ``lpips_params``) + L1 + (1 - SSIM), plus 5x the ``valid``-masked L1
    between ``out`` and ``rec_img0`` warped along gt_flow where
    ``is_loss_consis`` (a bool, or a 0-dim tensor that gates the term by a
    multiply). Returns (loss, metrics)."""
    gt = batch_target["gt_img1"]
    if isinstance(is_loss_consis, bool) and not is_loss_consis:
        consis = 0.0
    else:
        warped_prev = frame_warp(rec_img0, batch_target["gt_flow"], cfg.warp_mode)
        consis = 5.0 * torch.mean(batch_target["valid"] * torch.abs(warped_prev - out))
        consis = consis * torch.as_tensor(is_loss_consis, dtype=consis.dtype,
                                          device=consis.device)
    l1 = torch.mean(torch.abs(out - gt))
    ssim_loss = 1.0 - ssim(out, gt, data_range=1.0)
    lp = (lpips_mod.lpips(lpips_params, out, gt, normalize=True)
          if lpips_params is not None else 0.0)
    loss = lp + l1 + ssim_loss + consis
    return loss, {"LPIPS": lp, "L1": l1, "SSIM": ssim_loss, "loss_consistency": consis,
                  "loss_rec": loss - consis, "loss_rec_all": loss}


def flow_recon_loss(out, rec_img0, batch_flow, batch_target, cfg, loss_mode: str,
                    lpips_params=None, is_loss_consis=True):
    """``FlowReconLoss.forward`` (ref: loss.py:396-411): the soft validity
    mask of the GT flow, then the reconstruction loss ('rec'), the sequence
    flow loss ('flow') or their sum ('both'). A scalar."""
    if loss_mode not in ("rec", "flow", "both"):
        raise ValueError(f"loss_mode {loss_mode!r} is not rec, flow or both")
    batch_target = dict(batch_target)
    batch_target["valid"] = validity_mask(batch_target["gt_img0"], batch_target["gt_img1"],
                                          batch_target["gt_flow"], cfg.warp_mode)
    loss = 0.0
    if loss_mode in ("rec", "both"):
        loss = loss + recon_loss(out, rec_img0, batch_target, cfg, lpips_params,
                                 is_loss_consis)[0]
    if loss_mode in ("flow", "both"):
        if cfg.is_bi:
            batch_target["valid_bw"] = validity_mask(
                batch_target["gt_img1"], batch_target["gt_img0"],
                batch_target["gt_flow_bw"], cfg.warp_mode)
        loss = loss + flow_sequence_loss(batch_flow, batch_target, cfg, is_bi=cfg.is_bi)[0]
    return loss
