"""Reconstruction metrics (counterpart of cista_flow_tpu/losses/recon.py
``psnr`` and ``recon_evaluate``; ref: loss.py:15-24, 316-328). The
reference also reports LPIPS when its weights are present; none are, so
it is not computed."""
from __future__ import annotations

import torch

from .ssim import ssim


def psnr(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """ref: loss.py:15-24; 100 dB where the mse is under 1e-10."""
    mse = torch.mean((img1 - img2) ** 2)
    return torch.where(mse < 1e-10, torch.full_like(mse, 100.0),
                       20.0 * torch.log10(data_range / torch.sqrt(mse)))


def recon_evaluate(rec_img: torch.Tensor, target_img: torch.Tensor) -> dict:
    """{'mse', 'psnr', 'ssim'} of NCHW images."""
    return {"mse": torch.mean((rec_img - target_img) ** 2),
            "psnr": psnr(rec_img, target_img),
            "ssim": ssim(rec_img, target_img)}

