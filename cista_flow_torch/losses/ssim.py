"""SSIM as ``pytorch_msssim`` computes it (the reference's
``SSIM(data_range=1, size_average=True, channel=1)``, ref: loss.py:314):
an 11-tap Gaussian window with sigma 1.5, valid mode (the map shrinks by
10 pixels per axis), K1 = 0.01, K2 = 0.03, the mean of the map.

Counterpart of cista_flow_tpu/losses/ssim.py. The separable blur is two
products with constant banded matrices in f32: the variances come from
E[x^2] - mu^2, and a reduced-precision blur (TF32 or bf16 products) leaves
residues larger than C2 on flat images.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(win_size) - win_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _blur_matrix(size: int, win_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    """(size - win + 1, size) banded matrix of the 1D Gaussian."""
    k = _gaussian_kernel(win_size, sigma)
    m = np.zeros((size - win_size + 1, size), np.float32)
    for i in range(size - win_size + 1):
        m[i, i:i + win_size] = k
    return m


def _blur(x: torch.Tensor, win_size: int, sigma: float) -> torch.Tensor:
    """Valid-mode separable Gaussian blur of (..., H, W) in f32."""
    kh = torch.from_numpy(_blur_matrix(x.shape[-2], win_size, sigma)).to(x.device)
    kw = torch.from_numpy(_blur_matrix(x.shape[-1], win_size, sigma)).to(x.device)
    return torch.matmul(torch.matmul(kh, x), kw.T)


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over the batch of NCHW images."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    x = img1.float()
    y = img2.float()
    mu1 = _blur(x, win_size, sigma)
    mu2 = _blur(y, win_size, sigma)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _blur(x * x, win_size, sigma) - mu1_sq
    sigma2_sq = _blur(y * y, win_size, sigma) - mu2_sq
    sigma12 = _blur(x * y, win_size, sigma) - mu12
    cs = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    m = ((2 * mu12 + c1) / (mu1_sq + mu2_sq + c1)) * cs
    return m.mean()
