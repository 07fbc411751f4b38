"""The evaluation metric suite: the device metrics of ``losses`` re-exported
(PSNR, mse, SSIM and LPIPS through ``recon_evaluate``, the EPE family
through ``flow_evaluate``, FWL) and the reference's standalone numpy
helpers (ref: utils/evaluate.py:8-42, loss.py:86-116). Counterpart of
cista_flow_tpu/metrics/__init__.py.
"""
from __future__ import annotations

import math

import numpy as np

from .losses import flow_evaluate, fwl_metric, psnr, recon_evaluate, ssim  # noqa: F401

__all__ = ["flow_evaluate", "fwl_metric", "psnr", "recon_evaluate", "ssim", "mse_np",
           "psnr_np", "epe_np"]


def mse_np(imgs1: np.ndarray, imgs2: np.ndarray) -> float:
    return float(np.mean((np.asarray(imgs1) - np.asarray(imgs2)) ** 2))


def psnr_np(imgs1: np.ndarray, imgs2: np.ndarray) -> float:
    """PSNR of images in [0, 1]; 100 where the mse is under 1e-10."""
    m = mse_np(imgs1, imgs2)
    if m < 1e-10:
        return 100.0
    return 20.0 * math.log10(1.0 / math.sqrt(m))


def epe_np(flow_pred: np.ndarray, flow_gt: np.ndarray,
           valid_gt: np.ndarray | None = None) -> dict:
    """EPE, the 1/3/5 px rates, F1 and the 3 px outlier rate (in %) of
    channel-last flows, over the pixels where ``valid_gt`` >= 0.5."""
    epe = np.sqrt(np.sum((flow_pred - flow_gt) ** 2, axis=-1)).ravel()
    mag = np.sqrt(np.sum(flow_gt ** 2, axis=-1)).ravel()
    outlier = (epe > 3.0).astype(np.float32)
    out = ((epe > 3.0) & ((epe / np.maximum(mag, 1e-12)) > 0.05)).astype(np.float32)
    if valid_gt is not None:
        val = valid_gt.ravel() >= 0.5
        epe, out, outlier = epe[val], out[val], outlier[val]
    return {
        "epe": float(epe.mean()),
        "1px": float((epe < 1).mean()),
        "3px": float((epe < 3).mean()),
        "5px": float((epe < 5).mean()),
        "F1": float(out.mean() * 100),
        "ol": float(outlier.mean() * 100),
    }
