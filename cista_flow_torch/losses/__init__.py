"""Eval metrics: reconstruction (mse, PSNR, SSIM), flow with GT (photometric
loss, EPE, outlier rates) and without (FWL)."""
from .flow import flow_evaluate, validity_mask
from .fwl import fwl_metric, voxel_warping_flow_loss
from .recon import psnr, recon_evaluate
from .ssim import ssim

__all__ = ["flow_evaluate", "validity_mask", "fwl_metric", "voxel_warping_flow_loss", "psnr",
           "recon_evaluate", "ssim"]
