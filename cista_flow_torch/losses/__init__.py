"""Eval metrics of the with-flow eval: reconstruction (mse, PSNR, SSIM) and
flow (photometric loss, EPE, outlier rates)."""
from .flow import flow_evaluate, validity_mask
from .recon import psnr, recon_evaluate
from .ssim import ssim

__all__ = ["flow_evaluate", "validity_mask", "psnr", "recon_evaluate", "ssim"]
