"""Convolution and normalization primitives (NCHW / OIHW).

Counterpart of cista_flow_tpu/ops/conv.py, without its TPU regroupings
(the tap-sum, stride-2 phase and ones-dot formulations compute the same
plain ops). ``instance_norm`` is kernel K4 on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride=1, padding=0, padding_mode: str = "zeros") -> torch.Tensor:
    """2D convolution; ``padding`` int or (ph, pw); 'zeros' or 'reflect'."""
    if isinstance(padding, int):
        padding = (padding, padding)
    ph, pw = padding
    if padding_mode == "reflect" and (ph or pw):
        x = F.pad(x, (pw, pw, ph, ph), mode="reflect")
        ph = pw = 0
    elif padding_mode not in ("zeros", "reflect"):
        raise ValueError(f"unknown padding_mode {padding_mode}")
    return F.conv2d(x, w, b, stride=stride, padding=(ph, pw))


def batch_norm(x: torch.Tensor, bn: torch.nn.BatchNorm2d,
               eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode BatchNorm2d from the module's running statistics."""
    inv = torch.rsqrt(bn.running_var + eps) * bn.weight
    return ((x - bn.running_mean[None, :, None, None])
            * inv[None, :, None, None] + bn.bias[None, :, None, None])


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """InstanceNorm2d (affine=False) with an optionally fused relu: kernel
    K4 for CUDA tensors, its plain version on the CPU."""
    from .cuda_norm import instance_norm_fused
    return instance_norm_fused(x, eps, relu)
