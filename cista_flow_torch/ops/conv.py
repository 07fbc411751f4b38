"""Convolution and normalization primitives (NCHW / OIHW).

Counterpart of cista_flow_tpu/ops/conv.py, without its TPU regroupings
(the tap-sum, stride-2 phase and ones-dot formulations compute the same
plain ops). ``instance_norm`` is kernel K4 on the card, and ``conv2d`` sends
the square 3x3 convs of 64 and 128 channels to kernel K5, by the shape rule
of the JAX dispatch (ops/conv.py there, pallas_conv.CHANNELS).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_conv


def routes_to_conv3x3(w_shape, stride, padding) -> bool:
    """The shape rule that sends a conv to kernel K5: 3x3, stride 1,
    padding 1, one group, as many outputs as inputs, 64 or 128 of them."""
    cout, cin, kh, kw = w_shape
    return ((kh, kw) == (3, 3) and tuple(stride) == (1, 1)
            and tuple(padding) == (1, 1) and cin == cout
            and cout in cuda_conv.CHANNELS)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           stride=1, padding=0, padding_mode: str = "zeros",
           relu: bool = False) -> torch.Tensor:
    """2D convolution; ``padding`` int or (ph, pw); 'zeros' or 'reflect';
    ``relu`` applies a trailing relu (fused where the conv is kernel K5)."""
    if isinstance(stride, int):
        stride = (stride, stride)
    if isinstance(padding, int):
        padding = (padding, padding)
    if padding_mode not in ("zeros", "reflect"):
        raise ValueError(f"unknown padding_mode {padding_mode}")
    if x.shape[1] == w.shape[1] and routes_to_conv3x3(w.shape, stride, padding):
        return cuda_conv.conv3x3(x, w, b, padding_mode, relu)
    ph, pw = padding
    if padding_mode == "reflect" and (ph or pw):
        x = F.pad(x, (pw, pw, ph, ph), mode="reflect")
        ph = pw = 0
    y = F.conv2d(x, w, b, stride=stride, padding=(ph, pw))
    return torch.relu(y) if relu else y


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
