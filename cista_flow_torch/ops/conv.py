"""Convolution and normalization primitives (NCHW / OIHW).

Counterpart of cista_flow_tpu/ops/conv.py, without its TPU regroupings
(the tap-sum, stride-2 phase and ones-dot formulations compute the same
plain ops). ``instance_norm`` is kernel K4 on the card, ``group_norm`` plain
PyTorch (no Pallas kernel computes it there), and ``conv2d`` sends
the square 3x3 convs of 64 and 128 channels to kernel K5, by the shape rule
of the JAX dispatch (ops/conv.py there, pallas_conv.CHANNELS).

On a row band of a sharded step (``bands.active()``) both take the band's
rule (ops/bands.py): a conv of vertical radius r runs unchanged on the band
widened by r halo rows from each neighbour and drops the rows its padding
touched; instance norm combines the bands' K4s statistics.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from . import bands, cuda_conv
from .autograd import at_least_f32


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
    if bands.active() is not None:
        return _banded_conv2d(x, w, b, stride, padding, padding_mode, relu)
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


def conv2d_rows(x, top, bottom, w, b=None, stride=(1, 1), padding=(0, 0),
                padding_mode: str = "zeros", relu: bool = False) -> torch.Tensor:
    """``conv2d`` of a row band from its halos (``bands.conv_halo`` rows
    each, None at the frame's edge): the conv of the widened band, run as
    on one process, cropped to the band's output rows."""
    with bands.local():
        y = conv2d(bands.widen(x, top, bottom), w, b, stride, padding, padding_mode, relu)
    return bands.crop(y, top, x.shape[-2], stride[0])


def _banded_conv2d(x, w, b, stride, padding, padding_mode, relu):
    r = bands.conv_halo(w.shape[2], stride[0], padding[0])
    top, bottom = bands.active().halo(x, r, r) if r else (None, None)
    return conv2d_rows(x, top, bottom, w, b, stride, padding, padding_mode, relu)


_STATS_FROZEN = 0          # > 0 inside ``frozen_bn_stats``
_BN_SUM = None             # inside ``global_bn_stats``: the ranks' differentiable sum


@contextlib.contextmanager
def frozen_bn_stats():
    """Inside the block a train-mode ``batch_norm`` normalises with its
    batch statistics but leaves the running statistics and
    ``num_batches_tracked`` as they are: the recompute of a checkpointed
    step (``remat``) passes through it. A process-wide count, not a
    thread-local flag: autograd may recompute on its own thread."""
    global _STATS_FROZEN
    _STATS_FROZEN += 1
    try:
        yield
    finally:
        _STATS_FROZEN -= 1


@contextlib.contextmanager
def global_bn_stats(all_reduce_sum):
    """Inside the block a train-mode ``batch_norm`` takes its statistics
    over the global batch, whose slices the data-parallel ranks hold:
    ``all_reduce_sum`` (``parallel.mesh.all_reduce_sum``) sums a tensor
    over the ranks, differentiably. Process-wide, as ``frozen_bn_stats``:
    a remat recompute on autograd's thread reduces too, and every rank
    recomputes the same graph in the same order, so the collectives pair
    up."""
    global _BN_SUM
    outer, _BN_SUM = _BN_SUM, all_reduce_sum
    try:
        yield
    finally:
        _BN_SUM = outer


def _batch_stats(xf: torch.Tensor):
    """(mean, biased variance, n / (n - 1)) per channel of ``xf`` over its n
    elements of (B, H, W); inside ``global_bn_stats`` over every rank's
    batch: the sums and counts all-reduced to the mean, then the squared
    deviations from it to the variance (two passes, as on one process). The
    global count stays a tensor, so nothing waits on the device."""
    if _BN_SUM is None:
        n = xf.numel() // xf.shape[1]
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
        return mean, var, n / max(n - 1, 1)
    count = torch.full((1,), xf.numel() // xf.shape[1], dtype=xf.dtype, device=xf.device)
    total = _BN_SUM(torch.cat([xf.sum(dim=(0, 2, 3)), count]))
    n = total[-1]
    mean = total[:-1] / n
    var = _BN_SUM((xf - mean[None, :, None, None]).square().sum(dim=(0, 2, 3))) / n
    return mean, var, n / (n - 1).clamp(min=1)


def batch_norm(x: torch.Tensor, bn: torch.nn.BatchNorm2d, eps: float = 1e-5,
               momentum: float = 0.1) -> torch.Tensor:
    """BatchNorm2d, in the mode of ``bn.training`` (cista_flow_tpu/ops/conv.py
    ``batch_norm``). Train: f32 batch statistics over (B, H, W) (over the
    global batch inside ``global_bn_stats``), the biased variance to
    normalise, and ``bn``'s running statistics updated in place with the
    unbiased one (momentum 0.1) and ``num_batches_tracked`` by one, as
    torch's module counts them (not inside ``frozen_bn_stats``). Eval: the
    running statistics. The statistics and the scale are cast to x's
    dtype, as the JAX package casts them."""
    if bn.training:
        mean, var, bessel = _batch_stats(at_least_f32(x))
        if not _STATS_FROZEN:
            with torch.no_grad():
                bn.running_mean.copy_((1 - momentum) * bn.running_mean + momentum * mean)
                bn.running_var.copy_((1 - momentum) * bn.running_var
                                     + momentum * (var * bessel))
                if bn.num_batches_tracked is not None:
                    bn.num_batches_tracked.add_(1)
    else:
        mean, var = bn.running_mean, bn.running_var
    inv = torch.rsqrt(var + eps) * bn.weight
    return ((x - mean.to(x.dtype)[None, :, None, None])
            * inv.to(x.dtype)[None, :, None, None] + bn.bias.to(x.dtype)[None, :, None, None])


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm (cista_flow_tpu/ops/conv.py ``group_norm``): per sample and
    group, the mean and biased variance over (C / G, H, W) in f32, then the
    per-channel affine in f32, cast to x's dtype at the end. Plain PyTorch
    on every device: the JAX package computes it outside any Pallas
    kernel. (``F.group_norm`` would take bf16 input with f32 parameters in
    another order.)"""
    b, c, h, w = x.shape
    xf = x.float().reshape(b, num_groups, c // num_groups, h, w)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    return (y * weight.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  relu: bool = False) -> torch.Tensor:
    """InstanceNorm2d (affine=False) with an optionally fused relu: kernel
    K4 for CUDA tensors, its plain version on the CPU. On a row band: each
    band's statistics (K4s), combined over the ranks, normalise it;
    differentiable through the statistics and their exchange."""
    from .cuda_norm import band_instance_norm_stats, instance_norm_fused
    band = bands.active()
    if band is None:
        return instance_norm_fused(x, eps, relu)
    mean, inv = band_instance_norm_stats(x, eps)
    stats = band.all_gather(bands.band_stats(mean, inv, x.shape[2] * x.shape[3], eps))
    return bands.normalise(x, *bands.combine_stats(stats, eps), relu)
