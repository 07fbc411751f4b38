"""K4: instance norm (+ relu) and its stats phase (csrc/norm.cu).

Counterpart of cista_flow_tpu/ops/pallas_norm.py: ``instance_norm_fused``
and ``instance_norm_stats``. CUDA tensors go to the kernel (or raise); CPU
tensors take the plain versions below. ``launch_rule`` picks the kernel's
template (vectors per thread, threads per plane) from the plane size.
"""
from __future__ import annotations

import functools

import torch

from .cuda_build import (DTYPE_CODES, F, I, Kernel, LL, P, SharedKernel, check_cuda,
                         on_cpu, stream_ptr)

KERNEL = Kernel("norm.cu", {"cista_instance_norm": [I, P, P, P, P, LL, I, F, I, I, I, P]})
KERNEL_STATS = SharedKernel(KERNEL)     # K4s: the same source, its own count

# the templates norm.cu instantiates, per element size: vectors per thread
# for each number of threads per plane (32: a warp per plane, WARP_PLANES
# planes a block). Each is the one an encoder plane of 768, 3072 or 12288
# elements takes (the 1/8, 1/4 and 1/2 resolution of a 192x256 frame);
# other plane sizes take the smallest template that covers them, or the
# generic route.
VECTOR_ROUTES = {2: ((32, (3, 12)), (256, (6,))),
                 4: ((32, (6,)), (256, (3,)), (512, (6,)))}
WARP_PLANES = 4
LOOP_THREADS = 256


@functools.lru_cache(maxsize=None)
def launch_rule(hw: int, elem_size: int, aligned: bool = True):
    """(vectors per thread, threads per plane, planes per block) for planes
    of ``hw`` elements of ``elem_size`` bytes. Thread t of a plane holds its
    16-byte vectors t, t + threads, ..., the ones past the plane's end
    masked. Vectors per thread 0 is the generic route (one block of
    LOOP_THREADS per plane, scalar loads): for planes that are not whole
    vectors, tensors not 16-byte aligned, and planes past the largest
    template."""
    vec = 16 // elem_size
    if aligned and hw % vec == 0:
        nvec = hw // vec
        for threads, choices in VECTOR_ROUTES[elem_size]:
            need = -(-nvec // threads)
            for nv in choices:
                if nv >= need:
                    return nv, threads, WARP_PLANES if threads == 32 else 1
    return 0, LOOP_THREADS, 1


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5):
    """(mean, inv_std), each (B, C) f32: two-pass f32 statistics."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    var = (xf - mean[:, :, None, None]).square().mean(dim=(2, 3))
    return mean, torch.rsqrt(var + eps)


def instance_norm_plain(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False) -> torch.Tensor:
    """InstanceNorm2d (affine=False) with f32 statistics, optional relu."""
    mean, inv = instance_norm_stats_plain(x, eps)
    y = (x.float() - mean[:, :, None, None]) * inv[:, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def instance_norm_from_stats(x: torch.Tensor, eps: float = 1e-5,
                             relu: bool = False) -> torch.Tensor:
    """The second route to the same function: statistics from K4s, then the
    normalisation as plain elementwise ops (counterpart of pallas_norm's
    ``instance_norm_statskernel``)."""
    mean, inv = instance_norm_stats(x, eps)
    y = (x.float() - mean[:, :, None, None]) * inv[:, :, None, None]
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _launch(kernel, x, y, mean, inv, eps, relu):
    b, c, h, w = x.shape
    nv, threads, _ = launch_rule(h * w, x.element_size(), x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        kernel.launch("cista_instance_norm", DTYPE_CODES[x.dtype], x.data_ptr(),
                      y.data_ptr() if y is not None else None,
                      mean.data_ptr() if mean is not None else None,
                      inv.data_ptr() if inv is not None else None,
                      b * c, h * w, float(eps), int(relu), nv, threads,
                      stream_ptr(x.device))


def _check(x):
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"instance norm kernel needs a non-empty NCHW tensor, got {tuple(x.shape)}")
    check_cuda("instance_norm", DTYPE_CODES, x)


def instance_norm_fused(x: torch.Tensor, eps: float = 1e-5,
                        relu: bool = False) -> torch.Tensor:
    """relu(instance_norm(x)) on NCHW x, one launch."""
    if on_cpu(x):
        return instance_norm_plain(x, eps, relu)
    _check(x)
    y = torch.empty_like(x)
    _launch(KERNEL, x, y, None, None, eps, relu)
    return y


def instance_norm_stats(x: torch.Tensor, eps: float = 1e-5):
    """Per-(sample, channel) mean and inverse std, f32 (B, C) each (K4s)."""
    if on_cpu(x):
        return instance_norm_stats_plain(x, eps)
    _check(x)
    b, c = x.shape[:2]
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    inv = torch.empty((b, c), dtype=torch.float32, device=x.device)
    _launch(KERNEL_STATS, x, None, mean, inv, eps, False)
    return mean, inv
