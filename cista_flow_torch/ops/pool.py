"""Pooling ops (NCHW; counterpart of cista_flow_tpu/ops/pool.py)."""
from __future__ import annotations

import torch


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool over the last two dims, f32 sums, odd
    trailing rows/cols dropped. A dim of size 1 pools to size 0: an empty
    level rather than ``F.avg_pool2d``'s error, as the JAX package's
    reduce_window gives (the correlation pyramid of a frame under 64 px)."""
    h2, w2 = x.shape[-2] // 2, x.shape[-1] // 2
    xf = x[..., :2 * h2, :2 * w2].float()
    s = (xf[..., 0::2, 0::2] + xf[..., 0::2, 1::2]
         + xf[..., 1::2, 0::2] + xf[..., 1::2, 1::2])
    return (s * 0.25).to(x.dtype)
