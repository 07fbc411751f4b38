"""RAFT convex upsampling (NCHW).

Counterpart of cista_flow_tpu/ops/upsample.py ``convex_upsample`` (ref:
ERAFT/eraft.py:77-88): a learned 9-way softmax over the 3x3 zero-padded
neighbourhood of the coarse flow, one set of weights per pixel of the
(r x r) window each coarse pixel expands to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, factor: int,
                    flow_scale: int | None = None) -> torch.Tensor:
    """flow (B, 2, H, W) -> (B, 2, H*r, W*r). mask: (B, 9*r*r, H, W) raw
    logits, channel = tap*r*r + window position, taps in ``F.unfold``'s
    row-major (dy, dx) order. ``flow_scale`` multiplies the coarse flow
    (default ``factor``: flow in coarse-pixel units; IDNet always uses 8)."""
    b, _, h, w = flow.shape
    r = factor
    scale = float(factor if flow_scale is None else flow_scale)
    m = torch.softmax(mask.float().view(b, 1, 9, r, r, h, w), dim=2)
    nbr = F.unfold(flow.float() * scale, kernel_size=3, padding=1)
    nbr = nbr.view(b, 2, 9, 1, 1, h, w)
    up = (m * nbr).sum(dim=2)                         # (B, 2, r, r, H, W)
    up = up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, h * r, w * r)
    return up.to(flow.dtype)
