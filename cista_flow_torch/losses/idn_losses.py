"""IDNet's auxiliary flow losses (NCHW, the channel axis is dim 1).

Counterpart of cista_flow_tpu/losses/idn_losses.py (ref: idn/loss.py:4-145):
masked sparse L1 and L-norm losses and their sequence mean, the Charbonnier
penalty, 8-connected smoothness, and the NPE metric. A mask broadcasts
against the difference (or its per-pixel norm); an empty mask gives 0.
"""
from __future__ import annotations

import torch


def _masked_mean(x: torch.Tensor, valid_mask) -> torch.Tensor:
    if valid_mask is None:
        return torch.mean(x)
    m = valid_mask.bool().expand_as(x)
    cnt = torch.sum(m)
    total = torch.sum(torch.where(m, x, torch.zeros_like(x)))
    return torch.where(cnt > 0, total / torch.clamp(cnt, min=1), torch.zeros_like(total))


def sparse_l1(estimated, ground_truth, valid_mask=None) -> torch.Tensor:
    """Masked L1 (ref: idn/loss.py:16-44)."""
    return _masked_mean(torch.abs(estimated - ground_truth), valid_mask)


def sparse_l1_seq(estimated, ground_truth, valid_mask=None) -> torch.Tensor:
    """The mean masked L1 over a sequence (ref: idn/loss.py:4-13)."""
    masks = valid_mask if valid_mask is not None else [None] * len(estimated)
    total = 0.0
    for e, g, m in zip(estimated, ground_truth, masks):
        total = total + sparse_l1(e, g, m)
    return total / len(estimated)


def sparse_lnorm(order, estimated, ground_truth, valid_mask=None) -> torch.Tensor:
    """Masked per-pixel L-``order`` norm over the channels (ref:
    idn/loss.py:46-89)."""
    diff = torch.linalg.vector_norm(estimated - ground_truth, ord=order, dim=1, keepdim=True)
    return _masked_mean(diff, valid_mask)


def charbonnier_loss(delta, alpha: float = 0.45, epsilon: float = 1e-3) -> torch.Tensor:
    """Robust Charbonnier (ref: idn/loss.py:92-97)."""
    return torch.mean((delta ** 2 + epsilon ** 2) ** alpha)


def smoothness_loss(flow) -> torch.Tensor:
    """8-connected local smoothness of (..., C, H, W) (ref:
    idn/loss.py:100-122)."""
    l, r = flow[..., :, 1:], flow[..., :, :-1]
    u, d = flow[..., 1:, :], flow[..., :-1, :]
    ul, dr = flow[..., 1:, 1:], flow[..., :-1, :-1]
    dl, ur = flow[..., :-1, 1:], flow[..., 1:, :-1]
    return (charbonnier_loss(l - r) + charbonnier_loss(u - d)
            + charbonnier_loss(ul - dr) + charbonnier_loss(dl - ur)) / 4.0


def npe(n, estimated, ground_truth, valid_mask=None) -> torch.Tensor:
    """The share of pixels whose endpoint error is at least ``n`` px (ref:
    idn/loss.py:125-145)."""
    err = torch.linalg.vector_norm(estimated - ground_truth, dim=1, keepdim=True)
    hit = (err >= n).float()
    if valid_mask is None:
        return torch.mean(hit)
    m = valid_mask.bool().expand_as(hit)
    return torch.sum(torch.where(m, hit, torch.zeros_like(hit))) / torch.clamp(torch.sum(m), min=1)
