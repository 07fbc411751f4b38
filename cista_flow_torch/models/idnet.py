"""IDNet (IDEDEQIDO): flow without a correlation volume, by iterative
deblurring (NCHW).

Counterpart of cista_flow_tpu/models/idnet.py ``apply`` and ``_deblur``
(ref: idn/idedeq.py:13-235), in the CISTA-Flow configuration
(``deblur_mode='voxel'``, ``pred_next_flow=True``, no context encoder;
ref: e2v/e2v_model.py:256-261), the only one the gate anchors hold. Each
deblur iteration warps every temporal bin of the padded voxel toward bin 0
along the current flow (one ``F.grid_sample`` over all bins), encodes each
bin with the LiteEncoder (all bins in one call, bins on the batch axis),
folds the bins' features through a ConvGRU, and emits a convex-upsampled
delta flow and the next step's flow, which the runner passes back as
``flow_init``.

Not ported: the context encoder over the running flow map
(``input_flowmap``; no committed anchor carries ``cnet.*`` weights), the
``deblur=False`` and 'patch' deblur branches, and ``rec_ide``, the
training-time sequence generator.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.encoders import LiteEncoder
from ..nn.gru import LiteUpdateBlock
from ..ops.pad import ImagePadder
from ..ops.upsample import convex_upsample

HIDDEN_DIM = 96
INPUT_DIM = 64
DOWNSAMPLE = 8


def deblur(voxel: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp bin t of voxel (B, V, H, W) along flow (B, 2, H, W) scaled by
    t/(V-1), sampling at (x + s*u) normalized by /(W-1) with
    ``align_corners=False`` and zeros padding, exactly as the reference
    writes it (ref: idn/idedeq.py:74-92). Grid in f32."""
    b, v, h, w = voxel.shape
    dev = voxel.device
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    scales = torch.tensor([t / (v - 1) for t in range(v)], dtype=torch.float32,
                          device=dev).reshape(v, 1, 1, 1)
    f = flow.float()
    gx = (xx[None] + f[None, :, 0] * scales) / (w - 1) * 2.0 - 1.0
    gy = (yy[None] + f[None, :, 1] * scales) / (h - 1) * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(v * b, h, w, 2)
    src = voxel.transpose(0, 1).reshape(v * b, 1, h, w).float()
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(v, b, h, w).transpose(0, 1).to(voxel.dtype)


class IDNet(nn.Module):
    """Module names as the reference's: ``fnet.*``, ``update_net.*``."""

    def __init__(self):
        super().__init__()
        self.fnet = LiteEncoder(2, INPUT_DIM // 2)
        self.update_net = LiteUpdateBlock(HIDDEN_DIM, INPUT_DIM, DOWNSAMPLE)

    def forward(self, event_bins, flow_init=None, iters: int = 1,
                collect_preds: bool = False):
        """event_bins (B, V, H, W); flow_init (B, 2, Hp, Wp) at the padded
        resolution or None. Returns {'flow_final' (B, 2, H, W), 'next_flow'
        (B, 2, Hp, Wp), 'flow_preds' (every iteration's total flow, padded,
        with ``collect_preds``)}, in the input's dtype."""
        padder = ImagePadder(event_bins.shape[2:], min_size=32)
        x = padder.pad(event_bins)
        b, v, h, w = x.shape
        flow_total = (torch.zeros((b, 2, h, w), dtype=x.dtype, device=x.device)
                      if flow_init is None else flow_init)
        delta_flow = flow_total
        preds = []
        for _ in range(iters):
            x = deblur(x, delta_flow)
            net = torch.zeros((b, HIDDEN_DIM, h // DOWNSAMPLE, w // DOWNSAMPLE),
                              dtype=x.dtype, device=x.device)
            # each bin duplicated on two channels (ref: idedeq.py:166)
            sb = x.transpose(0, 1).reshape(v * b, 1, h, w)
            feats = self.fnet(torch.cat([sb, sb], 1))
            feats = feats.reshape(v, b, *feats.shape[1:])
            for t in range(v):
                net = self.update_net.gru(net, feats[t])
            (dflow, mask), (nflow, mask2) = self.update_net.heads(net)
            delta_flow = convex_upsample(dflow, mask, DOWNSAMPLE, flow_scale=8)
            next_flow = convex_upsample(nflow, mask2, DOWNSAMPLE, flow_scale=8)
            flow_total = flow_total + delta_flow
            if collect_preds:
                preds.append(flow_total)
        return {"flow_final": padder.unpad(flow_total).contiguous(),
                "next_flow": next_flow, "flow_preds": preds}
