"""DCEIFlow: event + single-image optical flow (NCHW), serving direction.

Counterpart of cista_flow_tpu/models/dceiflow.py ``_fusion``, ``_iterate``,
``_single_direction`` and ``apply`` (ref: DCEIFlow/DCEIFlow.py:49-300):
image encoder (1 ch) + event encoder (bins) -> EIFusion makes a pseudo
second-frame feature map -> all-pairs correlation pyramid -> context
encoder -> ``iters`` GRU iterations, each with one correlation lookup
(kernel K1, convc1 fused) -> ``upflow8``. The bidirectional training
branch is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.encoders import BasicEncoder
from ..nn.gru import BasicUpdateBlockEvent
from ..ops import corr as CORR
from ..ops import cuda_corr
from ..ops.conv import conv2d
from ..ops.pad import ImagePadder
from ..ops.resize import upflow

HDIM = 128
CDIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 4
COR_PLANES = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2


class EIFusion(nn.Module):
    """Residual event-image fusion (ref: DCEIFlow/DCEIFlow.py:32-44)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(256, 192, 1)
        self.conv2 = nn.Conv2d(256, 192, 1)
        self.convo = nn.Conv2d(384, 256, 3)

    def forward(self, x1, x2):
        c1 = torch.relu(conv2d(x1, self.conv1.weight, self.conv1.bias))
        c2 = torch.relu(conv2d(x2, self.conv2.weight, self.conv2.bias))
        out = torch.relu(conv2d(torch.cat([c1, c2], 1), self.convo.weight,
                                self.convo.bias, padding=1))
        return out + x1


class DCEIFlow(nn.Module):
    def __init__(self, num_bins: int = 5, ds: int = 8):
        super().__init__()
        self.ds = ds
        self.fnet = BasicEncoder(1, 256, "instance", ds)
        self.enet = BasicEncoder(num_bins, 256, "instance", ds)
        self.cnet = BasicEncoder(1, HDIM + CDIM, "batch", ds)
        self.fusion = EIFusion()
        self.update_block = BasicUpdateBlockEvent(COR_PLANES, HDIM)

    def _iterate(self, net, inp, pyr, coords0, coords1, emap, iters,
                 collect_preds):
        """``collect_preds`` keeps every iteration's upsampled flow (the
        training loss needs them); serving keeps only the last."""
        ub = self.update_block
        ema = ub.precompute_update_ema(emap)
        convc1 = ub.encoder.convc1
        preds = []
        for _ in range(iters):
            cor = cuda_corr.lookup(pyr, coords1, convc1.weight, convc1.bias)
            net, delta = ub(net, inp, cor, ema, coords1 - coords0)
            coords1 = coords1 + delta
            if collect_preds:
                preds.append(upflow(coords1 - coords0, self.ds))
        if not collect_preds:
            preds.append(upflow(coords1 - coords0, self.ds))
        return coords1, torch.stack(preds)

    def forward(self, event_voxel, image1, iters: int = 6, flow_init=None,
                collect_preds: bool = False):
        """event_voxel (B, bins, H, W); image1 (B, 1, H, W) in [0, 1].
        Returns {'flow_preds' (n, B, 2, Hp, Wp), 'flow_init' (B, 2, Hp/8,
        Wp/8), 'flow_final' (B, 2, H, W)}; flows are f32."""
        padder = ImagePadder(event_voxel.shape[2:], min_size=32)
        im1 = padder.pad(2.0 * image1 - 1.0)
        ev = padder.pad(event_voxel)
        emap = self.enet(ev)
        fmap1 = self.fnet(im1)

        pseudo_fmap2 = self.fusion(fmap1, emap)
        pyr = CORR.build_corr_pyramid(fmap1, pseudo_fmap2, CORR_LEVELS)
        cnet = self.cnet(im1)
        net = torch.tanh(cnet[:, :HDIM])
        inp = torch.relu(cnet[:, HDIM:])

        b, _, h, w = im1.shape
        coords0 = CORR.coords_grid(b, h // self.ds, w // self.ds, im1.device)
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        coords1, flow_preds = self._iterate(net, inp, pyr, coords0, coords1,
                                            emap, iters, collect_preds)
        return {"flow_preds": flow_preds, "flow_init": coords1 - coords0,
                "flow_final": padder.unpad(flow_preds[-1]).contiguous()}
