"""RAFT: optical flow from a pair of RGB images (NCHW).

Counterpart of cista_flow_tpu/models/raft.py (ref: DCEIFlow/RAFT.py:28-149),
the image-pair flow net of ``pretrain_flow --flow_arch raft``: RGB in
[0, 255], normalised to [-1, 1] inside and padded to multiples of 8 ->
``BasicEncoder(3, 256, "instance")`` on both images in one 2B call ->
all-pairs correlation pyramid -> ``BasicEncoder(3, 256, "batch")`` on image
1 -> ``iters`` iterations of E-RAFT's update block, each with one
correlation lookup (kernel K1, convc1 fused) and the coordinates detached
-> convex upsampling x8. The module layout is E-RAFT's (the reference's
``raft_params`` is ``eraft_params``), so the same state dicts load.
"""
from __future__ import annotations

import torch

from ..ops.pad import ImagePadder
from .eraft import ERAFT


class RAFT(ERAFT):
    def __init__(self):
        super().__init__(num_bins=3)          # fnet and cnet read 3 channels

    def forward(self, image1, image2, iters: int = 12, flow_init=None,
                collect_preds: bool = False):
        """image1/image2 (B, 3, H, W), RGB in [0, 255]. Returns
        {'flow_preds' (n, B, 2, Hp, Wp), 'flow_init' (B, 2, Hp/8, Wp/8),
        'flow_final' (B, 2, H, W)}; ``collect_preds`` keeps every
        iteration's upsampled flow (training), else only the last."""
        padder = ImagePadder(image1.shape[2:], min_size=8)
        im1 = padder.pad(2.0 * (image1 / 255.0) - 1.0)
        im2 = padder.pad(2.0 * (image2 / 255.0) - 1.0)
        b = im1.shape[0]
        fmaps = self.fnet(torch.cat([im1, im2], 0))
        flow_lowres, flow_preds = self.iterate(fmaps[:b], fmaps[b:], self.cnet(im1), iters,
                                               flow_init, collect_preds)
        return {"flow_preds": flow_preds, "flow_init": flow_lowres,
                "flow_final": padder.unpad(flow_preds[-1]).contiguous()}
