"""E-RAFT: dense optical flow from two consecutive event voxels (NCHW).

Counterpart of cista_flow_tpu/models/eraft.py ``apply`` (ref:
ERAFT/eraft.py:37-178): feature encoder on both voxels (one 2B call) ->
all-pairs correlation pyramid -> context encoder on the newer voxel ->
``iters`` GRU iterations, each with one correlation lookup (kernel K1,
convc1 fused) -> one convex upsampling. On a row band of a sharded step
(serving) the band's ``fmap1`` rows correlate with the whole frame's
``fmap2``, its coordinates start at its first row, and the convex
upsampling takes one halo row of the coarse flow. The JAX package's merged
fnet+cnet tower regroups the same encoders for the TPU's lanes and has no
counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.encoders import BasicEncoder
from ..nn.gru import BasicUpdateBlock
from ..ops import bands
from ..ops import corr as CORR
from ..ops import cuda_corr
from ..ops.pad import padder_for
from ..utils.profiling import annotate

HDIM = 128
CDIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 4
COR_PLANES = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2


class ERAFT(nn.Module):
    def __init__(self, num_bins: int = 5):
        super().__init__()
        self.fnet = BasicEncoder(num_bins, 256, "instance")
        self.cnet = BasicEncoder(num_bins, HDIM + CDIM, "batch")
        self.update_block = BasicUpdateBlock(COR_PLANES, HDIM)

    def encode(self, im1, im2):
        """(fmap1, fmap2, cnet) of padded voxels: fnet on both in one 2B
        call, cnet on the newer; the span ``flownet.encode`` while a
        profiler records."""
        with annotate("flownet.encode"):
            b = im1.shape[0]
            fmaps = self.fnet(torch.cat([im1, im2], 0))
            return fmaps[:b], fmaps[b:], self.cnet(im2)

    def forward(self, voxel_old, voxel_new, iters: int = 12, flow_init=None,
                collect_preds: bool = False, encoded=None):
        """voxel_old/new (B, bins, H, W). ``encoded``: precomputed (fmap1,
        fmap2, cnet), as the time-parallel window passes them. Returns
        {'flow_preds' (n, B, 2, Hp, Wp), 'flow_init' (B, 2, Hp/8, Wp/8),
        'flow_final' (B, 2, H, W)}; flows are f32. ``collect_preds`` keeps
        every iteration's upsampled flow; serving upsamples once."""
        padder = padder_for(voxel_new.shape[2:], min_size=32)
        if encoded is None:
            encoded = self.encode(padder.pad(voxel_old), padder.pad(voxel_new))
        flow_init_out, flow_preds = self.iterate(*encoded, iters, flow_init, collect_preds)
        return {"flow_preds": flow_preds, "flow_init": flow_init_out,
                "flow_final": padder.unpad(flow_preds[-1]).contiguous()}

    def iterate(self, fmap1, fmap2, cnet, iters, flow_init=None, collect_preds=False):
        """The pyramid, the GRU iterations and the convex upsampling from
        encoded features: (flow at 1/8, flow_preds (n, B, 2, 8h, 8w)). The
        pyramid is in the span ``flownet.encode``, the iterations and the
        upsampling in ``flownet.update``, while a profiler records."""
        with annotate("flownet.encode"):
            pyr = CORR.build_corr_pyramid(fmap1, bands.gather(fmap2, 8, padded=True),
                                          CORR_LEVELS)
            net = torch.tanh(cnet[:, :HDIM])
            inp = torch.relu(cnet[:, HDIM:])

        b, _, h8, w8 = fmap1.shape
        coords0 = CORR.coords_grid(b, h8, w8, fmap1.device, bands.first_row(8, padded=True))
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        with annotate("flownet.update"):
            ub = self.update_block
            convc1 = ub.encoder.convc1
            mask = torch.zeros((b, 64 * 9, h8, w8), dtype=fmap1.dtype,
                               device=fmap1.device)
            preds = []
            for _ in range(iters):
                # each iteration's coordinates enter without a gradient, as RAFT
                # trains (cista_flow_tpu/models/eraft.py:113)
                coords1 = coords1.detach()
                cor = cuda_corr.lookup(pyr, coords1, convc1.weight, convc1.bias)
                net, mask, delta = ub(net, inp, cor, coords1 - coords0,
                                      corr_projected=True)
                coords1 = coords1 + delta
                if collect_preds:
                    preds.append(bands.convex_upsample(coords1 - coords0, mask, 8))
            if not collect_preds:
                preds.append(bands.convex_upsample(coords1 - coords0, mask, 8))
            return coords1 - coords0, torch.stack(preds)
