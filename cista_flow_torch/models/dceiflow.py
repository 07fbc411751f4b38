"""DCEIFlow: event + single-image optical flow (NCHW).

Counterpart of cista_flow_tpu/models/dceiflow.py ``_fusion``, ``_iterate``,
``_single_direction`` and ``apply`` (ref: DCEIFlow/DCEIFlow.py:49-300):
image encoder (1 ch) + event encoder (bins) -> EIFusion makes a pseudo
second-frame feature map -> all-pairs correlation pyramid -> context
encoder -> ``iters`` GRU iterations, each with one correlation lookup
(kernel K1, convc1 fused) -> ``upflow8``. In training the second frame is
encoded beside the first (the pseudo-feature loss), and with reversed events
the same weights run the backward direction too (ref: DCEIFlow.py:230-270).
On a row band of a sharded step (serving) the band's ``fmap1`` rows
correlate with the whole frame's pseudo ``fmap2``, its coordinates start at
its first row, and ``upflow8`` gives the band's rows.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn as nn

from ..nn.encoders import BasicEncoder
from ..nn.gru import BasicUpdateBlockEvent
from ..ops import bands
from ..ops import corr as CORR
from ..ops import cuda_corr
from ..ops.conv import conv2d
from ..ops.pad import padder_for
from ..utils.profiling import annotate

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
        training loss needs them); serving keeps only the last. The span
        ``flownet.update`` while a profiler records."""
        with annotate("flownet.update"):
            ub = self.update_block
            ema = ub.precompute_update_ema(emap)
            convc1 = ub.encoder.convc1
            preds = []
            for _ in range(iters):
                coords1 = coords1.detach()     # as RAFT: no gradient through the lookup point
                cor = cuda_corr.lookup(pyr, coords1, convc1.weight, convc1.bias)
                net, delta = ub(net, inp, cor, ema, coords1 - coords0)
                coords1 = coords1 + delta
                if collect_preds:
                    preds.append(bands.upflow(coords1 - coords0, self.ds))
            if not collect_preds:
                preds.append(bands.upflow(coords1 - coords0, self.ds))
            return coords1, torch.stack(preds)

    def _single_direction(self, emap, fmap1, im1, iters, flow_init, collect_preds):
        """Fusion, pyramid, context encoder and the GRU iterations from one
        frame's features: (flow at 1/8, flow_preds, pseudo second-frame
        features)."""
        with annotate("flownet.encode"):
            pseudo_fmap2 = self.fusion(fmap1, emap)
            pyr = CORR.build_corr_pyramid(
                fmap1, bands.gather(pseudo_fmap2, self.ds, padded=True), CORR_LEVELS)
            cnet = self.cnet(im1)
            net = torch.tanh(cnet[:, :HDIM])
            inp = torch.relu(cnet[:, HDIM:])

        b, _, h, w = im1.shape
        coords0 = CORR.coords_grid(b, h // self.ds, w // self.ds, im1.device,
                                   bands.first_row(self.ds, padded=True))
        coords1 = coords0 if flow_init is None else coords0 + flow_init
        coords1, flow_preds = self._iterate(net, inp, pyr, coords0, coords1,
                                            emap, iters, collect_preds)
        return coords1 - coords0, flow_preds, pseudo_fmap2

    def forward(self, event_voxel, image1, iters: int = 6, flow_init=None,
                collect_preds: bool = False, image2=None, reversed_event_voxel=None):
        """event_voxel (B, bins, H, W); image1 (B, 1, H, W) in [0, 1].
        Returns {'flow_preds' (n, B, 2, Hp, Wp), 'flow_init' (B, 2, Hp/8,
        Wp/8), 'flow_final' (B, 2, H, W)}; flows are f32. With ``image2``
        (training) also 'fmap2_gt' and 'fmap2_pseudo'; with ``image2`` and
        ``reversed_event_voxel`` the backward direction's 'flow_preds_bw'
        (every iteration), 'flow_final_bw' (kept padded, as the reference
        does), 'fmap1_gt' and 'fmap1_pseudo'."""
        padder = padder_for(event_voxel.shape[2:], min_size=32)
        im1 = padder.pad(2.0 * image1 - 1.0)
        ev = padder.pad(event_voxel)
        with annotate("flownet.encode"):
            emap = self.enet(ev)
            if image2 is not None:
                im2 = padder.pad(2.0 * image2.to(image1.dtype) - 1.0)   # the frames' dtype
                fmap1, fmap2 = self.fnet(torch.cat([im1, im2])).chunk(2)
            else:
                fmap1 = self.fnet(im1)

        flow_lowres, flow_preds, pseudo_fmap2 = self._single_direction(
            emap, fmap1, im1, iters, flow_init, collect_preds)
        out = {"flow_preds": flow_preds, "flow_init": flow_lowres,
               "flow_final": padder.unpad(flow_preds[-1]).contiguous()}
        if image2 is None:
            return out
        out.update(fmap2_gt=fmap2, fmap2_pseudo=pseudo_fmap2)
        if reversed_event_voxel is not None:
            with annotate("flownet.encode"):
                remap = self.enet(padder.pad(reversed_event_voxel))
            # the JAX package drops the backward call's BN statistics
            with _running_stats_kept(self.cnet):
                _, flow_preds_bw, pseudo_fmap1 = self._single_direction(
                    remap, fmap2, im2, iters, flow_init, True)
            out.update(flow_preds_bw=flow_preds_bw, flow_final_bw=flow_preds_bw[-1],
                       fmap1_gt=fmap1, fmap1_pseudo=pseudo_fmap1)
        return out


@contextlib.contextmanager
def _running_stats_kept(module: nn.Module):
    """Restore ``module``'s BatchNorm running statistics on exit: a
    train-mode call inside normalises by its batch but leaves no trace."""
    saved = [(b, b.clone()) for name, b in module.named_buffers()
             if name.endswith(("running_mean", "running_var"))]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)
