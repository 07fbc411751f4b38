"""IDNet (IDEDEQIDO): flow without a correlation volume, by iterative
deblurring (NCHW).

Counterpart of cista_flow_tpu/models/idnet.py ``apply``, ``_deblur`` and
``rec_ide`` (ref: idn/idedeq.py:13-306). Each deblur iteration warps every
temporal bin of the padded voxel toward bin 0 along the current flow (one
``F.grid_sample`` over all bins), encodes each bin with the LiteEncoder
(all bins in one call, bins on the batch axis), folds the bins' features
through a ConvGRU, and emits a convex-upsampled delta flow and, with
``pred_next_flow`` (CISTA-Flow's configuration, ref:
e2v/e2v_model.py:256-261), the next step's flow, which the runner passes
back as ``flow_init``. The reference's other branches are here too:
``deblur=False`` (the raw voxel each iteration; the total flow is replaced
by the delta unless ``add_delta``), the 'patch' scales of ``deblur_mode``,
and ``input_flowmap``, a context LiteEncoder (``cnet``) over the running
flow map that seeds the GRU state. No committed anchor carries ``cnet.*``
weights. On a row band of a sharded step each rank deblurs its rows of the
padded voxel from the whole voxel, gathered from the ranks, and its convs
and both convex upsamplings take their halos (ops/bands.py): the GRU's
3x3 convs one row at 1/8 each, so the state needs no wider exchange.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.encoders import LiteEncoder
from ..nn.gru import LiteUpdateBlock
from ..ops import bands
from ..ops.pad import padder_for

HIDDEN_DIM = 96
INPUT_DIM = 64
DOWNSAMPLE = 8


def deblur(voxel: torch.Tensor, flow: torch.Tensor, mode: str = "voxel",
           row0: int = 0) -> torch.Tensor:
    """Warp bin t of voxel (B, V, H, W) along flow (B, 2, H, W) scaled by
    t/(V-1) (``mode='voxel'``) or (t+0.5)/V (any other mode, the
    reference's 'patch' scales), sampling at (x + s*u) normalized by /(W-1)
    with ``align_corners=False`` and zeros padding, exactly as the reference
    writes it (ref: idn/idedeq.py:74-92). Grid in f32. A row band's flow
    (B, 2, rows, W) from the frame's row ``row0`` gives the band's rows of
    the deblurred voxel."""
    b, v, h, w = voxel.shape
    rows = flow.shape[2]
    dev = voxel.device
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    yy = torch.arange(row0, row0 + rows, dtype=torch.float32, device=dev)[None, :, None]
    scales = torch.tensor([t / (v - 1) if mode == "voxel" else (t + 0.5) / v
                           for t in range(v)], dtype=torch.float32,
                          device=dev).reshape(v, 1, 1, 1)
    f = flow.float()
    gx = (xx[None] + f[None, :, 0] * scales) / (w - 1) * 2.0 - 1.0
    gy = (yy[None] + f[None, :, 1] * scales) / (h - 1) * 2.0 - 1.0
    grid = torch.stack([gx, gy], dim=-1).reshape(v * b, rows, w, 2)
    src = voxel.transpose(0, 1).reshape(v * b, 1, h, w).float()
    out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(v, b, rows, w).transpose(0, 1).to(voxel.dtype)


def _deblur_bins(voxel, flow, mode):
    """``deblur`` as the module holds it at call time (``forward``'s own
    ``deblur`` flag shadows the name; a profile may wrap the function); on
    a row band, of the band's rows from the whole voxel."""
    return deblur(bands.gather(voxel, 1, padded=True), flow, mode,
                  bands.first_row(1, padded=True))


class IDNet(nn.Module):
    """Module names as the reference's: ``fnet.*``, ``update_net.*`` and,
    with ``input_flowmap``, ``cnet.*``."""

    def __init__(self, pred_next_flow: bool = True, input_flowmap: bool = False,
                 deblur_mode: str = "voxel"):
        super().__init__()
        self.pred_next_flow = pred_next_flow
        self.input_flowmap = input_flowmap
        self.deblur_mode = deblur_mode
        self.fnet = LiteEncoder(2, INPUT_DIM // 2)
        self.update_net = LiteUpdateBlock(HIDDEN_DIM, INPUT_DIM, DOWNSAMPLE,
                                          num_outputs=2 if pred_next_flow else 1)
        if input_flowmap:
            self.cnet = LiteEncoder(2, HIDDEN_DIM // 2)

    def forward(self, event_bins, flow_init=None, iters: int = 1,
                collect_preds: bool = False, deblur: bool = True,
                add_delta: bool = False):
        """event_bins (B, V, H, W); flow_init (B, 2, Hp, Wp) at the padded
        resolution or None. Returns {'flow_final' (B, 2, H, W), 'next_flow'
        (B, 2, Hp, Wp), or None without ``pred_next_flow``, 'flow_preds'
        (every iteration's total flow, padded) and 'delta_flow' (the
        initial flow, then every iteration's delta), the last two with
        ``collect_preds`` (else empty, and the initial flow alone)}, in the
        input's dtype."""
        padder = padder_for(event_bins.shape[2:], min_size=32)
        x_raw = padder.pad(event_bins)
        b, v, h, w = x_raw.shape
        flow_total = (torch.zeros((b, 2, h, w), dtype=x_raw.dtype, device=x_raw.device)
                      if flow_init is None else flow_init)
        delta_flow = flow_total
        x_deblur = x_raw
        preds, deltas = [], [delta_flow]       # the reference seeds the history
        next_flow = None
        for it in range(iters):
            if deblur:
                x_deblur = _deblur_bins(x_deblur, delta_flow, self.deblur_mode)
                src = x_deblur
            else:
                src = x_raw
            if self.input_flowmap and (flow_init is not None or it >= 1):
                net = self.cnet(flow_total.to(x_raw.dtype))
            else:
                net = torch.zeros((b, HIDDEN_DIM, h // DOWNSAMPLE, w // DOWNSAMPLE),
                                  dtype=x_raw.dtype, device=x_raw.device)
            # each bin duplicated on two channels (ref: idedeq.py:166)
            sb = src.transpose(0, 1).reshape(v * b, 1, h, w)
            feats = self.fnet(torch.cat([sb, sb], 1))
            feats = feats.reshape(v, b, *feats.shape[1:])
            for t in range(v):
                net = self.update_net.gru(net, feats[t])
            (dflow, mask), second = self.update_net.heads(net)
            delta_flow = bands.convex_upsample(dflow, mask, DOWNSAMPLE, flow_scale=8)
            if collect_preds:
                deltas.append(delta_flow)
            if second is not None:
                next_flow = bands.convex_upsample(*second, DOWNSAMPLE, flow_scale=8)
            flow_total = flow_total + delta_flow if deblur or add_delta else delta_flow
            if collect_preds:
                preds.append(flow_total)
        return {"flow_final": padder.unpad(flow_total).contiguous(),
                "next_flow": next_flow, "flow_preds": preds, "delta_flow": deltas}


def rec_ide(net: IDNet, batch, flow_init=None, iters: int = 1, yield_every: int = 4):
    """The sequence generator (RecIDE, ref: idn/idedeq.py:275-306; the JAX
    package's ``idnet.rec_ide``): chains ``next_flow`` across ``batch``, a
    sequence of (B, V, H, W) voxels, and every ``yield_every`` steps yields
    {'flow_final' of that step, 'flow_preds': the steps' final flows,
    'flow_next_trajectory': their next flows}, the chained flow detached
    there."""
    flow_traj, next_traj = [], []
    for t, x in enumerate(batch):
        out = net(x, flow_init=flow_init, iters=iters, collect_preds=True)
        flow_traj.append(out["flow_final"])
        flow_init = out["next_flow"]
        next_traj.append(flow_init)
        if (t + 1) % yield_every == 0:
            flow_init = flow_init.detach()
            yield {"flow_final": out["flow_final"], "flow_preds": flow_traj,
                   "flow_next_trajectory": next_traj}
            flow_traj, next_traj = [], []
