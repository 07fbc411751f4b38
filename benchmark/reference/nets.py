"""The reference's networks, as functions of a parameter dict in the
published checkpoints' key layout (``cista_net.*``, ``event_flownet.*``).

CISTA-LSTC (e2v/e2v_model.py, e2v/base_layers.py), DCEIFlow
(DCEIFlow/DCEIFlow.py, its RAFT encoder and event update block), E-RAFT
(ERAFT/eraft.py, ERAFT/update.py) and the composite step that warps the
previous frame and sparse code along the flow before CISTA-LSTC
(e2v_model.py, DCEIFlowCistaNet and ERAFTCistaNet), in f32 NCHW.
"""
from __future__ import annotations

import torch

from .ops import (Ops, batch_norm_eval, convex_upsample, coords_grid, corr_lookup,
                  corr_pyramid, frame_warp, instance_norm, pad_to, resize, unpad, upflow)

HDIM = CDIM = 128


def _norm(ops: Ops, x, kind, name):
    return instance_norm(x) if kind == "instance" else batch_norm_eval(x, ops.p, name)


def residual_block(ops: Ops, x, pre, kind, stride):
    y = torch.relu(_norm(ops, ops.conv(x, pre + "conv1", stride, 1), kind, pre + "norm1"))
    y = torch.relu(_norm(ops, ops.conv(y, pre + "conv2", 1, 1), kind, pre + "norm2"))
    if stride != 1:
        x = _norm(ops, ops.conv(x, pre + "downsample.0", stride), kind, pre + "norm3")
    return torch.relu(x + y)


def basic_encoder(ops: Ops, x, pre, kind):
    """RAFT's BasicEncoder at 1/8: 7x7 stride-2 head, three residual
    stages (64, 96, 128), 1x1 output conv."""
    y = torch.relu(_norm(ops, ops.conv(x, pre + "conv1", 2, 3), kind, pre + "norm1"))
    for i, stride in ((1, 1), (2, 2), (3, 2)):
        y = residual_block(ops, y, f"{pre}layer{i}.0.", kind, stride)
        y = residual_block(ops, y, f"{pre}layer{i}.1.", kind, 1)
    return ops.conv(y, pre + "conv2")


def sep_conv_gru(ops: Ops, h, x, pre):
    for s, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(ops.conv(hx, f"{pre}convz{s}", 1, pad))
        r = torch.sigmoid(ops.conv(hx, f"{pre}convr{s}", 1, pad))
        q = torch.tanh(ops.conv(torch.cat([r * h, x], 1), f"{pre}convq{s}", 1, pad))
        h = (1 - z) * h + z * q
    return h


def flow_head(ops: Ops, x, pre):
    return ops.conv(torch.relu(ops.conv(x, pre + "conv1", 1, 1)), pre + "conv2", 1, 1)


def motion_features(ops: Ops, pre, corr, flow, ema=None):
    """The motion encoder: convc1 and convc2 on the correlation windows,
    convf1 and convf2 on the flow, DCEIFlow's event features ``ema``
    between them, the output conv, the flow appended."""
    cor = torch.relu(ops.conv(corr, pre + "convc1"))
    cor = torch.relu(ops.conv(cor, pre + "convc2", 1, 1))
    flo = torch.relu(ops.conv(flow, pre + "convf1", 1, 3))
    flo = torch.relu(ops.conv(flo, pre + "convf2", 1, 1))
    parts = [cor, flo] if ema is None else [cor, ema, flo]
    out = torch.relu(ops.conv(torch.cat(parts, 1), pre + "conv", 1, 1))
    return torch.cat([out, flow], 1)


def _gru_iterations(ops: Ops, pre, fmap1, fmap2, cnet, iters, ema=None, mask=False):
    """The correlation pyramid, then ``iters`` lookups and update steps:
    (flow at 1/8, the last mask logits or None)."""
    pyr = corr_pyramid(ops, fmap1, fmap2)
    net, inp = torch.tanh(cnet[:, :HDIM]), torch.relu(cnet[:, HDIM:])
    b, _, h, w = fmap1.shape
    coords0 = coords_grid(b, h, w, fmap1.device)
    coords1 = coords0
    ub = pre + "update_block."
    up_mask = None
    for _ in range(iters):
        corr = corr_lookup(pyr, coords1)
        motion = motion_features(ops, ub + "encoder.", corr, coords1 - coords0, ema)
        net = sep_conv_gru(ops, net, torch.cat([inp, motion], 1), ub + "gru.")
        if mask:
            m = torch.relu(ops.conv(net, ub + "mask.0", 1, 1))
            up_mask = 0.25 * ops.conv(m, ub + "mask.2")
        coords1 = coords1 + flow_head(ops, net, ub + "flow_head.")
    return coords1 - coords0, up_mask


def dceiflow(ops: Ops, events, image1, iters, pre="event_flownet."):
    """DCEIFlow's forward flow from the voxel and the previous frame."""
    hw = events.shape[2:]
    im1 = pad_to(2.0 * image1 - 1.0)
    emap = basic_encoder(ops, pad_to(events), pre + "enet.", "instance")
    fmap1 = basic_encoder(ops, im1, pre + "fnet.", "instance")
    c1 = torch.relu(ops.conv(fmap1, pre + "fusion.conv1"))
    c2 = torch.relu(ops.conv(emap, pre + "fusion.conv2"))
    pseudo = torch.relu(ops.conv(torch.cat([c1, c2], 1), pre + "fusion.convo", 1, 1)) + fmap1
    cnet = basic_encoder(ops, im1, pre + "cnet.", "batch")
    enc = pre + "update_block.encoder."
    ema = torch.relu(ops.conv(torch.relu(ops.conv(emap, enc + "conve1")), enc + "conve2", 1, 1))
    flow8, _ = _gru_iterations(ops, pre, fmap1, pseudo, cnet, iters, ema=ema)
    return unpad(upflow(flow8, 8), hw)


def eraft_fnet(ops: Ops, voxels, pre="event_flownet."):
    """E-RAFT's feature encoder over a stack of voxels (N, bins, H, W), padded."""
    return basic_encoder(ops, pad_to(voxels), pre + "fnet.", "instance")


def eraft_cnet(ops: Ops, voxels, pre="event_flownet."):
    """E-RAFT's context encoder over the newer voxels, padded."""
    return basic_encoder(ops, pad_to(voxels), pre + "cnet.", "batch")


def eraft_flow(ops: Ops, fmap_old, fmap_new, cnet_new, iters, hw, pre="event_flownet."):
    flow8, mask = _gru_iterations(ops, pre, fmap_old, fmap_new, cnet_new, iters, mask=True)
    return unpad(convex_upsample(flow8, mask, 8), hw)


def zero_state(b, hw, device, c=64):
    h2, w2 = hw[0] // 2, hw[1] // 2

    def z(ch):
        return torch.zeros((b, ch, h2, w2), device=device)
    return [z(2 * c), z(2 * c), z(c), z(c)]     # lstc cell, sparse code, Dg hidden, Dg cell


def cista_lstc(ops: Ops, events, prev_image, state, depth, pre="cista_net."):
    """One CISTA-LSTC step: (frame, new state)."""
    lstc_cell, code, dg_h, dg_c = state
    x1 = torch.cat([ops.conv(events, pre + "We.conv2d", 1, 1, True),
                    ops.conv(prev_image, pre + "Wi.conv2d", 1, 1, True)], 1)
    x1 = ops.conv(x1, pre + "W0.conv2d", 2, 1, True)
    g = torch.sigmoid(ops.conv(torch.cat([x1, code], 1), pre + "P0.gates", 1, 1, True))
    in_gate, forget_gate = g.chunk(2, 1)
    z0 = ops.conv(x1, pre + "P0.P0", 1, 1, True)
    out_gate = torch.sigmoid(ops.conv(torch.cat([z0, code], 1), pre + "P0.out_gates", 1, 1,
                                      True))
    lstc_cell = forget_gate * lstc_cell + in_gate * z0
    z = out_gate * torch.tanh(lstc_cell)
    blk = pre + "lista_blocks.0."
    lam = ops.p[blk + "Lambda"]
    for _ in range(depth):
        x = ops.conv(x1 - ops.conv(z, blk + "D.conv2d", 1, 1, True), blk + "P.conv2d", 1, 1,
                     True) + z
        z = torch.relu(x - lam) - torch.relu(-x - lam)
    rec = torch.relu(ops.conv(z, pre + "Dg.conv.conv2d", 1, 1, True))
    gates = ops.conv(torch.cat([rec, dg_h], 1), pre + "Dg.recurrent_block.Gates", 1, 1, True)
    i_g, r_g, o_g, c_g = gates.chunk(4, 1)
    dg_c = torch.sigmoid(r_g) * dg_c + torch.sigmoid(i_g) * torch.tanh(c_g)
    dg_h = torch.sigmoid(o_g) * torch.tanh(dg_c)
    up = resize(dg_h, events.shape[2:], False)
    up = torch.relu(ops.conv(up, pre + "upsamp_conv.conv2d", 1, 1, True))
    frame = torch.sigmoid(ops.conv(up, pre + "final_conv.conv2d", 1, 1, True))
    return frame, [lstc_cell, z, dg_h, dg_c]


def warp_and_reconstruct(ops: Ops, events, prev_image, state, flow, depth):
    """Warp the previous frame and the sparse code along ``flow`` (the
    code at half size, along the flow resized by 0.5 without rescaling its
    magnitudes, as the published model does), then CISTA-LSTC."""
    gate = torch.any(flow != 0)
    warped = frame_warp(prev_image, flow, gate)
    h, w = flow.shape[2:]
    half = resize(flow, (h // 2, w // 2), True)
    state = list(state)
    state[1] = frame_warp(state[1], half, gate)
    return cista_lstc(ops, events, warped, state, depth)
