"""RAFT update blocks: motion encoders, SepConvGRU, ConvGRU, flow and mask
heads.

Counterpart of cista_flow_tpu/nn/gru.py ``flow_head``, ``sep_conv_gru``,
``basic_motion_encoder_event``, ``precompute_update_ema`` and
``basic_update_block_event``, ``small_motion_encoder`` and
``small_update_block`` (DCEIFlow, ref: DCEIFlow/core/decoder/
with_event_updater.py), ``basic_motion_encoder``, ``mask_head`` and
``basic_update_block`` (E-RAFT, ref: ERAFT/update.py), and ``conv_gru`` and
the heads of ``lite_update_block`` (IDNet, ref: idn/update.py). Zero-padded
convs, NCHW, reference module names. The JAX package's concatenated z/r
gate conv and ``fused_head_stage1`` put several convs on one input into one
for the TPU's lanes; here each stays its own conv.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import conv2d


def _conv(m: nn.Conv2d, x, padding=0):
    return conv2d(x, m.weight, m.bias, 1, padding)


class FlowHead(nn.Module):
    def __init__(self, input_dim=128, hidden_dim=256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3)

    def forward(self, x):
        return _conv(self.conv2, torch.relu(_conv(self.conv1, x, 1)), 1)


class SepConvGRU(nn.Module):
    """Separable 1x5 then 5x1 GRU (ref: with_event_updater.py:35-67)."""

    def __init__(self, hidden_dim=128, input_dim=256):
        super().__init__()
        cin = hidden_dim + input_dim
        for s, k in (("1", (1, 5)), ("2", (5, 1))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", nn.Conv2d(cin, hidden_dim, k))

    def forward(self, h, x):
        for s, pad in (("1", (0, 2)), ("2", (2, 0))):
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(_conv(getattr(self, "convz" + s), hx, pad))
            r = torch.sigmoid(_conv(getattr(self, "convr" + s), hx, pad))
            q = torch.tanh(_conv(getattr(self, "convq" + s),
                                 torch.cat([r * h, x], 1), pad))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    """3x3 ConvGRU (ref: ERAFT/update.py ConvGRU, idn/update.py)."""

    def __init__(self, hidden_dim=96, input_dim=64):
        super().__init__()
        for g in "zrq":
            setattr(self, f"conv{g}", nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3))

    def forward(self, h, x):
        hx = torch.cat([h, x], 1)
        z = torch.sigmoid(_conv(self.convz, hx, 1))
        r = torch.sigmoid(_conv(self.convr, hx, 1))
        q = torch.tanh(_conv(self.convq, torch.cat([r * h, x], 1), 1))
        return (1 - z) * h + z * q


class BasicMotionEncoderEvent(nn.Module):
    """Event-conditioned motion encoder (ref: with_event_updater.py:90-112).
    ``convc1`` is applied inside the correlation lookup (kernel K1), so
    ``forward`` takes the projected correlation features."""

    def __init__(self, cor_planes=324):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3)
        self.conve1 = nn.Conv2d(256, 128, 1)
        self.conve2 = nn.Conv2d(128, 64, 3)
        self.convf1 = nn.Conv2d(2, 128, 7)
        self.convf2 = nn.Conv2d(128, 64, 3)
        self.conv = nn.Conv2d(64 + 192 + 64, 128 - 2, 3)

    def encode_event(self, emap):
        """conve1/conve2 branch: the same in every GRU iteration, so it runs
        once per flow call (``precompute_update_ema``)."""
        ema = torch.relu(_conv(self.conve1, emap))
        return torch.relu(_conv(self.conve2, ema, 1))

    def forward(self, flow, ema, cor):
        cor = torch.relu(_conv(self.convc2, cor, 1))
        flo = torch.relu(_conv(self.convf1, flow, 3))
        flo = torch.relu(_conv(self.convf2, flo, 1))
        out = torch.relu(_conv(self.conv, torch.cat([cor, ema, flo], 1), 1))
        return torch.cat([out, flow], 1)


class BasicUpdateBlockEvent(nn.Module):
    """BasicUpdateBlockNoMask (ref: with_event_updater.py:156-171)."""

    def __init__(self, cor_planes=324, hidden_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoderEvent(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)

    def precompute_update_ema(self, emap):
        return self.encoder.encode_event(emap)

    def forward(self, net, inp, cor, ema, flow):
        # corr features and the f32 flow enter in the block's dtype
        cor = cor.to(net.dtype)
        flow = flow.to(net.dtype)
        motion = self.encoder(flow, ema, cor)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, self.flow_head(net)


class BasicMotionEncoder(nn.Module):
    """Event-free motion encoder (ref: ERAFT/update.py:63-81). With
    ``corr_projected`` the correlation features already carry
    relu(convc1(lookup)), fused into kernel K1."""

    def __init__(self, cor_planes=324):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3)
        self.convf1 = nn.Conv2d(2, 128, 7)
        self.convf2 = nn.Conv2d(128, 64, 3)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3)

    def forward(self, flow, cor, corr_projected=False):
        if not corr_projected:
            cor = torch.relu(_conv(self.convc1, cor))
        cor = torch.relu(_conv(self.convc2, cor, 1))
        flo = torch.relu(_conv(self.convf1, flow, 3))
        flo = torch.relu(_conv(self.convf2, flo, 1))
        out = torch.relu(_conv(self.conv, torch.cat([cor, flo], 1), 1))
        return torch.cat([out, flow], 1)


class MaskHead(nn.Sequential):
    """conv3x3 -> relu -> conv1x1 to the 9*64 convex-upsampling logits; a
    Sequential, so its parameters are ``0.*`` and ``2.*`` as in the
    reference (ref: ERAFT/update.py:92-95)."""

    def __init__(self, hidden_dim=128, out_ch=64 * 9):
        super().__init__(nn.Conv2d(hidden_dim, 256, 3), nn.ReLU(),
                         nn.Conv2d(256, out_ch, 1))

    def forward(self, x):
        return _conv(self[2], torch.relu(_conv(self[0], x, 1)))


class BasicUpdateBlock(nn.Module):
    """E-RAFT's update block with the upsampling mask (ref:
    ERAFT/update.py:84-106). The flow and mask heads stay separate convs."""

    def __init__(self, cor_planes=324, hidden_dim=128):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = MaskHead(hidden_dim, 64 * 9)

    def forward(self, net, inp, cor, flow, corr_projected=False):
        """Returns (net, mask, delta_flow); the mask logits are scaled by
        0.25 as in the reference."""
        cor = cor.to(net.dtype)
        flow = flow.to(net.dtype)
        motion = self.encoder(flow, cor, corr_projected)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


class SmallMotionEncoder(nn.Module):
    """The event-conditioned small motion encoder (ref:
    with_event_updater.py:70-87; the JAX package's ``small_motion_encoder``):
    relu'd 1x1 convs of the correlation (to 96) and of the event map (128
    -> 64), the flow through a 7x7 and a 3x3 conv (to 32), then a 3x3 conv
    to 80 channels with the flow appended (82)."""

    def __init__(self, cor_planes=324):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 96, 1)
        self.conve1 = nn.Conv2d(128, 64, 1)
        self.convf1 = nn.Conv2d(2, 64, 7)
        self.convf2 = nn.Conv2d(64, 32, 3)
        self.conv = nn.Conv2d(96 + 32 + 64, 80, 3)

    def forward(self, flow, emap, corr):
        cor = torch.relu(_conv(self.convc1, corr))
        ema = torch.relu(_conv(self.conve1, emap))
        flo = torch.relu(_conv(self.convf1, flow, 3))
        flo = torch.relu(_conv(self.convf2, flo, 1))
        out = torch.relu(_conv(self.conv, torch.cat([cor, ema, flo], 1), 1))
        return torch.cat([out, flow], 1)


class SmallUpdateBlock(nn.Module):
    """SmallUpdateBlock (ref: with_event_updater.py:115-128; the JAX
    package's ``small_update_block``): the small motion encoder, a 3x3
    ConvGRU over the context (64) and the motion features (82), and a flow
    head at ``hidden_dim`` -> 128."""

    def __init__(self, cor_planes=324, hidden_dim=96):
        super().__init__()
        self.encoder = SmallMotionEncoder(cor_planes)
        self.gru = ConvGRU(hidden_dim, 82 + 64)
        self.flow_head = FlowHead(hidden_dim, 128)

    def forward(self, net, inp, corr, emap, flow):
        """Returns (net, None, delta_flow), as the JAX function (no mask)."""
        corr = corr.to(net.dtype)
        flow = flow.to(net.dtype)
        motion = self.encoder(flow, emap, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, None, self.flow_head(net)


class LiteUpdateBlock(nn.Module):
    """IDNet's LiteUpdateBlock (ref: idn/update.py:47-64): a ConvGRU, a flow
    head with its convex-upsampling mask head and, with ``num_outputs=2``
    (CISTA-Flow's), a second pair for the next step's flow. The mask logits
    are not scaled."""

    def __init__(self, hidden_dim=96, input_dim=64, downsample=8, num_outputs=2):
        super().__init__()
        mdim = downsample * downsample * 9
        self.gru = ConvGRU(hidden_dim, input_dim)
        self.flow_head = FlowHead(hidden_dim, hidden_dim)
        self.mask = MaskHead(hidden_dim, mdim)
        if num_outputs == 2:
            self.flow_head2 = FlowHead(hidden_dim, hidden_dim)
            self.mask2 = MaskHead(hidden_dim, mdim)

    def heads(self, net):
        """(delta flow, mask logits) and the next step's pair (None without
        the second head), at 1/8 resolution."""
        second = ((self.flow_head2(net), self.mask2(net)) if hasattr(self, "flow_head2")
                  else None)
        return (self.flow_head(net), self.mask(net)), second
