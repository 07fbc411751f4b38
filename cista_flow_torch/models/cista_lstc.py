"""CISTA-LSTC: unrolled convolutional ISTA video reconstructor (NCHW).

Counterpart of cista_flow_tpu/models/cista_lstc.py (ref:
e2v/e2v_model.py:10-98): event/image heads -> stride-2 fusion -> ConvLSTC
initial sparse code -> ``depth`` weight-tied ISTA iterations + the Dg conv
(kernel K3 on the card) -> ConvLSTM -> bilinear x2 decoder -> sigmoid.
``ista_route`` selects the two other kernels that compute the loop (K3a,
K6), each followed by the Dg conv as a plain conv + relu.

The reference registers its one ISTA block ``depth`` times, as
``lista_blocks.{0..depth-1}``; so does this module (one shared parameter
set), so reference state dicts load with ``strict=True``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from ..nn.layers import ConvLayer, ConvLSTC, IstaBlock, RecurrentConvLayer, UpsampleConvLayer
from ..ops.conv import conv2d
from ..ops.cuda_ista import fused_ista
from ..ops.cuda_ista2 import fused_ista_dg, fused_ista_v2

# the ISTA loop's routes: K3 (loop + Dg, the default), K3a and K6 (loop alone)
ISTA_ROUTES = {"dg": None, "v2": fused_ista_v2, "loop": fused_ista}


class CistaState(NamedTuple):
    lstc_cell: torch.Tensor    # (B, 2C, H/2, W/2)
    sparse_code: torch.Tensor  # (B, 2C, H/2, W/2), warped between steps
    dg_hidden: torch.Tensor    # (B, C, H/2, W/2)
    dg_cell: torch.Tensor      # (B, C, H/2, W/2)


def zero_state(batch: int, image_dim, base_channels: int, dtype=torch.float32,
               device=None) -> CistaState:
    h2, w2 = image_dim[0] // 2, image_dim[1] // 2
    c = base_channels

    def z(ch):
        return torch.zeros((batch, ch, h2, w2), dtype=dtype, device=device)
    return CistaState(z(2 * c), z(2 * c), z(c), z(c))


class CistaLSTC(nn.Module):
    def __init__(self, num_bins: int = 5, base_channels: int = 64, depth: int = 5):
        super().__init__()
        c = base_channels
        self.depth = depth
        self.ista_route = "dg"
        self.We = ConvLayer(num_bins, c // 2)
        self.Wi = ConvLayer(1, c // 2)
        self.W0 = ConvLayer(c, c, stride=2)
        self.P0 = ConvLSTC(x_size=c, z_size=2 * c, output_size=2 * c)
        block = IstaBlock(c)
        self.lista_blocks = nn.ModuleList([block] * depth)
        self.Dg = RecurrentConvLayer(2 * c, c)
        self.upsamp_conv = UpsampleConvLayer(c, c, activation="relu")
        self.final_conv = ConvLayer(c, 1)

    def forward(self, events, prev_image, state: CistaState):
        """events (B, bins, H, W); prev_image (B, 1, H, W) warped previous
        reconstruction. Returns (rec (B, 1, H, W), new_state)."""
        x1 = torch.cat([self.We(events), self.Wi(prev_image)], 1)
        x1 = self.W0(x1)
        z, lstc_cell = self.P0(x1, state.sparse_code, state.lstc_cell)

        block = self.lista_blocks[0]
        dg = self.Dg.conv.conv2d
        loop = ISTA_ROUTES[self.ista_route]
        if loop is None:
            z, rec = fused_ista_dg(block.kernel_weights(), dg.weight, dg.bias,
                                   x1, z, self.depth)
        else:
            z = loop(block.kernel_weights(), x1, z, self.depth)
            rec = conv2d(z, dg.weight, dg.bias, padding=1,
                         padding_mode="reflect", relu=True)
        hidden, cell = self.Dg.recurrent_block(rec, (state.dg_hidden, state.dg_cell))

        h, w = events.shape[2:]
        rec = self.upsamp_conv(hidden, out_hw=(h, w))
        rec = torch.sigmoid(self.final_conv(rec))
        return rec, CistaState(lstc_cell, z, hidden, cell)
