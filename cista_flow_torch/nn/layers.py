"""CISTA-LSTC building blocks (NCHW ``nn.Module``s with the reference's names).

Counterpart of cista_flow_tpu/nn/layers.py (ref: e2v/base_layers.py).
Parameter names follow the reference modules so that its state dicts load
with ``strict=True``. All convs here are reflect-padded.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import conv2d
from ..ops.cuda_ista2 import softshrink
from ..ops.resize import resize_bilinear

_ACTS = {None: lambda x: x, "relu": torch.relu, "sigmoid": torch.sigmoid,
         "tanh": torch.tanh}

__all__ = ["softshrink", "ConvLayer", "UpsampleConvLayer", "ConvLSTC",
           "ConvLSTM", "IstaBlock", "RecurrentConvLayer"]


def _conv(m: nn.Conv2d, x, stride=1, padding=0, activation=None):
    """Reflect-padded conv + activation; a relu goes into the conv call
    (fused where the conv is kernel K5)."""
    relu = activation == "relu"
    y = conv2d(x, m.weight, m.bias, stride, padding, "reflect", relu=relu)
    return y if relu else _ACTS[activation](y)


class ConvLayer(nn.Module):
    """Reflect-padded conv + optional activation (ref: base_layers.py:137-163)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=1,
                 activation=None):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, kernel_size)
        self.stride, self.padding, self.activation = stride, padding, activation

    def forward(self, x):
        return _conv(self.conv2d, x, self.stride, self.padding, self.activation)


class UpsampleConvLayer(nn.Module):
    """Bilinear x2 (align_corners=False) -> reflect pad -> conv
    (ref: base_layers.py:168-212)."""

    def __init__(self, cin, cout, kernel_size=3, activation=None):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, kernel_size)
        self.activation = activation

    def forward(self, x, out_hw=None):
        h, w = x.shape[2:]
        target = out_hw if out_hw is not None else (2 * h, 2 * w)
        pad = (self.conv2d.kernel_size[0] - 1) // 2
        y = resize_bilinear(x, target, align_corners=False)
        return _conv(self.conv2d, y, padding=pad, activation=self.activation)


class ConvLSTC(nn.Module):
    """LSTC cell for sparse codes (ref: base_layers.py:38-71)."""

    def __init__(self, x_size, z_size, output_size, kernel_size=3):
        super().__init__()
        self.gates = nn.Conv2d(x_size + z_size, 2 * output_size, kernel_size)
        self.out_gates = nn.Conv2d(z_size + output_size, output_size, kernel_size)
        self.P0 = nn.Conv2d(x_size, output_size, kernel_size)

    def forward(self, x, z, prev_cell):
        pad = self.gates.kernel_size[0] // 2
        g = _conv(self.gates, torch.cat([x, z], 1), padding=pad)
        in_gate, forget_gate = torch.sigmoid(g).chunk(2, 1)
        z0 = _conv(self.P0, x, padding=pad)
        out_gate = torch.sigmoid(_conv(self.out_gates, torch.cat([z0, z], 1),
                                       padding=pad))
        cell = forget_gate * prev_cell + in_gate * z0
        return out_gate * torch.tanh(cell), cell


class ConvLSTM(nn.Module):
    """4-gate ConvLSTM (ref: base_layers.py:75-132)."""

    def __init__(self, input_size, hidden_size, kernel_size=3):
        super().__init__()
        self.Gates = nn.Conv2d(input_size + hidden_size, 4 * hidden_size,
                               kernel_size)

    def forward(self, x, state):
        h, c = state
        pad = self.Gates.kernel_size[0] // 2
        g = _conv(self.Gates, torch.cat([x, h], 1), padding=pad)
        in_gate, remember, out_gate, cell_gate = g.chunk(4, 1)
        cell = torch.sigmoid(remember) * c + torch.sigmoid(in_gate) * torch.tanh(cell_gate)
        return torch.sigmoid(out_gate) * torch.tanh(cell), cell


class IstaBlock(nn.Module):
    """D: 2C->C, P: C->2C, Lambda (1, 2C, 1, 1) (ref: base_layers.py:21-31).
    Its iteration, z <- softshrink(P(x1 - D(z)) + z, Lambda), runs in kernel
    K3 (ops/cuda_ista2.py, with the plain version beside it)."""

    def __init__(self, base_channels):
        super().__init__()
        c = base_channels
        self.D = ConvLayer(2 * c, c)
        self.P = ConvLayer(c, 2 * c)
        self.Lambda = nn.Parameter(0.001 * torch.rand(1, 2 * c, 1, 1))

    def kernel_weights(self):
        """(dw, db, pw, pb, lam) as the fused ISTA kernel takes them."""
        return (self.D.conv2d.weight, self.D.conv2d.bias, self.P.conv2d.weight,
                self.P.conv2d.bias, self.Lambda.reshape(-1))


class RecurrentConvLayer(nn.Module):
    """ConvLayer -> ConvLSTM (ref: base_layers.py:216-227); the Dg stage."""

    def __init__(self, cin, cout, activation="relu"):
        super().__init__()
        self.conv = ConvLayer(cin, cout, activation=activation)
        self.recurrent_block = ConvLSTM(cout, cout)
