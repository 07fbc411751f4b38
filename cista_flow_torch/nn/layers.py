"""CISTA-LSTC building blocks (NCHW ``nn.Module``s with the reference's names).

Counterpart of cista_flow_tpu/nn/layers.py (ref: e2v/base_layers.py).
Parameter names follow the reference modules so that its state dicts load
with ``strict=True``. All convs here are reflect-padded.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import bands
from ..ops.conv import conv2d
from ..ops.cuda_ista2 import softshrink
from ..ops.resize import resize_bilinear

_ACTS = {None: lambda x: x, "relu": torch.relu, "sigmoid": torch.sigmoid,
         "tanh": torch.tanh}

__all__ = ["softshrink", "ConvLayer", "UpsampleConvLayer", "ConvLSTC",
           "ConvLSTM", "IstaBlock", "RecurrentConvLayer", "doubletanh",
           "RecurrentUpsampleConvLayer", "DecayGates", "NeuronLSTC"]


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
    (ref: base_layers.py:168-212). On a row band of the frame, the band's
    rows of the frame's x2 resize (from one halo row of each neighbour)."""

    def __init__(self, cin, cout, kernel_size=3, activation=None):
        super().__init__()
        self.conv2d = nn.Conv2d(cin, cout, kernel_size)
        self.activation = activation

    def forward(self, x, out_hw=None):
        h, w = x.shape[2:]
        target = out_hw if out_hw is not None else (2 * h, 2 * w)
        pad = (self.conv2d.kernel_size[0] - 1) // 2
        if bands.active() is not None:
            y = bands.resize(x, 2, 1, padded=False, align_corners=False)
        else:
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
    """ConvLayer -> ConvLSTM (ref: base_layers.py:216-227); CISTA-LSTC's
    Dg stage, whose model runs the two parts itself. ``forward`` is the JAX
    package's ``recurrent_conv_layer``."""

    def __init__(self, cin, cout, activation="relu"):
        super().__init__()
        self.conv = ConvLayer(cin, cout, activation=activation)
        self.recurrent_block = ConvLSTM(cout, cout)

    def forward(self, x, state):
        """state = (hidden, cell) -> (hidden, (hidden, cell))."""
        hidden, cell = self.recurrent_block(self.conv(x), state)
        return hidden, (hidden, cell)


# ---- the reference's variants, defined there and unused by its shipped
# ---- models (ref: base_layers.py:14-15, 230-358)

def doubletanh(x, u, lambd):
    """The alternative proximal op u * (tanh(x + l) + tanh(x - l)) (ref:
    base_layers.py:14-15)."""
    return u * (torch.tanh(x + lambd) + torch.tanh(x - lambd))


class RecurrentUpsampleConvLayer(nn.Module):
    """UpsampleConvLayer -> ConvLSTM (ref: base_layers.py:230-240); module
    names as ``RecurrentConvLayer``'s."""

    def __init__(self, cin, cout, activation=None):
        super().__init__()
        self.conv = UpsampleConvLayer(cin, cout, activation=activation)
        self.recurrent_block = ConvLSTM(cout, cout)

    def forward(self, x, state):
        """state = (hidden, cell) at twice x's size -> (hidden, (hidden, cell))."""
        hidden, cell = self.recurrent_block(self.conv(x), state)
        return hidden, (hidden, cell)


class DecayGates(nn.Module):
    """'get_decay_simmp', the mixed max/avg-pool gating MLP (ref:
    base_layers.py:243-281, its 'mix' configuration). ``forward(x)``:
    fc2(relu(fc1(max over the frame of x))); ``forward(x, x1)``:
    fc2(relu(fc3([max of x1, mean of x]))), hidden widths a quarter of the
    inputs' (the reference's reduction 4). Returns (B, num_gates)."""

    def __init__(self, channels1, channels2, num_gates=3):
        super().__init__()
        self.fc1 = nn.Linear(channels1, channels1 // 4)
        self.fc2 = nn.Linear(channels2 // 4, num_gates)
        self.fc3 = nn.Linear(channels1 + channels2, channels2 // 4)

    def forward(self, x, x1=None):
        if x1 is None:
            return self.fc2(torch.relu(self.fc1(x.amax(dim=(2, 3)))))
        theta = torch.cat([x1.amax(dim=(2, 3)), x.mean(dim=(2, 3))], 1)
        return self.fc2(torch.relu(self.fc3(theta)))


class NeuronLSTC(nn.Module):
    """The NeuronLSTC variant (ref: base_layers.py:283-321): input, forget
    and output gates, one scalar each per sample, from ``DecayGates`` over
    the input and its 1x1 conv, instead of gate convs."""

    def __init__(self, x_size, output_size):
        super().__init__()
        self.P0 = ConvLayer(x_size, output_size)
        self.conv1x1 = ConvLayer(x_size, 3 * output_size, 1, padding=0)
        self.gates = DecayGates(x_size, 3 * output_size, 3)

    def forward(self, x, prev_z0):
        g = torch.sigmoid(self.gates(x, self.conv1x1(x)))[:, :, None, None]
        in_g, forget_g, out_g = g[:, 0:1], g[:, 1:2], g[:, 2:3]
        z0 = forget_g * prev_z0 + in_g * self.P0(x)
        return out_g * torch.tanh(z0)
