"""RAFT BasicEncoder and its residual blocks (NCHW ``nn.Module``s).

Counterpart of cista_flow_tpu/nn/encoders.py ``residual_block`` and
``basic_encoder`` (ref: DCEIFlow/core/backbone/raft_encoder.py:125-203),
with instance norm (kernel K4 on the card) or eval-mode batch norm. Convs
are zero-padded; the square 64- and 128-channel ones are kernel K5 on the
card. Module names follow the reference, so its state dicts load with
``strict=True``. An encoder's ``norm_route`` selects how its instance norms
run: "fused" (K4, the default) or "stats" (K4s, then a plain elementwise
normalise), the two routes of the JAX package's ``conv.instance_norm``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.conv import batch_norm, conv2d, instance_norm
from ..ops.cuda_norm import instance_norm_from_stats

NORM_ROUTES = {"fused": instance_norm, "stats": instance_norm_from_stats}


class _Normed(nn.Module):
    norm_fn = "instance"
    _norm_route = "fused"

    def norm(self, x, bn: nn.BatchNorm2d | None, relu: bool):
        if self.norm_fn == "instance":
            return NORM_ROUTES[self._norm_route](x, relu=relu)
        y = batch_norm(x, bn)
        return torch.relu(y) if relu else y


class ResidualBlock(_Normed):
    def __init__(self, cin, cout, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        batch = norm_fn == "batch"
        self.norm1 = nn.BatchNorm2d(cout) if batch else None
        self.norm2 = nn.BatchNorm2d(cout) if batch else None
        self.norm3 = None
        self.downsample = None
        if stride != 1:
            down = nn.Conv2d(cin, cout, 1, stride=stride)
            if batch:
                # the reference registers norm3 both as an attribute and
                # inside the downsample Sequential (same module)
                self.norm3 = nn.BatchNorm2d(cout)
                self.downsample = nn.Sequential(down, self.norm3)
            else:
                self.downsample = nn.Sequential(down)

    def forward(self, x):
        y = conv2d(x, self.conv1.weight, self.conv1.bias, self.stride, 1)
        y = self.norm(y, self.norm1, relu=True)
        y = conv2d(y, self.conv2.weight, self.conv2.bias, 1, 1)
        y = self.norm(y, self.norm2, relu=True)
        if self.downsample is not None:
            down = self.downsample[0]
            x = conv2d(x, down.weight, down.bias, self.stride, 0)
            x = self.norm(x, self.norm3, relu=False)
        return torch.relu(x + y)


class BasicEncoder(_Normed):
    """7x7 head (stride 2 for ds=8) + 3 residual stages (64/96/128) + 1x1
    output conv (ref: raft_encoder.py:125-177)."""

    def __init__(self, input_dim, output_dim, norm_fn="instance", ds=8):
        super().__init__()
        self.norm_fn = norm_fn
        self.stride1 = 2 if ds == 8 else 1
        self.conv1 = nn.Conv2d(input_dim, 64, 7, stride=self.stride1, padding=3)
        self.norm1 = nn.BatchNorm2d(64) if norm_fn == "batch" else None
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (cin, cout, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, cout, norm_fn, stride),
                ResidualBlock(cout, cout, norm_fn, 1)))
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    @property
    def norm_route(self) -> str:
        return self._norm_route

    @norm_route.setter
    def norm_route(self, route: str) -> None:
        """Applies to this encoder's own norm and its residual blocks'."""
        if route not in NORM_ROUTES:
            raise ValueError(f"norm_route {route!r} not in {sorted(NORM_ROUTES)}")
        for m in self.modules():
            if isinstance(m, _Normed):
                m._norm_route = route

    def forward(self, x):
        y = conv2d(x, self.conv1.weight, self.conv1.bias, self.stride1, 3)
        y = self.norm(y, self.norm1, relu=True)
        y = self.layer3(self.layer2(self.layer1(y)))
        return conv2d(y, self.conv2.weight, self.conv2.bias)
