"""RAFT's BasicEncoder and SmallEncoder, IDNet's LiteEncoder and their
residual and bottleneck blocks (NCHW ``nn.Module``s).

Counterpart of cista_flow_tpu/nn/encoders.py ``residual_block``,
``basic_encoder`` (ref: DCEIFlow/core/backbone/raft_encoder.py:125-203),
``bottleneck_block``, ``small_encoder`` (ref: raft_encoder.py:62-122,
206-255) and ``lite_encoder`` (ref: idn/extractor.py:63-104), with instance norm (kernel
K4 on the card), batch norm, group norm (plain PyTorch, ``conv.group_norm``:
the stems in 8 groups, a residual or bottleneck block's norms in its output
width // 8, as there) or no norm. Convs are zero-padded;
the square 64- and 128-channel ones are kernel K5 on the card. Module names
follow the reference, so its state dicts load with ``strict=True``; conv
weights start as the reference initialises them (``_kaiming``). An
encoder's ``norm_route`` selects how its instance norms run: "fused" (K4,
the default) or "stats" (K4s, then a plain elementwise normalise), the two
routes of the JAX package's ``conv.instance_norm``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops import bands
from ..ops.conv import batch_norm, conv2d, group_norm, instance_norm
from ..ops.cuda_norm import instance_norm_from_stats

NORM_ROUTES = {"fused": instance_norm, "stats": instance_norm_from_stats}


def _kaiming(*convs: nn.Conv2d) -> None:
    """The RAFT encoders' explicit init of their conv weights, kaiming normal
    over fan_out for a relu (ref: DCEIFlow/core/backbone/raft_encoder.py:
    160-168; the JAX package's ``KAIMING``); biases keep torch's default,
    as there."""
    for conv in convs:
        nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")


def _norm_module(norm_fn: str, ch: int, num_groups: int) -> nn.Module | None:
    """The parameters of one norm site under the reference's module (None
    where the norm has none)."""
    if norm_fn == "batch":
        return nn.BatchNorm2d(ch)
    if norm_fn == "group":
        return nn.GroupNorm(num_groups, ch)
    if norm_fn in ("instance", "none"):
        return None
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


class _Normed(nn.Module):
    norm_fn = "instance"
    _norm_route = "fused"
    _encoder = None            # the encoder a block belongs to, for messages

    def norm(self, x, mod: nn.Module | None, relu: bool):
        if self.norm_fn == "instance":
            if bands.active() is not None:      # a row band: both routes combine K4s's statistics
                return instance_norm(x, relu=relu)
            return NORM_ROUTES[self._norm_route](x, relu=relu)
        if self.norm_fn == "group":
            if bands.active() is not None:
                raise ValueError(f"{self._encoder or type(self).__name__}: group norm's "
                                 "statistics span the whole frame; it has no row-band form")
            y = group_norm(x, mod.weight, mod.bias, mod.num_groups, mod.eps)
        else:
            y = x if self.norm_fn == "none" else batch_norm(x, mod)
        return torch.relu(y) if relu else y

    def _name_blocks(self) -> None:
        for m in self.modules():
            if isinstance(m, _Normed):
                m._encoder = type(self).__name__


class ResidualBlock(_Normed):
    def __init__(self, cin, cout, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.stride = stride
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        groups = max(cout // 8, 1)
        self.norm1 = _norm_module(norm_fn, cout, groups)
        self.norm2 = _norm_module(norm_fn, cout, groups)
        self.norm3 = None
        self.downsample = None
        if stride != 1:
            down = nn.Conv2d(cin, cout, 1, stride=stride)
            # the reference registers norm3 both as an attribute and inside
            # the downsample Sequential (same module)
            self.norm3 = _norm_module(norm_fn, cout, groups)
            self.downsample = nn.Sequential(down, *(() if self.norm3 is None else (self.norm3,)))
        _kaiming(self.conv1, self.conv2, *(() if self.downsample is None
                                           else (self.downsample[0],)))

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
        self.norm1 = _norm_module(norm_fn, 64, 8)
        dims = [(64, 64, 1), (64, 96, 2), (96, 128, 2)]
        for i, (cin, cout, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, cout, norm_fn, stride),
                ResidualBlock(cout, cout, norm_fn, 1)))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        _kaiming(self.conv1, self.conv2)
        self._name_blocks()

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


class BottleneckBlock(_Normed):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck to ``cout`` with a 1x1
    downsample at stride 2 (ref: raft_encoder.py:62-122; the JAX package's
    ``bottleneck_block``)."""

    def __init__(self, cin, cout, norm_fn="instance", stride=1):
        super().__init__()
        self.norm_fn = norm_fn
        self.stride = stride
        mid = cout // 4
        self.conv1 = nn.Conv2d(cin, mid, 1)
        self.conv2 = nn.Conv2d(mid, mid, 3, padding=1, stride=stride)
        self.conv3 = nn.Conv2d(mid, cout, 1)
        groups = max(cout // 8, 1)         # all four norms, the mid-width ones too
        self.norm1 = _norm_module(norm_fn, mid, groups)
        self.norm2 = _norm_module(norm_fn, mid, groups)
        self.norm3 = _norm_module(norm_fn, cout, groups)
        self.norm4 = None
        self.downsample = None
        if stride != 1:
            down = nn.Conv2d(cin, cout, 1, stride=stride)
            self.norm4 = _norm_module(norm_fn, cout, groups)
            self.downsample = nn.Sequential(down, *(() if self.norm4 is None else (self.norm4,)))
        _kaiming(self.conv1, self.conv2, self.conv3,
                 *(() if self.downsample is None else (self.downsample[0],)))

    def forward(self, x):
        y = conv2d(x, self.conv1.weight, self.conv1.bias)
        y = self.norm(y, self.norm1, relu=True)
        y = conv2d(y, self.conv2.weight, self.conv2.bias, self.stride, 1)
        y = self.norm(y, self.norm2, relu=True)
        y = conv2d(y, self.conv3.weight, self.conv3.bias)
        y = self.norm(y, self.norm3, relu=True)
        if self.downsample is not None:
            down = self.downsample[0]
            x = conv2d(x, down.weight, down.bias, self.stride, 0)
            x = self.norm(x, self.norm4, relu=False)
        return torch.relu(x + y)


class SmallEncoder(BasicEncoder):
    """RAFT's SmallEncoder: a 7x7 stride-2 head to 32 channels, three
    stages of bottleneck blocks (32, 64, 96; strides 1, 2, 2) and a 1x1
    output conv, 1/8 of the input resolution (ref: raft_encoder.py:206-255;
    the JAX package's ``small_encoder``). ``norm_route`` as BasicEncoder's."""

    def __init__(self, input_dim=3, output_dim=128, norm_fn="batch"):
        nn.Module.__init__(self)
        self.norm_fn = norm_fn
        self.stride1 = 2
        self.conv1 = nn.Conv2d(input_dim, 32, 7, stride=2, padding=3)
        self.norm1 = _norm_module(norm_fn, 32, 8)
        dims = [(32, 32, 1), (32, 64, 2), (64, 96, 2)]
        for i, (cin, cout, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                BottleneckBlock(cin, cout, norm_fn, stride),
                BottleneckBlock(cout, cout, norm_fn, 1)))
        self.conv2 = nn.Conv2d(96, output_dim, 1)
        _kaiming(self.conv1, self.conv2)
        self._name_blocks()


class LiteEncoder(nn.Module):
    """IDNet's LiteEncoder with norm 'none' at stride 2 (ref:
    idn/extractor.py:63-104): a 7x7 stride-2 head + relu, then two stages
    of residual blocks, each stage stride 2 (dim -> dim -> 2*dim): 1/8 of
    the input resolution. Its 64->64 stride-1 convs are kernel K5."""

    def __init__(self, n_first_channels=2, output_dim=32):
        super().__init__()
        self.conv1 = nn.Conv2d(n_first_channels, output_dim, 7, stride=2, padding=3)
        _kaiming(self.conv1)
        dims = [(output_dim, output_dim, 2), (output_dim, 2 * output_dim, 2)]
        for i, (cin, cout, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, cout, "none", stride),
                ResidualBlock(cout, cout, "none", 1)))

    def forward(self, x):
        y = torch.relu(conv2d(x, self.conv1.weight, self.conv1.bias, 2, 3))
        return self.layer2(self.layer1(y))
