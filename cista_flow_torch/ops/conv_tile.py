"""What the tensor-core 3x3 conv tile (csrc/conv3x3_mma.cuh) wants prepared
outside the kernel, as plain PyTorch that also runs on the CPU: the weight
repack with its cache, and the channel-grouped activation layout that K3
keeps between its launches.

The JAX package prepares its kernels' weights outside them too
(cista_flow_tpu/ops/pallas_ista2.py ``_prep_weights``).

Layouts:
 * packed weights ``(Cin/8, 9, Cout, 8)``: ``packed[g, 3*ky + kx, o, c] =
   w[o, 8*g + c, ky, kx]`` for OIHW ``w``. For one tap and one group of 8
   input channels, 8 neighbouring outputs are 128 contiguous bytes in bf16:
   one core matrix of wgmma's B operand.
 * grouped activations ``(B, C/8, H, W, 8)``: ``grouped[b, g, y, x, c] =
   x[b, 8*g + c, y, x]``; a pixel's 8 channels are one 16-byte chunk.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

GROUP = 8                 # channels per 16-byte chunk in bf16
TILE_ROWS = 8             # rows of a tile (conv3x3_mma.cuh TH)
CACHE_ENTRIES = 256       # prepared tensors kept, least recently used first out

# (kind, data_ptr, shape, stride, dtype, device, target dtype) ->
# (version, source, prepared). The entry holds its source tensor, so the
# storage behind data_ptr cannot be freed and handed to another tensor
# while the entry lives; an in-place update bumps ``_version`` and misses.
_CACHE: OrderedDict = OrderedDict()


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW (Cout, Cin, 3, 3) -> (Cin/8, 9, Cout, 8), contiguous."""
    cout, cin, kh, kw = w.shape
    if (kh, kw) != (3, 3) or cin % GROUP != 0:
        raise ValueError(f"pack_weights: {tuple(w.shape)} is not (Cout, 8k, 3, 3)")
    return w.reshape(cout, cin // GROUP, GROUP, 9).permute(1, 3, 0, 2).contiguous()


def conv3x3_from_packed(x: torch.Tensor, packed: torch.Tensor,
                        padding_mode: str = "zeros") -> torch.Tensor:
    """The conv as the tile computes it, from packed weights: pad by 1, then
    sum over channel groups, taps and the 8 channels of a group."""
    b, c, h, w = x.shape
    xp = torch.nn.functional.pad(
        x, (1, 1, 1, 1), mode="reflect" if padding_mode == "reflect" else "constant")
    taps = torch.stack([xp[:, :, ky:ky + h, kx:kx + w]
                        for ky in range(3) for kx in range(3)], 1)      # (B, 9, C, H, W)
    taps = taps.reshape(b, 9, c // GROUP, GROUP, h, w)
    return torch.einsum("btgchw,gtoc->bohw", taps, packed)


def to_grouped(x: torch.Tensor) -> torch.Tensor:
    """NCHW (B, C, H, W) -> (B, C/8, H, W, 8), contiguous."""
    b, c, h, w = x.shape
    if c % GROUP != 0:
        raise ValueError(f"to_grouped: {c} channels are no multiple of {GROUP}")
    return x.reshape(b, c // GROUP, GROUP, h, w).permute(0, 1, 3, 4, 2).contiguous()


def from_grouped(g: torch.Tensor) -> torch.Tensor:
    """(B, C/8, H, W, 8) -> NCHW (B, C, H, W), contiguous."""
    b, groups, h, w, c8 = g.shape
    return g.permute(0, 1, 4, 2, 3).reshape(b, groups * c8, h, w).contiguous()


def reflect_clamp(i: int, n: int) -> int:
    """csrc/common.cuh ``reflect_clamp``: the reflected index of a position
    at most one step outside [0, n), clamped into range past a ragged edge."""
    if i < 0:
        i = -i
    if i >= n:
        i = 2 * n - 2 - i
    return min(max(i, 0), n - 1)


def staged_tile(g: torch.Tensor, y0: int, x0: int, tile_w: int,
                reflect: bool = True) -> torch.Tensor:
    """The halo tile that a block stages from a grouped tensor for the tile
    at (y0, x0): (B, C/8, TILE_ROWS + 2, tile_w + 2, 8), with the kernel's
    index rule (a reflected index, or zeros outside the frame)."""
    _, _, h, w, _ = g.shape
    ys = [y0 + i - 1 for i in range(TILE_ROWS + 2)]
    xs = [x0 + j - 1 for j in range(tile_w + 2)]
    if reflect:
        iy = torch.tensor([reflect_clamp(y, h) for y in ys])
        ix = torch.tensor([reflect_clamp(x, w) for x in xs])
        return g[:, :, iy][:, :, :, ix]
    iy = torch.tensor([min(max(y, 0), h - 1) for y in ys])
    ix = torch.tensor([min(max(x, 0), w - 1) for x in xs])
    my = torch.tensor([0 <= y < h for y in ys], dtype=g.dtype)
    mx = torch.tensor([0 <= x < w for x in xs], dtype=g.dtype)
    return g[:, :, iy][:, :, :, ix] * (my[:, None] * mx[None, :])[None, None, :, :, None]


def _cached(kind: str, t: torch.Tensor, dtype: torch.dtype, make) -> torch.Tensor:
    if t.is_inference():                 # no version counter to watch
        return make(t)
    key = (kind, t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype, t.device, dtype)
    hit = _CACHE.get(key)
    if hit is not None and hit[0] == t._version:
        _CACHE.move_to_end(key)
        return hit[2]
    out = make(t)
    _CACHE[key] = (t._version, t, out)
    _CACHE.move_to_end(key)
    while len(_CACHE) > CACHE_ENTRIES:
        _CACHE.popitem(last=False)
    return out


def packed_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pack_weights(w)`` in ``dtype``, prepared once per weight tensor: the
    same tensor gives the same object until it is updated in place."""
    return _cached("packed", w, dtype, lambda t: pack_weights(t.detach().to(dtype)))


def cast_cached(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``: itself when it has that dtype, else a copy made
    once per tensor as ``packed_weights`` makes its repack."""
    if t.dtype == dtype:
        return t
    return _cached("cast", t, dtype, lambda s: s.detach().to(dtype))


def clear_cache() -> None:
    _CACHE.clear()
