"""Event voxelization and normalisation on the device.

Counterpart of cista_flow_tpu/ops/voxel.py (ref: utils/event_process.py:
15-72, 193-216): N events ``[t, x, y, p]`` are split bilinearly in time
between two of ``num_bins`` bins and added into a (num_bins, H, W) grid.
The JAX package's ``segment_sum`` over the flat grid is ``index_add_`` here.
Event counts vary, so the events come in a fixed-capacity buffer with a
validity mask; masked entries add nothing.

The time arithmetic runs in the dtype of ``t``: f32 as in the JAX package,
or f64 (the host's timestamps as read), which is what the numpy golden
(``events.voxel``) computes; the sums then run in f64 too and are rounded to
f32 once. ``index_add_`` on a CUDA tensor adds with atomics in no fixed
order, so f32 sums differ from the sequential numpy sums by a few ulps of
a cell's magnitude; f64 sums rounded once make that order invisible in
all but the rarest ties. The eval CLIs voxelize on the host, as the JAX
CLIs do; this module is their device counterpart.
"""
from __future__ import annotations

import torch


def events_to_voxel_grid(t: torch.Tensor, x: torch.Tensor, y: torch.Tensor, p: torch.Tensor,
                         num_bins: int, height: int, width: int,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Voxelize a fixed-capacity event buffer: t (N,) f32 or f64, x and y
    (N,) integer pixel coordinates, p (N,) polarity in {0, 1} or {-1, 1}
    (0 counts as -1, as in the reference), ``valid`` (N,) bool or None
    (all valid). Returns the (num_bins, height, width) f32 grid; the first
    and last valid timestamps span the bins."""
    if not t.is_floating_point():
        t = t.float()
    dev = t.device
    if valid is None:
        valid = torch.ones(t.shape, dtype=torch.bool, device=dev)
    big = torch.finfo(t.dtype).max
    first = torch.where(valid, t, big).min()
    last = torch.where(valid, t, -big).max()
    dt = last - first
    dt = torch.where(dt == 0, torch.ones_like(dt), dt)
    ts = (num_bins - 1) * (t - first) / dt
    pol = torch.where(p > 0, 1.0, -1.0).to(t.dtype)
    tis = torch.floor(ts)
    dts = ts - tis
    tis = tis.long()
    size = num_bins * height * width
    base = x.long() + y.long() * width
    ok = torch.cat([valid & (tis < num_bins) & (tis >= 0),
                    valid & (tis + 1 < num_bins) & (tis >= 0)])
    idx = torch.cat([base + tis * (width * height), base + (tis + 1) * (width * height)])
    vals = torch.cat([pol * (1.0 - dts), pol * dts])
    # an entry that adds nothing adds 0 to a cell of its own: one shared
    # spare cell (the JAX package's extra segment) would take every masked
    # entry's atomic add on the card, one after another
    idx = torch.where(ok, idx, torch.arange(idx.numel(), device=dev) % size)
    grid = torch.zeros(size, dtype=t.dtype, device=dev).index_add_(0, idx,
                                                                   torch.where(ok, vals, 0.0))
    return grid.view(num_bins, height, width).float()


def event_preprocess(voxel: torch.Tensor, mode: str = "std",
                     filter_hot_pixel: bool = False) -> torch.Tensor:
    """Voxel normalisation (ref: utils/event_process.py:193-216). 'std':
    the nonzero entries take zero mean and unit variance, zeros stay zero;
    'maxmin': a global min-max. ``filter_hot_pixel`` first zeroes
    |v| > 25/num_bins. The sums run in f64."""
    num_bins = voxel.shape[0]
    if filter_hot_pixel:
        voxel = torch.where(voxel.abs() > 25.0 / num_bins, 0.0, voxel)
    if mode == "maxmin":
        lo, hi = voxel.min(), voxel.max()
        return (voxel - lo) / (hi - lo + 1e-8)
    if mode != "std":
        raise ValueError(mode)
    nonzero = voxel != 0
    num = nonzero.sum().clamp(min=1).double()
    v64 = voxel.double()
    mean = v64.sum() / num
    stddev = torch.sqrt((v64 * v64).sum() / num - mean * mean)
    normed = nonzero.to(voxel.dtype) * ((v64 - mean) / (stddev + 1e-8)).to(voxel.dtype)
    return torch.where(nonzero.any(), normed, voxel)
