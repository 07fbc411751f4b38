"""Host-side (numpy) event voxelization.

A copy of the JAX package's numpy golden (cista_flow_tpu/events/voxel.py
``events_to_voxel_grid_numpy`` and ``event_preprocess_numpy``; ref:
utils/event_process.py:15-72, 193-216), so its voxels are bit for bit the
same. The reader calls these on the host; the model gets the voxels as
tensors.
"""
from __future__ import annotations

import numpy as np


def events_to_voxel_grid(events: np.ndarray, num_bins: int, width: int,
                         height: int, is_reverse: bool = False) -> np.ndarray:
    """N x 4 ``[t, x, y, p]`` -> (num_bins, H, W) float32 voxel grid.

    Bilinear split of each event between temporal bins floor(t) and
    floor(t)+1; polarity mapped to +/-1 (zeros become -1). ``is_reverse``
    flips the event order and, as the reference does, sets every polarity
    to -1 (its flip never happens: utils/event_process.py:52-54)."""
    assert events.ndim == 2 and events.shape[1] == 4
    voxel = np.zeros((num_bins, height, width), np.float32).ravel()
    if is_reverse:
        events = np.flip(events, axis=0)
    if len(events) == 0:
        return voxel.reshape(num_bins, height, width)

    first, last = events[0, 0], events[-1, 0]
    dt = last - first
    if dt == 0:
        dt = 1.0
    ts = (num_bins - 1) * (events[:, 0] - first) / dt
    xs = events[:, 1].astype(np.int64)
    ys = events[:, 2].astype(np.int64)
    pols = events[:, 3].copy()
    pols[pols == 0] = -1
    if is_reverse:
        pols[:] = -1

    tis = ts.astype(np.int64)
    dts = ts - tis
    vals_left = pols * (1.0 - dts)
    vals_right = pols * dts
    ok = tis < num_bins
    np.add.at(voxel, xs[ok] + ys[ok] * width + tis[ok] * width * height,
              vals_left[ok])
    ok = (tis + 1) < num_bins
    np.add.at(voxel, xs[ok] + ys[ok] * width + (tis[ok] + 1) * width * height,
              vals_right[ok])
    return voxel.reshape(num_bins, height, width)


def event_preprocess(voxel: np.ndarray, filter_hot_pixel: bool = False) -> np.ndarray:
    """Nonzero-masked normalization, the reference's mode 'std' (ref:
    utils/event_process.py:193-216): the nonzero entries take zero mean and
    unit variance, zeros stay zero. ``filter_hot_pixel`` zeroes
    |v| > 25/num_bins in place first."""
    num_bins = voxel.shape[0]
    if filter_hot_pixel:
        voxel[np.abs(voxel) > 25.0 / num_bins] = 0
    nonzero = voxel != 0
    num = nonzero.sum()
    if num > 0:
        mean = voxel.sum() / num
        stddev = np.sqrt((voxel ** 2).sum() / num - mean ** 2)
        voxel = nonzero.astype(np.float32) * (voxel - mean) / (stddev + 1e-8)
    return voxel
