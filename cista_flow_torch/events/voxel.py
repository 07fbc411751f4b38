"""Host-side event voxelization.

``events_to_voxel_grid`` and ``event_preprocess`` (mode 'std') run the
port's host event library (``events/native.py``), as the JAX package's
run its native library by default (cista_flow_tpu/events/voxel.py): the
voxels are bit for bit those of the JAX package's default path.
``CISTA_NO_NATIVE=1`` in the environment at import selects the numpy
versions for both, as it does in the JAX package. The numpy functions are
the plain versions, copies of the JAX package's numpy golden
(``events_to_voxel_grid_numpy``, ``event_preprocess_numpy``; ref:
utils/event_process.py:15-72, 193-216). With them the reference's variants:
the polarity-separated voxel, the noise augmentation and mode 'maxmin'.
"""
from __future__ import annotations

import os

import numpy as np

from . import native

# read once at import, as cista_flow_tpu/events/voxel.py reads it
_USE_NATIVE = os.environ.get("CISTA_NO_NATIVE", "0") != "1"


def events_to_voxel_grid(events: np.ndarray, num_bins: int, width: int,
                         height: int, is_reverse: bool = False) -> np.ndarray:
    """N x 4 ``[t, x, y, p]`` -> (num_bins, H, W) float32 voxel grid, by
    the host event library (bit for bit ``events_to_voxel_grid_numpy``), or
    by that numpy version under ``CISTA_NO_NATIVE=1``."""
    if _USE_NATIVE and len(events):
        return native.voxelize_events(events, num_bins, width, height, is_reverse)
    return events_to_voxel_grid_numpy(events, num_bins, width, height, is_reverse)


def events_to_voxel_grid_numpy(events: np.ndarray, num_bins: int, width: int,
                               height: int, is_reverse: bool = False) -> np.ndarray:
    """The plain version. Bilinear split of each event between temporal
    bins floor(t) and floor(t)+1; polarity mapped to +/-1 (zeros become
    -1). ``is_reverse`` flips the event order and, as the reference does,
    sets every polarity to -1 (its flip never happens:
    utils/event_process.py:52-54)."""
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


def events_to_voxel_grid_pol(events: np.ndarray, num_bins: int, width: int,
                             height: int) -> np.ndarray:
    """Polarity-separated voxel -> (num_bins, 2, H, W) float32 (ref:
    utils/event_process.py:75-123): polarity p in {0, 1} picks the
    channel, every event weighs 1 (polarity 0 counts as 1)."""
    voxel = np.zeros((num_bins, 2, height, width), np.float32).ravel()
    if len(events) == 0:
        return voxel.reshape(num_bins, 2, height, width)
    first, last = events[0, 0], events[-1, 0]
    dt = last - first
    if dt == 0:
        dt = 1.0
    ts = (num_bins - 1) * (events[:, 0] - first) / dt
    xs = events[:, 1].astype(np.int64)
    ys = events[:, 2].astype(np.int64)
    pols = events[:, 3].copy()
    ps = pols.astype(np.int64)
    pols[pols == 0] = 1.0

    tis = ts.astype(np.int64)
    dts = ts - tis
    vals_left = pols * (1.0 - dts)
    vals_right = pols * dts
    plane = width * height
    ok = tis < num_bins
    np.add.at(voxel, xs[ok] + ys[ok] * width + ps[ok] * plane + tis[ok] * plane * 2,
              vals_left[ok])
    ok = (tis + 1) < num_bins
    np.add.at(voxel, xs[ok] + ys[ok] * width + ps[ok] * plane + (tis[ok] + 1) * plane * 2,
              vals_right[ok])
    return voxel.reshape(num_bins, 2, height, width)


def event_preprocess(voxel: np.ndarray, mode: str = "std",
                     filter_hot_pixel: bool = False) -> np.ndarray:
    """Nonzero-masked normalization (ref: utils/event_process.py:193-216).
    Mode 'std' runs the host event library in place on a C-contiguous
    float32 voxel (a copy otherwise) and returns it, as the JAX package's
    default path does; 'maxmin', and 'std' under ``CISTA_NO_NATIVE=1``, are
    ``event_preprocess_numpy``'s."""
    if mode != "std" or not _USE_NATIVE:
        return event_preprocess_numpy(voxel, mode, filter_hot_pixel)
    v = np.ascontiguousarray(voxel, dtype=np.float32)
    native.preprocess_std(v, filter_hot_pixel)
    return v


def event_preprocess_numpy(voxel: np.ndarray, mode: str = "std",
                           filter_hot_pixel: bool = False) -> np.ndarray:
    """The plain version. Mode 'std': the nonzero entries take zero mean
    and unit variance, zeros stay zero; 'maxmin': min-max to [0, 1].
    ``filter_hot_pixel`` zeroes |v| > 25/num_bins in place first."""
    num_bins = voxel.shape[0]
    if filter_hot_pixel:
        voxel[np.abs(voxel) > 25.0 / num_bins] = 0
    if mode == "maxmin":
        return (voxel - voxel.min()) / (voxel.max() - voxel.min() + 1e-8)
    assert mode == "std"
    nonzero = voxel != 0
    num = nonzero.sum()
    if num > 0:
        mean = voxel.sum() / num
        stddev = np.sqrt((voxel ** 2).sum() / num - mean ** 2)
        voxel = nonzero.astype(np.float32) * (voxel - mean) / (stddev + 1e-8)
    return voxel


def add_noise_to_voxel(voxel: np.ndarray, noise_std: float = 1.0,
                       noise_fraction: float = 0.1, *,
                       rng: np.random.Generator) -> np.ndarray:
    """Noise augmentation (ref: utils/event_process.py:8-13): Gaussian
    noise of ``noise_std`` on a ``noise_fraction`` of the entries, drawn
    from ``rng`` in the JAX package's order (the noise, then the mask)."""
    noise = noise_std * rng.standard_normal(voxel.shape).astype(np.float32)
    if noise_fraction < 1.0:
        noise[rng.random(voxel.shape) >= noise_fraction] = 0
    return voxel + noise
