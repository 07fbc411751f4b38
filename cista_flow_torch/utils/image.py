"""Image utilities (host side, numpy).

Copies of cista_flow_tpu/utils/image.py (the port imports nothing of the
JAX package): ``normalize_image`` (ref: utils/image_process.py:11-18),
``optimal_crop_size`` and ``CropParameters`` (ref:
utils/image_process.py:20-56), ``forward_interpolate``, ``setup_seed`` and
``InputPadder`` (ref: DCEIFlow/utils/sample_utils.py:7-35,
DCEIFlow/utils/utils.py:12-57). Like the JAX versions they work on numpy
arrays, channel-last (NHWC, HWC or HW).
"""
from __future__ import annotations

import math
import os
import random

import numpy as np


def normalize_image(image: np.ndarray, low: float = 1, high: float = 99) -> np.ndarray:
    """Percentile-robust normalization to [0, 1]: the ``low`` and ``high``
    percentiles map to 0 and 1 (ECD's GT frames use 0 and 100, ref:
    test_wo_flow.py:157-158)."""
    image = np.asarray(image)
    mini = np.percentile(image.ravel(), low)
    maxi = np.percentile(image.ravel(), high)
    out = (image - mini) / (maxi - mini + 1e-5)
    return np.clip(out, 0.0, 1.0)


def optimal_crop_size(max_size: int, max_subsample_factor: int) -> int:
    """The smallest multiple of 2^f that is at least ``max_size``."""
    p = 2 ** max_subsample_factor
    return int(p * math.ceil(max_size / p))


class CropParameters:
    """e2vid's symmetric reflect-pad geometry to multiples of
    2^num_encoders, and the centre-crop indices back."""

    def __init__(self, width: int, height: int, num_encoders: int):
        self.height = height
        self.width = width
        self.width_crop_size = optimal_crop_size(width, num_encoders)
        self.height_crop_size = optimal_crop_size(height, num_encoders)
        self.padding_top = math.ceil(0.5 * (self.height_crop_size - height))
        self.padding_bottom = math.floor(0.5 * (self.height_crop_size - height))
        self.padding_left = math.ceil(0.5 * (self.width_crop_size - width))
        self.padding_right = math.floor(0.5 * (self.width_crop_size - width))
        self.cx = math.floor(self.width_crop_size / 2)
        self.cy = math.floor(self.height_crop_size / 2)
        self.ix0 = self.cx - math.floor(width / 2)
        self.ix1 = self.cx + math.ceil(width / 2)
        self.iy0 = self.cy - math.floor(height / 2)
        self.iy1 = self.cy + math.ceil(height / 2)

    def pad(self, x: np.ndarray) -> np.ndarray:
        """Reflect-pad an NHWC, HWC or HW array to the crop size."""
        pads = [(self.padding_top, self.padding_bottom),
                (self.padding_left, self.padding_right)]
        if x.ndim == 2:
            return np.pad(x, pads, mode="reflect")
        if x.ndim == 3:
            return np.pad(x, pads + [(0, 0)], mode="reflect")
        return np.pad(x, [(0, 0)] + pads + [(0, 0)], mode="reflect")

    def crop(self, x: np.ndarray) -> np.ndarray:
        return x[..., self.iy0:self.iy1, self.ix0:self.ix1, :] \
            if x.ndim == 4 else x[self.iy0:self.iy1, self.ix0:self.ix1]


def forward_interpolate(flow: np.ndarray) -> np.ndarray:
    """Forward-splat a flow (2, H, W) onto the regular grid by
    nearest-neighbour scattered interpolation (scipy's ``griddata``); the
    JAX version's fix of the upstream bug that interpolated dx twice is
    kept. Returns (2, H, W) float32."""
    from scipy import interpolate

    dx, dy = flow[0], flow[1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    x1, y1, dxf, dyf = x1[valid], y1[valid], dxf[valid], dyf[valid]
    flow_x = interpolate.griddata((x1, y1), dxf, (x0, y0), method="nearest", fill_value=0)
    flow_y = interpolate.griddata((x1, y1), dyf, (x0, y0), method="nearest", fill_value=0)
    return np.stack([flow_x, flow_y], axis=0).astype(np.float32)


def setup_seed(seed: int) -> None:
    """Seed every host generator in play: ``PYTHONHASHSEED``, numpy's
    global generator, ``random`` and ``torch.manual_seed``."""
    import torch

    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


class InputPadder:
    """Pads H and W to multiples of ``div`` with replicated edges, split
    evenly ('sintel') or at the bottom ('kitti'); NHWC or HWC arrays."""

    def __init__(self, dims, div: int = 8, mode: str = "sintel"):
        ht, wd = dims[-2:] if len(dims) >= 2 else dims
        pad_ht = (((ht // div) + 1) * div - ht) % div
        pad_wd = (((wd // div) + 1) * div - wd) % div
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        left, right, top, bottom = self._pad
        out = []
        for x in inputs:
            pads = [(top, bottom), (left, right)]
            if x.ndim == 3:
                pads = pads + [(0, 0)]
            elif x.ndim == 4:
                pads = [(0, 0)] + pads + [(0, 0)]
            out.append(np.pad(x, pads, mode="edge"))
        return out

    def unpad(self, x):
        if x is None:
            return None
        left, right, top, bottom = self._pad
        ht, wd = (x.shape[1:3] if x.ndim == 4 else x.shape[:2])
        ys = slice(top, ht - bottom)
        xs = slice(left, wd - right)
        return x[:, ys, xs] if x.ndim == 4 else x[ys, xs]
