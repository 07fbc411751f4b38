"""Training-time augmentation for flow-net pretraining (host side, numpy).

Counterpart of cista_flow_tpu/data/augmentors.py:15-167 (ref:
DCEIFlow/utils/augmentor/event_augmentor.py:62-273): the photometric
jitter of the image pair, horizontal and vertical flips with the flow's
sign fixed, and random crops, the voxels augmented with the images and
flows. The draws come from one ``np.random.default_rng(seed)`` in the JAX
classes' order, so flips and crops are bit for bit theirs. The JAX package
converts with OpenCV; here ``resize_flow`` is numpy's half-pixel bilinear
(``cv2.resize``'s INTER_LINEAR) and ``ColorJitter`` converts RGB to HSV and
back with ``cv2.cvtColor``'s float formulas in numpy. Those agree with
OpenCV to f32 rounding (float HSV within ~1e-6), and the jitter's final
truncation to uint8 can move a channel by one level where a value sits on
a level's edge (``tests/test_torch_chairs2.py`` states the share).
"""
from __future__ import annotations

import numpy as np

FLT_EPSILON = np.float32(np.finfo(np.float32).eps)


def _linear_taps(n_out: int, n_in: int):
    """cv2.resize's INTER_LINEAR taps along one axis: source index and
    weight of the right tap for each output index (half-pixel centres,
    the edge taps clamped to the border)."""
    x = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(x).astype(np.int64)
    f = (x - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    f[low | high] = 0
    i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.minimum(i0 + 1, n_in - 1), f


def resize_flow(flow, des_height, des_width):
    """Bilinear resize of a (H, W, 2) flow, its components scaled with the
    frame (ref: event_augmentor.py:13-35)."""
    h, w = flow.shape[:2]
    flow = np.asarray(flow, np.float32)
    x0, x1, fx = _linear_taps(des_width, w)
    y0, y1, fy = _linear_taps(des_height, h)
    rows = flow[:, x0] * (1 - fx)[None, :, None] + flow[:, x1] * fx[None, :, None]
    out = rows[y0] * (1 - fy)[:, None, None] + rows[y1] * fy[:, None, None]
    out[..., 0] *= des_width / w
    out[..., 1] *= des_height / h
    return out


def horizontal_flip_flow(flow):
    """(ref: event_augmentor.py:38-43)."""
    return (flow[:, ::-1] * np.array([-1.0, 1.0], flow.dtype)).copy()


def vertical_flip_flow(flow):
    """(ref: event_augmentor.py:46-51)."""
    return (flow[::-1, :] * np.array([1.0, -1.0], flow.dtype)).copy()


def remove_ambiguity_flow(flow_img, err_img, threshold_err=10.0):
    """Zero the flow where the error map exceeds a threshold (ref:
    event_augmentor.py:54-59)."""
    out = flow_img.copy()
    out[err_img > threshold_err] = 0
    return out


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of float32 RGB in [0, 1]:
    H in degrees [0, 360), S and V in [0, 1]."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + FLT_EPSILON)
    d = (60.0 / (diff + FLT_EPSILON).astype(np.float64)).astype(np.float32)
    h = np.where(v == r, (g - b) * d,
                 np.where(v == g, (b - r) * d + np.float32(120), (r - g) * d + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of float32 HSV, H in
    degrees."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.fmod(h * np.float32(6.0 / 360.0), np.float32(6))
    sector = np.floor(h)
    h = (h - sector).astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector).astype(np.int64)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1)
    tab = [v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))]
    # (b, g, r) tab indices per sector (OpenCV's sector_data)
    sector_data = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])
    idx = sector_data[sector]
    bgr = [np.choose(idx[..., k], tab) for k in range(3)]
    out = np.stack([bgr[2], bgr[1], bgr[0]], axis=-1)
    grey = (s == 0)[..., None]
    return np.where(grey, v[..., None], out).astype(np.float32)


class ColorJitter:
    """Numpy photometric jitter (brightness, contrast, saturation, hue)
    with torchvision-style uniform factor ranges."""

    def __init__(self, brightness=0.3, contrast=0.3, saturation=0.3, hue=0.3 / 3.14, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.rng = rng or np.random.default_rng()

    def __call__(self, img_u8: np.ndarray) -> np.ndarray:
        img = img_u8.astype(np.float32) / 255.0
        r = self.rng
        b = r.uniform(max(0, 1 - self.brightness), 1 + self.brightness)
        c = r.uniform(max(0, 1 - self.contrast), 1 + self.contrast)
        s = r.uniform(max(0, 1 - self.saturation), 1 + self.saturation)
        h = r.uniform(-self.hue, self.hue)

        img = img * b
        mean = img.mean()
        img = (img - mean) * c + mean
        if img.ndim == 3 and img.shape[-1] == 3:
            gray = img.mean(-1, keepdims=True)
            img = (img - gray) * s + gray
            hsv = rgb_to_hsv(np.clip(img, 0, 1))
            hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
            img = hsv_to_rgb(hsv)
        return np.clip(img * 255.0, 0, 255).astype(np.uint8)


class EventFlowAugmentor:
    """Joint (voxel, img1, img2, flow01[, flow10, occ, occ10, voxel_r])
    augmentation (ref: event_augmentor.py:62-169)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5, do_flip=False,
                 spatial_aug_prob=0.8, seed=None):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = spatial_aug_prob
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.asymmetric_color_aug_prob = 0.2
        self.rng = np.random.default_rng(seed)
        self.photo_aug = ColorJitter(rng=self.rng)

    def color_transform(self, img1, img2):
        if self.rng.random() < self.asymmetric_color_aug_prob:
            return self.photo_aug(img1), self.photo_aug(img2)
        stack = np.concatenate([img1, img2], axis=0)
        stack = self.photo_aug(stack)
        return np.split(stack, 2, axis=0)

    def spatial_transform(self, event, img1, img2, flow, flow10=None, occ=None, occ10=None,
                          event_r=None):
        if self.do_flip:
            if self.rng.random() < self.h_flip_prob:
                event = event[:, :, ::-1]
                img1, img2 = img1[:, ::-1], img2[:, ::-1]
                flow = horizontal_flip_flow(flow)
                flow10 = horizontal_flip_flow(flow10) if flow10 is not None else None
                occ = occ[:, ::-1] if occ is not None else None
                occ10 = occ10[:, ::-1] if occ10 is not None else None
                event_r = event_r[:, :, ::-1] if event_r is not None else None
            if self.rng.random() < self.v_flip_prob:
                event = event[:, ::-1, :]
                img1, img2 = img1[::-1], img2[::-1]
                flow = vertical_flip_flow(flow)
                flow10 = vertical_flip_flow(flow10) if flow10 is not None else None
                occ = occ[::-1] if occ is not None else None
                occ10 = occ10[::-1] if occ10 is not None else None
                event_r = event_r[:, ::-1, :] if event_r is not None else None

        ch, cw = self.crop_size
        y0 = self.rng.integers(0, img1.shape[0] - ch)
        x0 = self.rng.integers(0, img1.shape[1] - cw)

        def crop_img(a):
            return None if a is None else a[y0:y0 + ch, x0:x0 + cw]

        def crop_vox(a):
            return None if a is None else a[:, y0:y0 + ch, x0:x0 + cw]

        return (crop_vox(event), crop_img(img1), crop_img(img2), crop_img(flow),
                crop_img(flow10), crop_img(occ), crop_img(occ10), crop_vox(event_r))

    def __call__(self, event, img1, img2, flow, flow10=None, occ=None, occ10=None,
                 event_r=None):
        img1, img2 = self.color_transform(img1, img2)
        outs = self.spatial_transform(event, img1, img2, flow, flow10, occ, occ10, event_r)
        return tuple(None if o is None else np.ascontiguousarray(o) for o in outs)


class SparseEventFlowAugmentor(EventFlowAugmentor):
    """The sparse-GT variant: validity masks carried through the same
    transforms (ref: event_augmentor.py:173-273)."""

    def __call__(self, event, img1, img2, flow, valid=None, flow10=None, valid10=None):
        img1, img2 = self.color_transform(img1, img2)
        event, img1, img2, flow, flow10, valid, valid10, _ = \
            self.spatial_transform(event, img1, img2, flow, flow10, valid, valid10, None)
        out = (event, img1, img2, flow, valid, flow10, valid10)
        return tuple(None if o is None else np.ascontiguousarray(o) for o in out)


def fetch_augmentor(is_event=True, is_sparse=False, aug_params=None):
    """(ref: DCEIFlow/utils/augmentor/__init__'s dispatch)."""
    aug_params = aug_params or {}
    if is_sparse:
        return SparseEventFlowAugmentor(**aug_params)
    return EventFlowAugmentor(**aug_params)
