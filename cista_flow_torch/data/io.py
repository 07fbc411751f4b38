"""The eval CLIs' output writers and pictures (host side, numpy).

Counterparts of cista_flow_tpu/data/io.py:20-156 (ref: utils/data_io.py)
without OpenCV: per-frame PNG writers through the port's PNG codec, the
tab-separated ``result.csv``, the HSV picture of a flow, the event
previews and the error maps. Paths and file names are the JAX package's:
``<output_folder>/<model name>/<sequence>/frame_%010d.png``,
``.../flow/flow_%010d.png``, ``.../events/events_%010d.png``,
``.../error_maps/frame_%010d.png`` and ``.../result.csv``.
"""
from __future__ import annotations

import csv
import os

import numpy as np

from .png import write_png


# OpenCV's fastAtan2 polynomial (degrees), as ``cv2.cartToPolar`` computes
# the angle: accurate to about 0.3 degrees, which moves the hue's 2-degree
# bins on a few % of pixels against the exact ``np.arctan2``
_ATAN = [np.float32(c * np.float32(180 / np.pi)) for c in
         (0.9997878412794807, -0.3258083974640975, 0.1555786518463281, -0.04432655554792128)]


def fast_atan2_deg(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """OpenCV's ``fastAtan2`` in f32: the angle of (x, y) in [0, 360)."""
    f32 = np.float32
    ax, ay = np.abs(x), np.abs(y)
    wide = ax >= ay
    eps = f32(np.finfo(np.float64).eps)
    c = np.where(wide, ay / (ax + eps), ax / (ay + eps))
    c2 = c * c
    a = (((_ATAN[3] * c2 + _ATAN[2]) * c2 + _ATAN[1]) * c2 + _ATAN[0]) * c
    a = np.where(wide, a, f32(90) - a)
    a = np.where(x < 0, f32(180) - a, a)
    return np.where(y < 0, f32(360) - a, a)


def merge_optical_flow(flow: np.ndarray) -> np.ndarray:
    """Flow (2, H, W) -> HSV-coded BGR uint8 (ref: data_io.py:9-29): hue
    from the angle (180 steps a turn), full saturation, value from the
    magnitude over its maximum. The angle and the magnitude are computed as
    ``cv2.cartToPolar`` computes them, the colour as ``cv2.cvtColor``'s
    HSV->BGR."""
    fx = np.asarray(flow[0], np.float32)
    fy = np.asarray(flow[1], np.float32)
    magnitude = np.sqrt(fx * fx + fy * fy)
    angle = fast_atan2_deg(fy, fx) * np.float32(np.pi / 180)
    hue = (angle * (180 / np.pi / 2)).astype(np.uint8)
    value = np.zeros(fx.shape, np.uint8)
    maxmag = magnitude.max()
    if maxmag > 0:
        value = (255 * magnitude / maxmag).astype(np.uint8)
    return hsv_to_bgr(hue, np.full(fx.shape, 255, np.uint8), value)


def hsv_to_bgr(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(H, W) 8-bit HSV (hue in [0, 180)) -> BGR by OpenCV's documented
    formula, in f32 as ``cv2.cvtColor`` computes it: saturation and value
    times the f32 1/255, the six sectors, then times 255. OpenCV's vector
    path takes each row in blocks of 32 pixels and truncates; the row's
    last ``W % 32`` pixels take its scalar path, which rounds."""
    f32 = np.float32
    hh = h.astype(f32) * (f32(6) / f32(180))
    ss = s.astype(f32) * f32(1 / 255)
    vv = v.astype(f32) * f32(1 / 255)
    sector = np.floor(hh)
    f = hh - sector
    sector = sector.astype(np.int64) % 6
    p = vv * (1 - ss)
    q = vv * (1 - ss * f)
    t = vv * (1 - ss * (1 - f))
    # (r, g, b) per sector
    r = np.choose(sector, [vv, q, p, p, t, vv])
    g = np.choose(sector, [t, vv, vv, q, p, p])
    b = np.choose(sector, [p, p, t, vv, vv, q])
    bgr = np.stack([b, g, r], axis=-1) * f32(255)
    blocks = bgr.shape[1] // 32 * 32
    bgr[:, :blocks] = np.trunc(bgr[:, :blocks])
    bgr[:, blocks:] = np.rint(bgr[:, blocks:])
    return np.clip(bgr, 0, 255).astype(np.uint8)


def make_event_preview(events: np.ndarray, mode: str = "grayscale",
                       num_bins_to_show: int = -1) -> np.ndarray:
    """Voxel (C, H, W) or (1, C, H, W) -> displayable uint8: the bins'
    sum as gray in [-5, 5], or 'red-blue' (BGR): blue where positive, red
    where negative (ref: data_io.py:32-61)."""
    if events.ndim == 3:
        events = events[None]
    if num_bins_to_show < 0:
        s = np.sum(events[0], axis=0)
    else:
        s = np.sum(events[0, -num_bins_to_show:], axis=0)
    if mode == "red-blue":
        preview = np.zeros((*s.shape, 3), dtype=np.uint8)
        preview[..., 0][s > 0] = 255  # blue (BGR)
        preview[..., 2][s < 0] = 255  # red
        return preview
    m, M = -5.0, 5.0
    return np.clip(255.0 * (s - m) / (M - m), 0, 255).astype(np.uint8)


class Writer:
    def __init__(self, cfgs, model_name, dataset_name=None):
        self.output_folder = cfgs.output_folder
        self.dataset_name = dataset_name or cfgs.test_data_name
        os.makedirs(self.output_folder, exist_ok=True)
        self.output_data_folder = os.path.join(
            self.output_folder, model_name, str(self.dataset_name))


class ImageWriter(Writer):
    """Per-frame reconstruction PNGs (ref: data_io.py:139-161)."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.enabled = cfgs.is_write_image
        if self.enabled:
            os.makedirs(self.output_data_folder, exist_ok=True)

    def __call__(self, img: np.ndarray, img_id: int):
        if not self.enabled:
            return
        write_png(os.path.join(self.output_data_folder, f"frame_{img_id:010d}.png"),
                  np.uint8(img))


class EvalWriter(Writer):
    """Tab-separated eval CSVs (ref: data_io.py:77-102)."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.enabled = cfgs.is_write_image
        if self.enabled:
            os.makedirs(self.output_data_folder, exist_ok=True)
            self.output_txt_file = os.path.join(self.output_data_folder, "result.csv")

    def __call__(self, name_results, results):
        if not self.enabled:
            return
        with open(self.output_txt_file, "a+", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(name_results)
            w.writerow(results)


class FlowWriter(Writer):
    """Flow pictures (ref: data_io.py:164-192)."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.enabled = cfgs.is_write_flow
        if self.enabled:
            self.output_data_folder = os.path.join(self.output_data_folder, "flow")
            os.makedirs(self.output_data_folder, exist_ok=True)

    def __call__(self, flow: np.ndarray, img_id: int):
        if not self.enabled:
            return
        write_png(os.path.join(self.output_data_folder, f"flow_{img_id:010d}.png"),
                  merge_optical_flow(flow))


class EventWriter(Writer):
    """Event preview PNGs (ref: data_io.py:195-219)."""

    def __init__(self, cfgs, model_name, dataset_name=None, save_folder_name="events"):
        super().__init__(cfgs, model_name, dataset_name)
        self.enabled = cfgs.is_write_event
        if self.enabled:
            self.output_data_folder = os.path.join(self.output_data_folder, save_folder_name)
            os.makedirs(self.output_data_folder, exist_ok=True)

    def __call__(self, img: np.ndarray, img_id: int):
        if not self.enabled:
            return
        write_png(os.path.join(self.output_data_folder, f"events_{img_id:010d}.png"),
                  np.uint8(img))


# OpenCV's COLORMAP_COOL as a BGR lookup table: blue 255, green 255 - i, red i
COOL_BGR = np.stack([np.full(256, 255), 255 - np.arange(256), np.arange(256)],
                    axis=1).astype(np.uint8)


class ErrorMapWriter(Writer):
    """Signed error maps under ``--is_write_emap`` (ref: data_io.py:105-136):
    reconstruction minus GT in [-0.5, 0.5] scaled to 0..255, coloured by
    OpenCV's COLORMAP_COOL of 255 minus it, as the JAX writer does."""

    def __init__(self, cfgs, model_name, dataset_name=None):
        super().__init__(cfgs, model_name, dataset_name)
        self.enabled = cfgs.is_write_emap
        if self.enabled:
            self.output_data_folder = os.path.join(self.output_data_folder, "error_maps")
            os.makedirs(self.output_data_folder, exist_ok=True)

    def __call__(self, img, gt_img, img_id: int):
        if not self.enabled:
            return
        diff = img.astype(np.float32) / 255.0 - gt_img.astype(np.float32) / 255.0
        scaled = np.clip((diff + 0.5) * 255, 0, 255).astype(np.uint8)
        write_png(os.path.join(self.output_data_folder, f"frame_{img_id:010d}.png"),
                  COOL_BGR[255 - scaled])
