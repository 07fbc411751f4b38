"""Flow, image and event files (host side, numpy).

Counterpart of cista_flow_tpu/data/file_io.py:16-120 (ref:
DCEIFlow/utils/file_io.py): Middlebury ``.flo``, PFM, KITTI's 16-bit PNG
flows, HDF5 event files, and the generic ``read_gen``, without OpenCV or
h5py: PNGs through the port's PNG codec (``data/png.py``), HDF5 through its
HDF5 reader (``data/hdf5.py``), binary PPM here. JPEG frames are not
read (the port has no JPEG decoder): ``read_gen`` raises on them.
"""
from __future__ import annotations

import os
import re

import numpy as np

from . import hdf5
from .png import read_png, write_png

FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo -> (H, W, 2) float32 (little-endian)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: invalid .flo magic")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.float32([FLO_MAGIC]).tofile(f)
        np.int32([w]).tofile(f)
        np.int32([h]).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """PFM -> (H, W[, 3]) float array, flipped bottom-up as the reference
    flips it."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError("Not a PFM file.")
        dim = re.match(rb"^(\d+)\s(\d+)\s*$", f.readline())
        if not dim:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape))


def read_flow_kitti(path: str):
    """KITTI 16-bit RGB PNG -> (flow (H, W, 2), valid (H, W)), float32:
    flow = (R or G - 2**15) / 64, valid = B."""
    raw = read_png(path)
    if raw.dtype != np.uint16 or raw.ndim != 3:
        raise ValueError(f"{path}: a KITTI flow is a 16-bit RGB PNG, got {raw.dtype} "
                         f"with shape {raw.shape}")
    raw = raw.astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    flow = (flow - 2**15) / 64.0
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray, valid: np.ndarray | None = None):
    h, w = flow.shape[:2]
    enc = (flow * 64.0 + 2**15).astype(np.uint16)
    v = np.ones((h, w), np.uint16) if valid is None else valid.astype(np.uint16)
    write_png(path, np.dstack([enc, v[..., None]])[..., ::-1])   # BGR, as cv2.imwrite takes it


def read_dense_flow(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[-1]
    if ext == ".flo":
        return read_flo(path).astype(np.float32)
    if ext == ".pfm":
        flow = read_pfm(path).astype(np.float32)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unsupported dense flow format {ext}")


def read_pnm(path: str) -> np.ndarray:
    """A binary 8-bit PGM (P5) or PPM (P6) -> (H, W) or (H, W, 3) uint8, RGB
    in the file's order."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        m = re.compile(rb"\s*(#[^\n]*\n\s*)*(\S+)").match(data, pos)
        if m is None:
            raise ValueError(f"{path}: malformed PNM header")
        fields.append(m.group(2))
        pos = m.end()
    magic, width, height, maxval = fields[0], *map(int, fields[1:])
    if magic not in (b"P5", b"P6") or maxval > 255:
        raise ValueError(f"{path}: only binary 8-bit PGM (P5) and PPM (P6) are read, got "
                         f"{magic!r} with maximum {maxval}")
    channels = 3 if magic == b"P6" else 1
    img = np.frombuffer(data, np.uint8, count=height * width * channels, offset=pos + 1)
    return img.reshape(height, width, channels) if channels == 3 else img.reshape(height, width)


def read_gen(path: str):
    """The generic reader (ref: file_io.py:85-93): PNG and PPM (RGB for
    colour, as the JAX reader flips OpenCV's BGR), ``.flo``/``.pfm`` flows,
    ``.bin``/``.raw`` through ``np.load``; a JPEG raises; anything else
    gives []."""
    ext = os.path.splitext(path)[-1]
    if ext == ".png":
        return read_png(path)
    if ext == ".ppm":
        return read_pnm(path)
    if ext in (".jpg", ".jpeg"):
        raise ValueError(f"{path}: JPEG frames are not read (the port has no JPEG decoder)")
    if ext in (".bin", ".raw"):
        return np.load(path)
    if ext in (".flo", ".pfm"):
        return read_dense_flow(path)
    return []


def read_event_h5(path: str) -> np.ndarray:
    """An HDF5 event file with x/y/t/p datasets -> (N, 4) float32 [x, y, t, p]
    (ref: file_io.py:107-117)."""
    with hdf5.File(path) as f:
        n = len(f["x"])
        events = np.zeros([n, 4], dtype=np.float32)
        events[:, 0] = f["x"][()]
        events[:, 1] = f["y"][()]
        events[:, 2] = f["t"][()]
        events[:, 3] = f["p"][()]
    return events
