"""8-bit PNG, read and written with ``zlib`` and numpy only.

The eval data's frames are PNGs (``frame_%04d.png``); the JAX package reads
and writes them with OpenCV, which the port does not use. The reader takes
the subset those files are: bit depth 8, colour type 0 (grayscale), no
interlace. It decodes all five row filters (encoders such as libpng pick
one per row, Paeth included) and raises on any other kind of PNG. The
writer stores grayscale (colour type 0) or, for the flow and event
pictures, RGB (colour type 2) from a BGR array as ``cv2.imwrite`` takes
it; every row with filter 0 (None).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a (H, W) uint8 array as an 8-bit grayscale PNG, or a (H, W, 3)
    uint8 array in OpenCV's BGR order as an 8-bit RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"write_png takes a (H, W) or (H, W, 3) uint8 array, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = img.reshape(h, -1) if colour == 0 else img[:, :, ::-1].reshape(h, 3 * w)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)   # a filter-type byte (0) per row
    raw[:, 1:] = rows
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))


def _paeth_row(raw, prior):
    out = [0] * len(raw)
    left = upleft = 0
    for i, (r, up) in enumerate(zip(raw, prior)):
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc else upleft)
        left = out[i] = (r + pred) & 0xFF
        upleft = up
    return out


def _average_row(raw, prior):
    out = [0] * len(raw)
    left = 0
    for i, (r, up) in enumerate(zip(raw, prior)):
        left = out[i] = (r + ((left + up) >> 1)) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit grayscale, non-interlaced PNG into a (H, W) uint8 array
    (what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` returns for one)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, colour, compression, filt, interlace = header
    if (depth, colour, compression, filt, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"{path}: only 8-bit grayscale non-interlaced PNG is supported "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (w + 1)}")
    raw = raw.reshape(h, w + 1)
    out = np.empty((h, w), np.uint8)
    prior = np.zeros(w, np.uint8)
    for y in range(h):
        kind, row = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = row
        elif kind == 1:                       # Sub: a running sum mod 256
            cur = (np.cumsum(row, dtype=np.uint64) & 0xFF).astype(np.uint8)
        elif kind == 2:                       # Up
            cur = row + prior                 # uint8 wraps mod 256
        elif kind == 3:
            cur = np.asarray(_average_row(row.tolist(), prior.tolist()), np.uint8)
        elif kind == 4:
            cur = np.asarray(_paeth_row(row.tolist(), prior.tolist()), np.uint8)
        else:
            raise ValueError(f"{path}: unknown row filter {kind} in row {y}")
        out[y] = cur
        prior = out[y]
    return out
