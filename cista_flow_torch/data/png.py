"""PNG, read and written with ``zlib`` and numpy only.

The eval data's frames are PNGs (``frame_%04d.png``, grey), FlyingChairs2's
frames are RGB PNGs and KITTI's flows 16-bit RGB PNGs; the JAX package reads
and writes them with OpenCV, which the port does not use. The reader takes
bit depth 8 or 16, colour type 0 (grey) or 2 (RGB), no interlace, and
returns what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` returns, except
that RGB comes in the file's order (R, G, B), where OpenCV returns B, G, R:
a (H, W) or (H, W, 3) array of uint8 or uint16. It decodes all five row
filters (encoders such as libpng pick one per row, Paeth included) and
raises on any other kind of PNG. Rows of filters 0-2 decode a row at a
time; Average and Paeth need the decoded left neighbour, so an image that
holds either decodes along anti-diagonals (H + W - 1 vector steps, each
over every row's pixel on the diagonal). The writer stores grey (colour
type 0) or, from a BGR array as ``cv2.imwrite`` takes it, RGB (colour type
2), at bit depth 8 (uint8) or 16 (uint16); every row with filter 0 (None),
or with ``row_filter=4`` every row Paeth-filtered.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor of left ``a``, up ``b``, up-left ``c`` (ints)."""
    ba, ca = b - c, a - c                   # |p - a|, |p - b| with p = a + b - c
    pa, pb, pc = np.abs(ba), np.abs(ca), np.abs(ba + ca)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path: str, img: np.ndarray, level: int = 6, row_filter: int = 0) -> None:
    """Write a (H, W) array as a grey PNG, or a (H, W, 3) array in OpenCV's
    BGR order as an RGB PNG: bit depth 8 from uint8, 16 from uint16; every
    row with filter ``row_filter``, 0 (None) or 4 (Paeth)."""
    if row_filter not in (0, 4):
        raise ValueError(f"write_png writes row filter 0 or 4, not {row_filter}")
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or not (
            img.ndim == 2 or img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"write_png takes a (H, W) or (H, W, 3) uint8 or uint16 array, got "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rgb = img if colour == 0 else img[:, :, ::-1]
    rows = rgb.astype(">u2" if img.dtype == np.uint16 else np.uint8).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, -1)
    raw = np.full((h, rows.shape[1] + 1), row_filter, np.uint8)   # a filter-type byte per row
    raw[:, 1:] = rows
    if row_filter == 4:
        bpp = rows.shape[1] // w
        x = rows.astype(np.int16)
        up, left, upleft = (np.zeros_like(x) for _ in range(3))
        up[1:], left[:, bpp:], upleft[1:, bpp:] = x[:-1], x[:, :-bpp], x[:-1, :-bpp]
        raw[:, 1:] = (x - _paeth(left, up, upleft)) & 0xFF
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))


def _unfilter_rows(raw, kinds, w: int, bpp: int):
    """Rows of filters 0 (None), 1 (Sub) and 2 (Up), a row at a time."""
    out = np.empty_like(raw)
    prior = np.zeros(raw.shape[1], np.uint8)
    for y, kind in enumerate(kinds):
        row = raw[y]
        if kind == 0:
            out[y] = row
        elif kind == 1:                       # a running sum mod 256 per byte lane
            out[y] = (np.cumsum(row.reshape(w, bpp), axis=0, dtype=np.uint64) & 0xFF
                      ).astype(np.uint8).reshape(-1)
        else:
            out[y] = row + prior              # uint8 wraps mod 256
        prior = out[y]
    return out


def _unfilter_diagonals(raw, kinds, w: int, bpp: int):
    """Any mix of the five filters. A pixel depends on its left, up and
    up-left neighbours only, so every pixel of an anti-diagonal x + y = d
    decodes at once from diagonals d - 1 and d - 2. Pixel (y, x) is kept
    at ``s[x + y + 2, y + 1]``; the cells of row -1 and column -1 stay 0."""
    h = raw.shape[0]
    ys, xs = np.arange(h)[None, :], np.arange(w)[:, None]
    skewed = np.zeros((w + h, h, bpp), np.int16)
    skewed[xs + ys, ys] = raw.reshape(h, w, bpp).transpose(1, 0, 2)
    s = np.zeros((w + h + 1, h + 1, bpp), np.int16)
    kinds = np.asarray(kinds)[:, None]
    masks = [(k, kinds == k) for k in (3, 2, 1) if (kinds == k).any()]
    none = kinds == 0
    for d in range(w + h - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a, b, c = s[d + 1, y0 + 1:y1 + 1], s[d + 1, y0:y1], s[d, y0:y1]   # left, up, up-left
        pred = _paeth(a, b, c)
        for k, mask in masks:
            np.copyto(pred, (a + b) >> 1 if k == 3 else b if k == 2 else a, where=mask[y0:y1])
        pred[none[y0:y1, 0]] = 0
        s[d + 2, y0 + 1:y1 + 1] = (skewed[d, y0:y1] + pred) & 0xFF
    return s[xs + ys + 2, ys + 1].transpose(1, 0, 2).astype(np.uint8).reshape(h, w * bpp)


def read_png(path: str) -> np.ndarray:
    """Read a grey or RGB, 8- or 16-bit, non-interlaced PNG into a (H, W)
    or (H, W, 3) uint8 or uint16 array, RGB in the file's order."""
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
    if depth not in (8, 16) or colour not in (0, 2) or (compression, filt, interlace) != (0, 0, 0):
        raise ValueError(
            f"{path}: only 8- or 16-bit grey or RGB non-interlaced PNG is supported "
            f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    channels = 1 if colour == 0 else 3
    bpp = channels * depth // 8                  # bytes per pixel: the filters' 'left'
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    kinds = raw[:, 0].tolist()
    bad = [y for y, k in enumerate(kinds) if k > 4]
    if bad:
        raise ValueError(f"{path}: unknown row filter {kinds[bad[0]]} in row {bad[0]}")
    unfilter = _unfilter_rows if max(kinds, default=0) <= 2 else _unfilter_diagonals
    out = unfilter(raw[:, 1:], kinds, w, bpp)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape(h, w) if channels == 1 else out.reshape(h, w, 3)
