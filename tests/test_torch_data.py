"""The port's host-side data path against the JAX package's, on the CPU: the
simulator (bit for bit), the PNG codec (against OpenCV, which the port does
not use), the voxelization (the numpy versions bit for bit the numpy golden, the
host event library bit for bit the JAX package's native library) and the
sequence reader's packs.

The gate data is made once per module with the port's ``ensure_eval_data``
at the quality gate's size (180x240, 2 sequences of 30 frames, seed 0).
"""
import os
import struct
import zlib

import cv2
import numpy as np
import pytest

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.data import sim as JSIM
from cista_flow_tpu.data import video_readers as JVR
from cista_flow_tpu.events import native as JN
from cista_flow_tpu.events import voxel as JV
from cista_flow_torch.config import Config
from cista_flow_torch.data import png, readers, sim
from cista_flow_torch.events import (event_preprocess, event_preprocess_numpy, events_to_voxel_grid,
                                     events_to_voxel_grid_numpy)
from test_torch_surface import jax_native_library

H, W = 180, 240


@pytest.fixture(scope="module")
def gate_dir(tmp_path_factory):
    return sim.ensure_eval_data(str(tmp_path_factory.mktemp("gate")), H, W,
                                eval_frames=30, seed=0)


@pytest.mark.parametrize("seed,n,h,w", [(0, 4, 30, 40), (777_001, 5, 36, 52)])
def test_simulate_sequence_bit_for_bit(seed, n, h, w):
    ours, ref = sim.simulate_sequence(seed, n, h, w), JSIM.simulate_sequence(seed, n, h, w)
    assert ours.keys() == ref.keys()
    for key in ("frames", "timestamps", "flow01", "flow10"):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])
    assert len(ours["events"]) == len(ref["events"]) == n - 1
    for a, b in zip(ours["events"], ref["events"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and len(x) > 0
            np.testing.assert_array_equal(x, y)


def test_eval_sequence_files_match_the_jax_writer(tmp_path):
    """The same sequence written by both packages: timestamps and npz files
    equal; every PNG of either reads the same through OpenCV and through
    the port's decoder, and equals the rounded frame."""
    seq = JSIM.simulate_sequence(5, 4, 24, 34)
    JSIM.write_eval_sequence(str(tmp_path / "jax"), seq)
    sim.write_eval_sequence(str(tmp_path / "port"), seq)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".png"):
            frame = np.round(seq["frames"][int(name[6:10])] * 255).astype(np.uint8)
            for path in (a, b):
                np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), frame)
                np.testing.assert_array_equal(png.read_png(str(path)), frame)
        elif name.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k])
        else:
            assert a.read_bytes() == b.read_bytes()


def _filter_row(kind, row, prior):
    """The PNG encoder's side of row filter ``kind`` (bpp 1)."""
    r, up = row.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([[0], r[:-1]])
    upleft = np.concatenate([[0], up[:-1]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return ((r - pred) % 256).astype(np.uint8)


def _chunk(kind, data):
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def _encode(img, filters, depth=8, colour=0, interlace=0):
    """A PNG with the given filter per row, its data split over two IDAT
    chunks with an ancillary chunk before them."""
    prior = np.zeros(img.shape[1], np.uint8)
    raw = b""
    for row, kind in zip(img, filters):
        raw += bytes([kind]) + _filter_row(kind, row, prior).tobytes()
        prior = row
    z = zlib.compress(raw, 9)
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, colour, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"tEXt", b"Comment\x00test")
            + _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("image", ["noise", "ramp", "flat"])
def test_png_decodes_every_row_filter_as_opencv(tmp_path, image):
    rng = np.random.default_rng(3)
    h, w = 23, 37
    img = {"noise": rng.integers(0, 256, (h, w)),
           "ramp": (np.add.outer(np.arange(h) * 11, np.arange(w) * 7) % 256),
           "flat": np.full((h, w), 200)}[image].astype(np.uint8)
    filters = [y % 5 for y in range(h)]
    for name, rows in (("cycle", filters), ("random", rng.integers(0, 5, h).tolist())):
        path = tmp_path / f"{name}.png"
        path.write_bytes(_encode(img, rows))
        ours = png.read_png(str(path))
        np.testing.assert_array_equal(ours, cv2.imread(str(path), cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(ours, img)
    # OpenCV's own encoder (libpng's adaptive filters), and back the other way
    cv2.imwrite(str(tmp_path / "cv.png"), img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "cv.png")), img)
    png.write_png(str(tmp_path / "port.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED), img)


@pytest.mark.parametrize("depth,colour,interlace", [(16, 4, 0), (8, 6, 0), (8, 0, 1),
                                                    (4, 0, 0)])
def test_png_refuses_other_kinds(tmp_path, depth, colour, interlace):
    img = np.zeros((4, 6), np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_encode(img, [0] * 4, depth, colour, interlace))
    with pytest.raises(ValueError, match="only 8- or 16-bit grey or RGB"):
        png.read_png(str(path))
    data = bytearray(_encode(img, [0] * 4))
    data[-20] ^= 0xFF                               # a byte of the last IDAT's data
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(str(path))
    with pytest.raises(ValueError):
        png.write_png(str(path), img.astype(np.float32))


def _windows(gate_dir):
    """Every interval of the gate data, then windows the reader can meet:
    empty, one event, all at one time stamp, events of polarity 0 only."""
    seq = os.path.join(gate_dir, "sim_00")
    out = []
    for name in sorted(os.listdir(seq)):
        if name.startswith("events_"):
            with np.load(os.path.join(seq, name)) as z:
                out.append(np.stack((z["t"], z["x"], z["y"], z["p"]), axis=1))
    out += [np.empty((0, 4)), np.array([[0.5, 3.0, 4.0, 1.0]]),
            np.array([[0.5, 3.0, 4.0, 1.0], [0.5, 3.0, 4.0, 0.0], [0.5, 9.0, 1.0, 1.0]]),
            out[0][:500] * np.array([1.0, 1.0, 1.0, 0.0])]
    return out


def test_voxels_bit_for_bit_on_gate_data(gate_dir):
    """The port's plain numpy versions against the JAX package's numpy
    golden, and the host event library's voxel against both, bit for bit."""
    windows = _windows(gate_dir)
    assert len(windows) == 29 + 4 and len(windows[0]) > 10_000
    for ev in windows:
        for reverse in (False, True):
            ours = events_to_voxel_grid_numpy(ev, 5, W, H, is_reverse=reverse)
            ref = JV.events_to_voxel_grid_numpy(ev, 5, W, H, is_reverse=reverse)
            assert ours.dtype == ref.dtype == np.float32
            np.testing.assert_array_equal(ours, ref)
            np.testing.assert_array_equal(events_to_voxel_grid(ev, 5, W, H, is_reverse=reverse),
                                          ref)
            for hot in (False, True):
                a = event_preprocess_numpy(ours.copy(), filter_hot_pixel=hot)
                b = JV.event_preprocess_numpy(ref.copy(), filter_hot_pixel=hot)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_voxels_against_dispatching_functions(gate_dir):
    """The JAX eval's own functions, which run its native library by
    default: the port's host event library gives the same voxels and
    normalized voxels bit for bit (both built from one source with one set
    of flags; the JAX package here must have built its library)."""
    assert JV._USE_NATIVE and JN.get_lib() is not None
    for ev in _windows(gate_dir):
        for reverse in (False, True):
            ours = events_to_voxel_grid(ev, 5, W, H, is_reverse=reverse)
            theirs = JV.events_to_voxel_grid(ev, 5, W, H, is_reverse=reverse)
            assert ours.tobytes() == theirs.tobytes()
            for hot in (False, True):
                a = event_preprocess(ours.copy(), filter_hot_pixel=hot)
                b = JV.event_preprocess(ours.copy(), filter_hot_pixel=hot)
                assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_read_timestamps_file(tmp_path):
    for name, unit, text in (("timestamps.txt", "s", "frame_0000 0.5\nframe_0001 0.54\n"),
                             ("images.txt", "us", "1500000 a.png\n\n1540000 b.png\n"),
                             ("t.txt", "ns", "3e9\n3.04e9\n")):
        path = tmp_path / name
        path.write_text(text)
        assert readers.read_timestamps_file(str(path), unit) == \
            JVR.read_timestamps_file(str(path), unit)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("forward", [False, True])
def test_reader_packs_equal_the_jax_reader(gate_dir, monkeypatch, native, forward):
    """Every pack of one gate sequence: voxels bit for bit with the JAX
    reader, both on their default path (each package's host event library)
    or both on their numpy versions; frames and flows bit for bit, and the
    same end."""
    if not native:
        monkeypatch.setattr(JV, "_USE_NATIVE", False)
        monkeypatch.setattr(readers, "events_to_voxel_grid", events_to_voxel_grid_numpy)
        monkeypatch.setattr(readers, "event_preprocess", event_preprocess_numpy)
    seq = os.path.join(gate_dir, "sim_01")
    jr = JVR.ImageReader(JConfig(image_dim=(H, W), is_forward_flow=forward))
    tr = readers.ImageReader(Config(model_mode="cista-eiflow",
                                    image_dim=(H, W), is_forward_flow=forward))
    jr.initialize(seq, 50)
    tr.initialize(seq, 50)
    packs = 0
    while not jr.ending:
        assert not tr.ending
        jv, jframes, jgt, jflows = jr.update_event_frame_flow_pack("upsampled")
        tv, tframes, tgt, tflows = tr.update_event_frame_flow_pack("upsampled")
        assert len(tv) == len(jv) == 1 and len(tframes) == len(jframes) == 1
        np.testing.assert_array_equal(tv[0], jv[0])
        np.testing.assert_array_equal(tframes[0], jframes[0])
        np.testing.assert_array_equal(tgt, jgt)
        np.testing.assert_array_equal(tflows[0], jflows[0])
        assert tflows[0].dtype == np.float32 and tgt.dtype == np.float32
        packs += 1
    assert tr.ending and packs == 29


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
