"""The port's event stream readers and sequence reader against the JAX
package's, on the CPU, bit for bit.

Streams are simulated windows (the port's simulator at 48x64) written as
the reference's text: ``t x y p`` lines with ``%.6f`` or ``%.9f``
timestamps, a ``W H`` header line for ``FixedSizeEventReader`` (which skips
it) and none for ``RefTimeEventReaderZip`` (ECD's layout; the JAX reader
refuses a header line), zipped for ``.zip``. The JAX readers parse with
pandas' C parser, the port's with ``np.loadtxt``; on these files every
timestamp is the same float64, so every window is compared with
``assert_array_equal``. Both sides voxelize on their default path, each
package's host event library.
"""
import os
import zipfile

import numpy as np
import pytest

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.data import event_readers as JER
from cista_flow_tpu.data import video_readers as JVR
from cista_flow_torch.config import Config
from cista_flow_torch.data import png, readers, sim
from test_torch_surface import jax_native_library

H, W = 48, 64


def write_stream(path, events: np.ndarray, fmt: str, header: bool) -> str:
    """(N, 4) events as a text stream at ``path`` (.txt, .csv or .zip)."""
    base, ext = os.path.splitext(path)
    txt = base + ".txt" if ext == ".zip" else path
    with open(txt, "w") as f:
        if header:
            f.write(f"{W} {H}\n")
        np.savetxt(f, events, fmt=fmt + " %d %d %d")
    if ext == ".zip":
        with zipfile.ZipFile(path, "w") as z:
            z.write(txt, "events.txt")
        os.remove(txt)
    return str(path)


@pytest.fixture(scope="module")
def sequence():
    return sim.simulate_sequence(5, 9, H, W)


def all_events(sq, t_offset=0.0) -> np.ndarray:
    ev = np.concatenate([np.stack(w, 1) for w in sq["events"]])
    ev[:, 0] += t_offset
    return ev


def assert_windows_equal(port, ref) -> int:
    port, ref = list(port), list(ref)
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    return len(port)


@pytest.mark.parametrize("ext", [".txt", ".zip", ".csv"])
@pytest.mark.parametrize("k_shift,skip", [(-1, 0), (-1, 7), (350, 0), (350, 3)])
def test_fixed_size_reader_matches_jax(tmp_path, sequence, ext, k_shift, skip):
    """Windows of 1000 events (the last one short), with the ``k_shift``
    overlap and ``n_event_skip`` events skipped after the header, from
    timestamps written with 6 and 9 decimals (and an offset of 1234.5 s,
    so that the text holds 10 and 13 significant digits)."""
    for fmt in ("%.6f", "%.9f"):
        path = write_stream(tmp_path / f"events{ext}", all_events(sequence, 1234.5), fmt, True)
        n = assert_windows_equal(readers.FixedSizeEventReader(path, 1000, k_shift, skip),
                                 JER.FixedSizeEventReader(path, 1000, k_shift, skip))
        assert n >= 9


@pytest.mark.parametrize("ext", [".txt", ".zip"])
def test_ref_time_reader_matches_jax(tmp_path, sequence, ext):
    """Windows cut at the frames' timestamps, times from the first frame's."""
    path = write_stream(tmp_path / f"events{ext}", all_events(sequence), "%.9f", False)
    t = list(sequence["timestamps"])
    n = assert_windows_equal(readers.RefTimeEventReaderZip(path, t),
                             JER.RefTimeEventReaderZip(path, t))
    assert n == len(t) - 1


def make_sequence(root, sequence, single_file: bool) -> str:
    """The eval layout; with ``single_file`` the per-interval event files
    become one headerless ``events.zip`` (the flow files stay)."""
    seq = os.path.join(root, "seq")
    sim.write_eval_sequence(seq, sequence)
    if single_file:
        for f in os.listdir(seq):
            if f.startswith("events_"):
                os.remove(os.path.join(seq, f))
        write_stream(os.path.join(seq, "events.zip"), all_events(sequence), "%.9f", False)
    return seq


@pytest.mark.parametrize("single_file", [False, True], ids=["npz", "zip"])
@pytest.mark.parametrize("pack,mode,limit", [
    ("update_event_frame_pack", "upsampled", -1),
    ("update_event_frame_pack", "upsampled", 2500),
    ("update_event_frame_pack", "real", 700),
    ("update_event_frame_pack_fix", "upsampled", 2500),
    ("update_event_frame_pack_fix", "real", 1200),
    ("update_event_frame_pack_fix", "real", -1),
    ("update_event_frame_flow_pack", "upsampled", None),
])
def test_image_reader_packs_match_jax(tmp_path, sequence, single_file, pack, mode,
                                      limit):
    """Every pack of a sequence until the reader ends: voxels (one, or
    ``round(n / limit)`` in 'real' mode, hot pixels filtered), the frame
    pack, the GT frame (and the GT flows) bit for bit, and the same end."""
    seq = make_sequence(str(tmp_path), sequence, single_file)
    jr = JVR.ImageReader(JConfig(image_dim=(H, W)))
    tr = readers.ImageReader(Config(model_mode="cista-eiflow", image_dim=(H, W)))
    jr.initialize(seq, -1)
    tr.initialize(seq, -1)
    args = (mode,) if limit is None else (limit, mode)
    packs, voxels = 0, 0
    while not jr.ending:
        assert not tr.ending
        got, ref = getattr(tr, pack)(*args), getattr(jr, pack)(*args)
        assert len(got) == len(ref)
        assert len(got[0]) == len(ref[0]) >= 1
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_array_equal(a, b)
        assert len(got[1]) == len(ref[1])
        for a, b in zip(got[1], ref[1]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got[2], ref[2])
        for a, b in zip(got[3:], ref[3:]):                   # the GT flows
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        packs += 1
        voxels += len(got[0])
    assert tr.ending and packs >= 2
    if mode == "real" and limit is not None and 0 < limit < 1000:
        assert voxels > packs                                # several voxels a pack


def test_events_outside_the_frame_are_dropped(tmp_path, sequence):
    """``update_event_frame_pack_fix`` keeps x < W and y < H: a stream
    recorded at a larger size read at the frame's, as the JAX reader."""
    seq = make_sequence(str(tmp_path), sequence, True)
    ev = all_events(sequence)
    rng = np.random.default_rng(3)
    far = rng.random(len(ev)) < 0.1
    ev[far, 1] += W
    ev[far[::-1], 2] += H
    write_stream(os.path.join(seq, "events.zip"), ev, "%.9f", False)
    jr = JVR.ImageReader(JConfig(image_dim=(H, W)))
    tr = readers.ImageReader(Config(model_mode="cista-eiflow", image_dim=(H, W)))
    jr.initialize(seq, -1)
    tr.initialize(seq, -1)
    while not jr.ending:
        a, b = tr.update_event_frame_pack_fix(1500, "real"), jr.update_event_frame_pack_fix(
            1500, "real")
        for x, y in zip(a[0], b[0]):
            np.testing.assert_array_equal(x, y)


def test_jpeg_frames_raise(tmp_path):
    seq = tmp_path / "seq"
    seq.mkdir()
    png.write_png(str(seq / "frame_0000.png"), np.zeros((H, W), np.uint8))
    (seq / "frame_0001.jpg").write_bytes(b"\xff\xd8\xff")
    (seq / "timestamps.txt").write_text("frame_0000 0.0\nframe_0001 0.04\n")
    with pytest.raises(ValueError, match="JPEG"):
        readers.ImageReader(Config(model_mode="cista-eiflow",
                                   image_dim=(H, W))).initialize(str(seq))


def test_zip_stream_with_several_members_raises(tmp_path):
    path = tmp_path / "events.zip"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("a.txt", "0 0\n")
        z.writestr("b.txt", "0 0\n")
    with pytest.raises(ValueError, match="one file"):
        readers.FixedSizeEventReader(str(path), 10)


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
