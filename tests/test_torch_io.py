"""The port's writers, pictures, ``normalize_image`` and FWL against the
JAX package's, on the CPU.

Files are compared after decoding with ``cv2.imread`` (the port writes its
PNGs with its own codec, the JAX package with OpenCV); the CSV byte for
byte. The flow picture: the JAX package's comes from ``cv2.cartToPolar``
and ``cv2.cvtColor``; the port's computes the same angle polynomial and the
same HSV->BGR formula in numpy. It is held to the hue within 1 step (of
180) of OpenCV's on every pixel, the picture equal on at least 99% of its
pixels and within 9 levels elsewhere. FWL: within 1e-5 relative of the JAX
function (``F.grid_sample`` against the JAX package's gather, f32).
"""
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.data import io as JIO
from cista_flow_tpu.losses import fwl as JFWL
from cista_flow_tpu.utils import image as JIMG
from cista_flow_torch.config import Config
from cista_flow_torch.data import io, png
from cista_flow_torch.losses import fwl
from cista_flow_torch.utils import normalize_image

H, W = 48, 64


def voxel(seed, shape=(5, H, W)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 2 * (rng.random(shape) < 0.2)).astype(np.float32)


def read(path):
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


@pytest.mark.parametrize("kind", ["image", "events-gray", "events-red-blue", "flow"])
def test_writers_match_the_jax_writers(tmp_path, kind):
    """Same paths and file names; the decoded pictures equal (the flow
    picture at the tolerance of the module's docstring)."""
    rng = np.random.default_rng(1)
    kw = dict(is_write_event=True, is_write_flow=True)
    writers = {"image": (io.ImageWriter, JIO.ImageWriter), "flow": (io.FlowWriter, JIO.FlowWriter)}
    port_cls, jax_cls = writers.get(kind, (io.EventWriter, JIO.EventWriter))
    if kind == "image":
        arg = np.uint8(rng.random((H, W)).astype(np.float32) * 255.0)
    elif kind == "flow":
        arg = (rng.standard_normal((2, H, W)) * 4).astype(np.float32)
    else:
        mode = kind.split("-", 1)[1]
        arg = io.make_event_preview(voxel(2), mode=mode)
        np.testing.assert_array_equal(arg, JIO.make_event_preview(voxel(2), mode=mode))
    for i in (0, 7):
        port_cls(Config(model_mode="cista-eiflow",
                        output_folder=str(tmp_path / "port"), **kw), "m", "seq")(arg, i)
        jax_cls(JConfig(output_folder=str(tmp_path / "jax"), **kw), "m", "seq")(arg, i)
    files = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "jax")
                   for r, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 2 and files == sorted(
        os.path.relpath(os.path.join(r, f), tmp_path / "port")
        for r, _, fs in os.walk(tmp_path / "port") for f in fs)
    for rel in files:
        a, b = read(tmp_path / "port" / rel), read(tmp_path / "jax" / rel)
        assert a.shape == b.shape and a.dtype == b.dtype
        if kind == "flow":
            d = np.abs(a.astype(int) - b.astype(int)).max(-1)
            assert (d == 0).mean() >= 0.99 and d.max() <= 9
        else:
            np.testing.assert_array_equal(a, b)


def test_eval_writer_csv_byte_for_byte(tmp_path):
    header = ["Dataset", "mse", "psnr", "N_frames"]
    row = ["seq", np.float64(0.0123), np.float64(21.5), 26]
    for cfg, cls, out in ((Config, io.EvalWriter, "port"), (JConfig, JIO.EvalWriter, "jax")):
        w = cls(cfg(output_folder=str(tmp_path / out)), "model/3", "seq")
        w(header, row)
        w(header, row)
    rel = os.path.join("model", "3", "seq", "result.csv")
    assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    assert not os.path.exists(tmp_path / "off")
    io.EvalWriter(Config(model_mode="cista-eiflow",
                         output_folder=str(tmp_path / "off"), is_write_image=False), "m", "s")(
        header, row)
    assert not os.path.exists(tmp_path / "off" / "m")


@pytest.mark.parametrize("shape", [(3, 5), (48, 64), (180, 240), (7, 37)])
def test_rgb_png_decodes_as_opencv_writes_it(tmp_path, shape):
    """A BGR array written as colour type 2 decodes with ``cv2.imread`` to
    the same array, as ``cv2.imwrite``'s file does."""
    img = np.random.default_rng(shape[1]).integers(0, 256, (*shape, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(read(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read(tmp_path / "a.png"), read(tmp_path / "b.png"))
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "c.png"), img[..., :2])


@pytest.mark.parametrize("scale,shape", [(0.3, (180, 240)), (4.0, (180, 240)), (40.0, (48, 64)),
                                         (4.0, (37, 53)), (0.0, (48, 64))])
def test_flow_picture_against_opencv(scale, shape):
    rng = np.random.default_rng(int(scale * 10) + shape[1])
    flow = (rng.standard_normal((2, *shape)) * scale).astype(np.float32)
    flow[:, :4, :4] = 0.0                      # zero vectors, and axis-aligned ones
    flow[0, 5, :] = 0.0
    flow[1, 6, :] = 0.0
    ours, ref = io.merge_optical_flow(flow), JIO.merge_optical_flow(flow)
    assert ours.shape == ref.shape == (*shape, 3) and ours.dtype == np.uint8
    _, angle = cv2.cartToPolar(flow[0], flow[1])
    hue_ref = (angle * 180 / np.pi / 2).astype(np.uint8).astype(int)
    hue = (io.fast_atan2_deg(flow[1], flow[0]) * np.float32(np.pi / 180)
           * (180 / np.pi / 2)).astype(np.uint8).astype(int)
    step = np.abs(hue - hue_ref)
    assert np.minimum(step, 180 - step).max() <= 1
    d = np.abs(ours.astype(int) - ref.astype(int)).max(-1)
    assert (d == 0).mean() >= 0.99 and d.max() <= 9


def test_hsv_to_bgr_against_opencv():
    """Every hue, saturation and value, in rows of 256 and of 240 pixels
    (OpenCV's vector and scalar paths)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(0, 256, 5), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 256, 3)
    for img in (hsv, hsv.reshape(-1, 240, 3)[:, :240]):
        ref = cv2.cvtColor(np.ascontiguousarray(img), cv2.COLOR_HSV2BGR)
        ours = io.hsv_to_bgr(img[..., 0], img[..., 1], img[..., 2])
        d = np.abs(ours.astype(int) - ref.astype(int)).max(-1)
        assert (d == 0).mean() >= 0.99 and d.max() <= 1


@pytest.mark.parametrize("low,high", [(0, 100), (1, 99), (5, 50)])
def test_normalize_image_bit_for_bit(low, high):
    img = np.random.default_rng(low).random((H, W)).astype(np.float32) * 0.7 + 0.1
    ours, ref = normalize_image(img, low, high), JIMG.normalize_image(img, low, high)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("reverse", [False, True])
def test_voxel_warping_flow_loss_matches_jax(reverse):
    v = voxel(3, (2, 5, H, W))
    f = (np.random.default_rng(4).standard_normal((2, 2, H, W)) * 3).astype(np.float32)
    ref = float(JFWL.voxel_warping_flow_loss(jnp.asarray(v.transpose(0, 2, 3, 1)),
                                             jnp.asarray(f.transpose(0, 2, 3, 1)), reverse))
    ours = float(fwl.voxel_warping_flow_loss(torch.from_numpy(v), torch.from_numpy(f), reverse))
    assert abs(ours - ref) <= 1e-5 * abs(ref)


def test_fwl_metric_matches_jax():
    v = voxel(5, (1, 5, H, W))
    for scale in (0.5, 6.0):
        f = (np.random.default_rng(6).standard_normal((1, 2, H, W)) * scale).astype(np.float32)
        ref = float(JFWL.fwl_metric(jnp.asarray(v.transpose(0, 2, 3, 1)),
                                    jnp.asarray(f.transpose(0, 2, 3, 1))))
        ours = float(fwl.fwl_metric(torch.from_numpy(v), torch.from_numpy(f)))
        assert abs(ours - ref) <= 1e-5 * abs(ref)
    assert float(fwl.fwl_metric(torch.from_numpy(v), torch.zeros(1, 2, H, W))) == 1.0
