"""The port's FlyingChairs2 path against the JAX package's, on the CPU.

- ``data/png.py``'s 8-bit RGB and 16-bit grey and RGB against
  ``cv2.imread`` (every row filter at 3 and 6 bytes a pixel, libpng's own
  files both ways);
- ``data/file_io.py`` against the JAX ``file_io`` (``.flo``, PFM, KITTI's
  16-bit flows, PPM, ``read_gen``, ``read_event_h5`` on h5py's and the
  port's files);
- ``augmentors``: ``resize_flow``, the HSV conversions and ``ColorJitter``
  against the JAX versions (OpenCV) at the tolerances found: ``resize_flow``
  within 5e-7 px, hue within 1e-4 degrees and S, V, RGB within 1e-6, the
  jitter's uint8 within one level on under 1% of the channels; the flips,
  crops and draws bit for bit;
- ``FlyingChairs2`` items (train, val, ``trainval``, ``is_bi``, with and
  without augmentation) against the JAX dataset on one folder written by
  ``data.sim.write_chairs2_dataset``: bit for bit, the augmented frames
  within the jitter's level;
- ``fetch_dataset`` and ``fetch_test_dataset`` for every stage;
- ``pretrain_flow.main --data_kind chairs2 --device cpu`` for DCEIFlow
  (``--is_bi``) and RAFT: its first batch is the JAX ``make_batches`` over
  the JAX ``FlyingChairs2`` with the same seed, and its checkpoint loads
  strictly (DCEIFlow through the trainer's ``--path_to_flownet``, RAFT into
  ``models.raft.RAFT``).
"""
import struct
import types
import zlib

import cv2
import numpy as np
import pytest
import torch

from cista_flow_tpu.data import augmentors as JA
from cista_flow_tpu.data import file_io as JF
from cista_flow_tpu.data.flying_chairs2 import FlyingChairs2 as JFlyingChairs2
from cista_flow_tpu.losses import combine as JC
from cista_flow_torch import pretrain_flow as pf
from cista_flow_torch.config import Config
from cista_flow_torch.data import augmentors as A
from cista_flow_torch.data import file_io as F
from cista_flow_torch.data import hdf5, png, sim
from cista_flow_torch.data.flying_chairs2 import FlyingChairs2
from cista_flow_torch.losses import combine as C

h5py = pytest.importorskip("h5py")
RNG = np.random.default_rng(11)
H, W = 40, 80            # the fixture's frames; crops of 32x64 (RAFT's /32)
CROP = (32, 64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU shapes: the test
    runner's workers share the machine's cores, and torch's thread pools
    then wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chairs2")
    sim.write_chairs2_dataset(str(root), 5, H, W, seed=2, split="train")
    sim.write_chairs2_dataset(str(root), 2, H, W, seed=9, split="val")
    return str(root)


def args(**kw):
    return types.SimpleNamespace(**{"num_bins": 5, "is_bi": False, **kw})


# ---- PNG ---------------------------------------------------------------------

def _filter_row(kind, row, prior, bpp):
    row, prior = row.astype(int), prior.astype(int)
    left = np.r_[np.zeros(bpp, int), row[:-bpp]]
    upleft = np.r_[np.zeros(bpp, int), prior[:-bpp]]
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prior
    elif kind == 3:
        pred = (left + prior) // 2
    else:
        p = left + prior - upleft
        pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
    return ((row - pred) % 256).astype(np.uint8)


def encode(img, filters):
    """An RGB or grey PNG of uint8 or uint16 ``img`` (RGB order) with the
    given filter per row."""
    depth = 8 * img.dtype.itemsize
    colour = 2 if img.ndim == 3 else 0
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(img.shape[0], -1)
    rows = rows.view(np.uint8).reshape(img.shape[0], -1)
    bpp = (3 if colour else 1) * depth // 8
    prior, raw = np.zeros(rows.shape[1], np.uint8), b""
    for row, kind in zip(rows, filters):
        raw += bytes([kind]) + _filter_row(kind, row, prior, bpp).tobytes()
        prior = row

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", img.shape[1], img.shape[0], depth, colour, 0, 0, 0)
    return (png.SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 9))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "grey16"])
def test_png_rgb_and_16_bit_against_opencv(tmp_path, kind):
    h, w = 19, 29
    dtype = np.uint8 if kind == "rgb8" else np.uint16
    shape = (h, w) if kind == "grey16" else (h, w, 3)
    img = RNG.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    img[::3] = img[::3] // 64                                  # smooth rows among the noise
    for name, rows in (("cycle", [y % 5 for y in range(h)]),
                       ("random", RNG.integers(0, 5, h).tolist())):
        path = tmp_path / f"{name}.png"
        path.write_bytes(encode(img, rows))
        ours = png.read_png(str(path))
        cv = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(ours, cv if cv.ndim == 2 else cv[:, :, ::-1])
        np.testing.assert_array_equal(ours, img)
        assert ours.dtype == dtype
    bgr = img if img.ndim == 2 else img[:, :, ::-1]
    cv2.imwrite(str(tmp_path / "cv.png"), bgr)                 # libpng's adaptive filters
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "cv.png")), img)
    png.write_png(str(tmp_path / "port.png"), bgr)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, bgr)
    assert got.dtype == dtype


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "grey8", "grey16"])
def test_png_paeth_rows_written_and_read_as_opencv(tmp_path, kind):
    """``write_png(row_filter=4)``: every row's filter byte is 4, OpenCV
    reads the array back, and so does the reader's diagonal decode."""
    h, w = 23, 31
    dtype = np.uint16 if kind.endswith("16") else np.uint8
    shape = (h, w, 3) if kind.startswith("rgb") else (h, w)
    img = RNG.integers(0, np.iinfo(dtype).max, shape, endpoint=True).astype(dtype)
    img[::4] = img[::4] // 64
    path = str(tmp_path / "paeth.png")
    png.write_png(path, img, row_filter=4)
    data = open(path, "rb").read()
    idat = data.index(b"IDAT")
    (n,) = struct.unpack(">I", data[idat - 4:idat])
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8).reshape(h, -1)
    assert (raw[:, 0] == 4).all()
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_png(path), img if img.ndim == 2 else img[:, :, ::-1])
    with pytest.raises(ValueError, match="row filter 0 or 4"):
        png.write_png(path, img, row_filter=3)


# ---- file_io -----------------------------------------------------------------

def test_flo_pfm_and_kitti_against_jax(tmp_path):
    flow = RNG.standard_normal((13, 17, 2)).astype(np.float32) * 20
    F.write_flo(str(tmp_path / "p.flo"), flow)
    JF.write_flo(str(tmp_path / "j.flo"), flow)
    assert (tmp_path / "p.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(F.read_flo(str(tmp_path / "j.flo")), flow)
    np.testing.assert_array_equal(F.read_dense_flow(str(tmp_path / "j.flo")),
                                  JF.read_dense_flow(str(tmp_path / "j.flo")))
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        F.read_flo(str(tmp_path / "bad.flo"))
    for colour, scale, endian in ((True, -1.0, "<"), (False, 1.0, ">")):
        shape = (7, 9, 3) if colour else (7, 9)
        data = RNG.standard_normal(shape).astype(endian + "f4")
        path = tmp_path / f"x{colour}.pfm"
        path.write_bytes(b"PF\n" if colour else b"Pf\n")
        with open(path, "ab") as f:
            f.write(b"9 7\n" + f"{scale}\n".encode() + data.tobytes())
        np.testing.assert_array_equal(F.read_pfm(str(path)), JF.read_pfm(str(path)))
        np.testing.assert_array_equal(F.read_dense_flow(str(path)), JF.read_dense_flow(str(path)))
    valid = (RNG.random((13, 17)) > 0.3).astype(np.float32)
    JF.write_flow_kitti(str(tmp_path / "j.png"), flow, valid)
    F.write_flow_kitti(str(tmp_path / "p.png"), flow, valid)
    for src in ("j.png", "p.png"):
        for ours, theirs in zip(F.read_flow_kitti(str(tmp_path / src)),
                                JF.read_flow_kitti(str(tmp_path / src))):
            assert ours.dtype == theirs.dtype
            np.testing.assert_array_equal(ours, theirs)
    cv2.imwrite(str(tmp_path / "cv8.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="16-bit RGB"):
        F.read_flow_kitti(str(tmp_path / "cv8.png"))


def test_read_gen_against_jax(tmp_path):
    rgb = RNG.integers(0, 256, (11, 14, 3), dtype=np.uint8)
    grey = RNG.integers(0, 256, (11, 14), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), rgb)
    cv2.imwrite(str(tmp_path / "g.png"), grey)
    cv2.imwrite(str(tmp_path / "c.ppm"), rgb)
    cv2.imwrite(str(tmp_path / "g.pgm"), grey)
    for name in ("c.png", "g.png", "c.ppm"):
        ours, theirs = F.read_gen(str(tmp_path / name)), JF.read_gen(str(tmp_path / name))
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(F.read_pnm(str(tmp_path / "g.pgm")),
                                  cv2.imread(str(tmp_path / "g.pgm"), cv2.IMREAD_UNCHANGED))
    assert F.read_gen(str(tmp_path / "g.pgm")) == JF.read_gen(str(tmp_path / "g.pgm")) == []
    np.save(tmp_path / "a.npy", rgb)
    (tmp_path / "a.npy").rename(tmp_path / "a.bin")
    np.testing.assert_array_equal(F.read_gen(str(tmp_path / "a.bin")),
                                  JF.read_gen(str(tmp_path / "a.bin")))
    cv2.imwrite(str(tmp_path / "x.jpg"), rgb)
    with pytest.raises(ValueError, match="JPEG"):
        F.read_gen(str(tmp_path / "x.jpg"))
    assert F.read_gen(str(tmp_path / "x.txt")) == JF.read_gen(str(tmp_path / "x.txt")) == []


def test_read_event_h5_against_jax(tmp_path):
    n = 500
    cols = {"x": RNG.integers(0, 80, n), "y": RNG.integers(0, 40, n),
            "t": np.sort(RNG.random(n)), "p": RNG.choice([-1, 1], n)}
    with h5py.File(tmp_path / "h.hdf5", "w") as f:
        for k, v in cols.items():
            f[k] = v
    hdf5.write_h5(tmp_path / "p.hdf5", cols)
    for name in ("h.hdf5", "p.hdf5"):
        ours, theirs = F.read_event_h5(str(tmp_path / name)), JF.read_event_h5(str(tmp_path / name))
        assert ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)


# ---- augmentors --------------------------------------------------------------

@pytest.mark.parametrize("size", [(74, 106), (19, 27), (50, 40), (111, 53), (18, 26)])
def test_resize_flow_against_opencv(size):
    flow = RNG.standard_normal((37, 53, 2)).astype(np.float32) * 5
    ours, theirs = A.resize_flow(flow, *size), JA.resize_flow(flow, *size)
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=5e-7 * max(size[1] / 53, 1) * 5)


def test_hsv_conversions_against_opencv():
    img = RNG.random((61, 93, 3)).astype(np.float32)
    img[0, :4] = [[0.5] * 3, [0, 0, 0], [1, 1, 0], [0, 1, 1]]    # grey, black, ties
    img[1, :2] = [[1, 1, 1], [0.2, 0.2, 0.9]]
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    ours = A.rgb_to_hsv(img)
    np.testing.assert_allclose(ours[..., 0], hsv[..., 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours[..., 1:], hsv[..., 1:], rtol=0, atol=1e-6)
    hsv[..., 0] = (hsv[..., 0] + 123.4) % 360.0
    np.testing.assert_allclose(A.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_against_jax(seed):
    img = np.concatenate([RNG.integers(0, 256, (24, 40, 3)),
                          np.repeat(RNG.integers(0, 256, (24, 40, 1)), 3, -1)]).astype(np.uint8)
    ours = A.ColorJitter(rng=np.random.default_rng(seed))
    theirs = JA.ColorJitter(rng=np.random.default_rng(seed))
    for _ in range(4):
        a, b = ours(img), theirs(img)
        d = np.abs(a.astype(int) - b.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert ours.rng.random() == theirs.rng.random()            # the same draws


# ---- FlyingChairs2 -----------------------------------------------------------

def same_item(a, b, image_levels=0):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if image_levels and k in ("gt_img0", "gt_img1"):
            d = np.abs(a[k] * 255 - b[k] * 255)
            assert d.max() <= image_levels + 1e-3 and (d > 0.5).mean() < 0.01, k
        else:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kind, is_bi, aug", [("train", False, False), ("train", True, False),
                                              ("train", True, True), ("val", False, False),
                                              ("trainval", False, False), ("train", False, True)])
def test_flying_chairs2_items_against_jax(chairs, kind, is_bi, aug):
    aug_params = {"crop_size": CROP, "do_flip": True, "seed": 4} if aug else None
    a = args(is_bi=is_bi)
    ours = FlyingChairs2(a, chairs, data_kind=kind, aug_params=aug_params, validate_indices=[1, 3])
    theirs = JFlyingChairs2(a, chairs, data_kind=kind, aug_params=aug_params,
                            validate_indices=[1, 3])
    assert len(ours) == len(theirs) == {"train": 3, "val": 2, "trainval": 2}[kind]
    for i in range(len(ours)):
        item = ours[i]
        same_item(item, theirs[i], image_levels=1 if aug else 0)
        assert item["gt_img0"].shape == ((3,) + (CROP if aug else (H, W)))
        assert ("event_voxel_bw" in item) == is_bi


def test_fetch_datasets_every_stage(chairs, tmp_path):
    for split in ("indoor_flying1", "indoor_flying2", "indoor_flying3", "outdoor_day1",
                  "outdoor_day2"):
        sim.write_mvsec_hdf5(str(tmp_path / "mvsec"), split=split, n_real=4, h=16, w=24, seed=1)
    a = args(stage="chairs2", image_dim=CROP)
    train, vals, names = C.fetch_dataset(a, chairs)
    jtrain, jvals, jnames = JC.fetch_dataset(a, chairs)
    assert names == jnames == ["chairs2trainval"] and len(train) == len(jtrain) == 5
    assert len(vals[0]) == len(jvals[0]) == 0                  # no validate_indices
    assert train[0]["gt_img0"].shape == (3,) + CROP and train.augmentor.do_flip
    for stage, n in (("chairs2", 2), ("chairs2val", 2), ("chairs2train", 5), ("mvsec", 5),
                     ("mvsecfull", 5)):
        a = args(stage=stage)
        sets, names = C.fetch_test_dataset(a, chairs, str(tmp_path / "mvsec"))
        jsets, jnames = JC.fetch_test_dataset(a, chairs, str(tmp_path / "mvsec"))
        assert names == jnames and len(sets) == len(jsets) == (5 if "mvsec" in stage else 1)
        assert len(sets[0]) == len(jsets[0])
        if "mvsec" in stage:
            assert [len(s) for s in sets] == [len(s) for s in jsets]
            same_item(sets[3][0], jsets[3][0])                 # outdoor: the 256 crop branch
        else:
            assert len(sets[0]) == n
            same_item(sets[0][0], jsets[0][0])
    for fn in (C.fetch_dataset, C.fetch_test_dataset):
        with pytest.raises(NotImplementedError):
            fn(args(stage="things"), chairs)


# ---- pretrain_flow --data_kind chairs2 ----------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_flow_forward_gives_dceiflow_dense_frames(train):
    """An RGB batch's first channel reaches DCEIFlow dense. The strided
    slice ``gt_img0[:, :1]`` made ``2 * image - 1`` channels-last (C is 1),
    cuDNN's first conv kept that layout, and K4 refuses a non-contiguous
    input on the card."""
    model = pf.flow_net("dceiflow", Config(model_mode="cista-eiflow", image_dim=CROP), "cpu")
    seen = []
    model.register_forward_pre_hook(
        lambda m, a, kw: seen.extend([a[1], kw.get("image2")]), with_kwargs=True)
    g = torch.Generator().manual_seed(0)
    batch = {"event_voxel": torch.randn(2, 5, *CROP, generator=g),
             "gt_img0": torch.rand(2, 3, *CROP, generator=g),
             "gt_img1": torch.rand(2, 3, *CROP, generator=g)}
    with torch.no_grad():
        pf.flow_forward(model, batch, "dceiflow", 1, train=train)
    frames = [f for f in seen if f is not None]
    assert len(frames) == (2 if train else 1)
    assert all(f.shape == (2, 1, *CROP) and f.is_contiguous() for f in frames)
    assert all(torch.equal(f, batch[k][:, :1]) for f, k in zip(frames, ("gt_img0", "gt_img1")))


@pytest.mark.parametrize("arch, extra", [("dceiflow", ["--is_bi", "--is_reverse_events"]),
                                         ("raft", ["--opt", "raft"])])
def test_pretrain_cli_on_chairs2(chairs, tmp_path, monkeypatch, arch, extra):
    """Two steps of two samples on the CPU; the first batch against the JAX
    ``make_batches`` over the JAX ``FlyingChairs2`` (flips, crops and order
    bit for bit, the frames within the jitter's level); a finite loss; the
    checkpoint loads strictly."""
    import pretrain_flow as jpf             # the JAX package's root script
    seen = []
    to_device = pf.to_device
    monkeypatch.setattr(pf, "to_device", lambda b, d: seen.append(b) or to_device(b, d))
    losses = []
    make_step = pf.make_train_step

    def step_logging(*a, **kw):
        step = make_step(*a, **kw)
        return lambda model, batch: losses.append(step(model, batch)) or losses[-1]
    monkeypatch.setattr(pf, "make_train_step", step_logging)
    models = tmp_path / "models"
    flags = ["--data_kind", "chairs2", "--flow_arch", arch, "--path_to_train_data", chairs,
             "--path_to_model", str(models), "--image_dim", *map(str, CROP), "--flow_iters", "1",
             "--batch_size", "2", "--epochs", "1", "--seed", "5", "--device", "cpu", *extra]
    assert pf.main(flags) == 0
    assert len(seen) == 2 and all(np.isfinite(float(loss)) for loss, _ in losses)

    ja = args(is_bi="--is_bi" in extra)
    jds = JFlyingChairs2(ja, chairs, data_kind="train",
                         aug_params={"crop_size": CROP, "do_flip": True, "seed": 5})
    first = next(jpf.make_batches(jds, 2, True, np.random.default_rng(5)))
    ours = seen[0]
    assert sorted(ours) == sorted(first)
    # the frames and flows of an item are transposed views; the batch is dense
    assert all(v.flags["C_CONTIGUOUS"] for v in ours.values())
    same_item({k: ours[k] for k in first},
              {k: np.ascontiguousarray(np.moveaxis(v, -1, 1)) for k, v in first.items()},
              image_levels=1)

    ckpt = models / f"{arch}_b5" / f"{arch}_1.pth.tar"
    saved = torch.load(ckpt, weights_only=True)
    assert sorted(saved) == ["epoch", "model"]
    if arch == "raft":
        from cista_flow_torch.models.raft import RAFT
        RAFT().load_state_dict(saved["model"], strict=True)
        return
    from cista_flow_torch.data.sim import write_train_dataset
    from cista_flow_torch.train import Trainer
    root = tmp_path / "seq"
    write_train_dataset(str(root), 1, 3, 32, 64, seed=0)
    trainer = Trainer(Config(model_mode="cista-eiflow", image_dim=(32, 64),
                             path_to_train_data=str(root), path_to_model=str(tmp_path / "t"),
                             path_to_flownet=str(ckpt), len_sequence=2, depth=1), "cpu")
    got = trainer.model.event_flownet.state_dict()
    assert sorted(got) == sorted(saved["model"])
    for k, v in saved["model"].items():
        assert torch.equal(got[k], v), k
