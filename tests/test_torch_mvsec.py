"""The port's MVSEC path against the JAX package's, on the CPU.

- ``data/mvsec_utils.py``: ``remap_nearest`` bit for bit ``cv2.remap``'s
  nearest neighbour (maps at exactly .5, outside the frame, not finite),
  the GT flow carried across a frame pair, the dense flow error, the event
  rows and the triangular voxel, each bit for bit the JAX function;
- ``data/sim.write_mvsec_hdf5``: the port's files (its own HDF5 writer)
  hold the same arrays as the JAX package's (h5py), read by h5py;
- ``MVSEC`` and ``MVSEC_NE`` items bit for bit the JAX datasets' on files
  written by either package, every data mode, an indoor and an outdoor
  split;
- ``python -m cista_flow_torch.test_mvsec``'s ``evaluate`` against the root
  ``test_mvsec.evaluate`` on a simulated 48x64 sensor (the config's ``mvsec_sensor_size``)
  with a width-16 JAX-init checkpoint: the rows and every CSV byte for
  byte, the flow pictures as ``test_torch_cli.assert_same_outputs`` holds
  them, the reconstructions within one level on every pixel and equal on
  99% of them. The MVSEC CLI stretches each frame to 0..255 before it
  truncates to uint8 (``255 * (rec - min) / (max - min)``), which turns the
  two packages' f32 rounding of the frame (~1e-7) into a one-level step
  where a pixel sits on a level's edge (2 of 3072 pixels of one frame);
- ``python -m cista_flow_torch.evaluate --harness_mode mvsec`` saving and
  holding targets.

Both sides voxelize on their default path, each package's host event
library built from the same source, so both see the same voxels.
"""
import json
import types
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cista_flow_tpu.data import mvsec as JM
from cista_flow_tpu.data import mvsec_utils as JU
from cista_flow_tpu.data import sim as JSIM
from cista_flow_torch import evaluate as port_evaluate
from cista_flow_torch import test_mvsec
from cista_flow_torch.config import Config
from cista_flow_torch.data import hdf5
from cista_flow_torch.data import mvsec as M
from cista_flow_torch.data import mvsec_utils as U
from cista_flow_torch.data import sim

from test_torch_cli import COMMON, H, W, checkpoint, jax_cli, outputs
from test_torch_surface import jax_native_library

h5py = pytest.importorskip("h5py")
SPLIT = "indoor_flying4"
RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU shapes: the test
    runner's workers share the machine's cores, and torch's thread pools
    then wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def args(**kw):
    base = dict(num_bins=5, num_events=1500, mvsec_sensor_size=(H, W))
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("mvsec")


@pytest.fixture(scope="module")
def recordings(work):
    """indoor_flying4 at 48x64 (10 real frames) written by each package,
    and outdoor_day1 by the port."""
    out = {}
    for who, write in (("jax", JSIM.write_mvsec_hdf5), ("port", sim.write_mvsec_hdf5)):
        folder = work / who / SPLIT
        write(str(folder), split=SPLIT, n_real=10, h=H, w=W, seed=3, speed=40.0)
        out[who] = folder
    out["outdoor"] = work / "port_out" / "outdoor_day1"
    sim.write_mvsec_hdf5(str(out["outdoor"]), split="outdoor_day1", n_real=6, h=H, w=W, seed=4)
    return out


# ---- mvsec_utils ------------------------------------------------------------

def test_remap_nearest_is_cv2(monkeypatch):
    src = RNG.standard_normal((37, 71)).astype(np.float32)
    mx = (RNG.integers(-6, 2 * 71 + 6, (37, 71)) / 2).astype(np.float32)     # every .5
    my = (RNG.integers(-6, 2 * 37 + 6, (37, 71)) / 2).astype(np.float32)
    mx[0, :6] = [np.nan, np.inf, -np.inf, 1e9, -1e9, -0.5]
    my[1, :3] = [70.5, -0.5000001, 36.49999]
    mx[2] += RNG.standard_normal(71).astype(np.float32) * 40
    want = cv2.remap(src, mx, my, cv2.INTER_NEAREST)
    np.testing.assert_array_equal(U.remap_nearest(src, mx, my), want)
    assert (want == 0).sum() > 100                        # the border is exercised


@pytest.mark.parametrize("case", ["inside_one_map", "across_maps", "exact_bounds"])
def test_gt_flow_propagation_bit_for_bit(case):
    n, h, w = 4, 30, 41
    flows = (RNG.standard_normal((n, 2, h, w)) * 3).astype(np.float32)
    flows[1, :, 3:9, 5:12] = 0                            # zero flow masks pixels out
    ts = np.cumsum(np.r_[0.0, RNG.uniform(0.02, 0.05, n)]).astype(np.float32)
    start, end = {"inside_one_map": (float(ts[0]) + 0.004, float(ts[1]) - 0.003),
                  "across_maps": (float(ts[0]) + 0.01, float(ts[n]) - 0.005),
                  "exact_bounds": (float(ts[0]) + 1e-3, float(ts[n]))}[case]
    got = U.generate_corresponding_gt_flow(flows, ts, start, end)
    want = JU.generate_corresponding_gt_flow(flows, ts, start, end)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_flow_error_events_and_triangular_voxel():
    gt = RNG.standard_normal((20, 30, 2)).astype(np.float32)
    gt[2:5] = 0
    gt[7, 3, 0] = np.inf
    pred = gt + RNG.standard_normal(gt.shape).astype(np.float32)
    ev_img = (RNG.random((20, 30)) > 0.3).astype(np.float32)
    for kw in (dict(), dict(event_img=ev_img), dict(event_img=ev_img, is_car=True)):
        assert U.flow_error_dense(gt, pred, **kw) == JU.flow_error_dense(gt, pred, **kw)
    n = 3000
    ev = np.stack([RNG.integers(0, 64, n), RNG.integers(0, 48, n), np.sort(RNG.random(n)),
                   RNG.choice([-1.0, 1.0], n)], 1).astype(np.float64)
    assert U.events_to_txyp(ev).tobytes() == JU.events_to_txyp(ev).tobytes()
    for e in (ev, ev[:1], np.repeat(ev[:1], 4, 0)):       # one event; no time span
        got = U.events_to_voxel_triangular(e, 5, 48, 64)
        assert got.tobytes() == JU.events_to_voxel_triangular(e, 5, 48, 64).tobytes()


# ---- the files and the datasets ---------------------------------------------

def test_port_writer_holds_the_jax_arrays(recordings):
    for kind in ("data", "gt"):
        a = recordings["jax"] / f"{SPLIT}_{kind}.hdf5"
        b = recordings["port"] / f"{SPLIT}_{kind}.hdf5"
        with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb, hdf5.File(b) as fc:
            names = sorted(fa["davis/left"])
            assert names == sorted(fb["davis/left"]) == sorted(fc["davis/left"].keys())
            for n in names:
                x, y = fa["davis/left"][n][()], fb["davis/left"][n][()]
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n
                assert fc["davis/left"][n][()].tobytes() == x.tobytes(), n
            if kind == "data":
                assert fa["davis/left/image_raw"].chunks == (1, H, W)
                assert fb["davis/left/image_raw"].chunks is None       # contiguous


def same_tree(a, b, path="item"):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b) and a == b, path


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["full", "train", "val"])
def test_mvsec_ne_items_bit_for_bit(recordings, writer, mode):
    root = str(recordings[writer])
    a = args()
    jds = JM.MVSEC_NE(a, root, SPLIT, data_mode=mode)
    pds = M.MVSEC_NE(a, root, SPLIT, data_mode=mode)
    assert len(jds) == len(pds) and jds.INDEX_MAP == pds.INDEX_MAP
    real = [i for i in range(len(pds)) if pds.INDEX_MAP[i] < 8][:4]
    for i in real:
        jitem, pitem = jds[i], pds[i]
        same_tree(pitem, jitem)
        events = np.concatenate([c for c, _ in pitem[0]])
        same_tree(pds.events_to_voxel(events, H, W), jds.events_to_voxel(events, H, W))
        same_tree(pds.get_raw_events(i), jds.get_raw_events(i))


@pytest.mark.parametrize("where", ["jax", "port", "outdoor"])
def test_mvsec_items_bit_for_bit(recordings, where):
    root = str(recordings[where])
    split = "outdoor_day1" if where == "outdoor" else SPLIT
    jds, pds = JM.MVSEC(args(), root, split), M.MVSEC(args(), root, split)
    assert len(jds) == len(pds)
    for i in (0, 1, 3):
        same_tree(pds[i], jds[i])


# ---- the CLI and the harness ------------------------------------------------

def assert_same_mvsec_outputs(a: Path, b: Path) -> None:
    fa, fb = outputs(a), outputs(b)
    assert list(fa) == list(fb) and any(k.endswith("all.csv") for k in fa)
    for rel in fa:
        if rel.endswith(".csv"):
            assert fa[rel].read_bytes() == fb[rel].read_bytes(), rel
            continue
        x = cv2.imread(str(fa[rel]), cv2.IMREAD_UNCHANGED).astype(int)
        y = cv2.imread(str(fb[rel]), cv2.IMREAD_UNCHANGED).astype(int)
        assert x.shape == y.shape, rel
        d = np.abs(x - y)
        if "/flow/" in rel:
            assert d.max() <= 9 and (d.max(-1) == 0).mean() >= 0.90, (rel, d.max())
        else:
            assert d.max() <= 1 and (d == 0).mean() >= 0.99, (rel, d.max(), (d == 0).mean())


def cli_cfg(cls, recordings, out, **kw):
    base = dict(COMMON, model_mode="cista-eiflow", path_to_test_data=str(recordings["port"].parent),
                output_folder=str(out), num_events=400, test_img_num=7, is_write_flow=True)
    base.update(kw)
    cfg = cls(**base)
    cfg.mvsec_sensor_size = (H, W)
    return cfg


def test_mvsec_cli_matches_jax(work, recordings, tmp_path):
    """Pairs of 584-1034 events at 48x64 in chunks of about 400: 1 to 3
    windows of at least 320 events a pair, each pair ending on a window
    (every item scored); 7 items, the first 3 scored frames skipped. The
    rows are held as text, 4 decimals: per frame the packages' FWL differ
    by up to ~3e-5 relative (their flows by ~1e-5 px), so another setting
    can put a mean on a rounding edge (at 500 events a window FWL's mean is
    1.0227565 here and 1.0227428 in JAX, 1.0228 against 1.0227)."""
    ck = checkpoint(work, "cista-eiflow")
    from cista_flow_tpu.configs import Config as JConfig
    jrows, jkeys = jax_cli("test_mvsec").evaluate(
        cli_cfg(JConfig, recordings, tmp_path / "jax", path_to_test_model=ck))
    split = test_mvsec.HostSplit()
    rows, keys, _ = test_mvsec.evaluate(
        cli_cfg(Config, recordings, tmp_path / "port", path_to_test_model=ck), device="cpu",
        split=split)
    assert keys == jkeys == ["mse", "psnr", "ssim", "FWL"]
    assert [list(map(str, r)) for r in rows] == [list(map(str, r)) for r in jrows]
    assert [r[0] for r in rows] == [SPLIT, "mean"] and rows[-1][-1] == 4
    assert_same_mvsec_outputs(tmp_path / "jax", tmp_path / "port")
    ds = M.MVSEC_NE(args(num_events=400), str(recordings["port"]), SPLIT)
    assert [len(ds[i][0]) for i in range(7)] == [1, 3, 3, 3, 2, 2, 2]
    assert split.windows == 16 and {"chunking", "voxelize", "device", "metrics", "fwl",
                                     "writers"} <= set(split.seconds)


def test_mvsec_harness_saves_and_holds_targets(work, recordings, tmp_path, monkeypatch):
    """``evaluate --harness_mode mvsec``: ``--save_targets`` writes the mean
    row, the same run passes against it, a target moved by 1% fails at
    0.2%. The CLI has no sensor flag (the real sensor needs none), so the
    simulated 48x64 sensor goes in through ``config.from_args``, as
    ``tests/test_mvsec_rehearsal.py`` does for the JAX harness."""
    from_args = port_evaluate.config.from_args

    def small_sensor(a):
        cfg = from_args(a)
        cfg.mvsec_sensor_size = (H, W)
        return cfg

    monkeypatch.setattr(port_evaluate.config, "from_args", small_sensor)
    targets = tmp_path / "targets.json"
    flags = ["--harness_mode", "mvsec", "--targets", str(targets), "--path_to_test_data",
             str(recordings["port"].parent), "--test_data_name", SPLIT, "--image_dim", str(H),
             str(W), "-d", "1", "-c", "16",
             "--flow_iters", "1", "--num_events", "400", "--test_img_num", "5",
             "--path_to_test_model", checkpoint(work, "cista-eiflow"), "--device", "cpu",
             "-o", str(tmp_path / "out")]
    assert port_evaluate.main(flags + ["--save_targets"]) == 0
    saved = json.loads(targets.read_text())
    assert list(saved) == ["mse", "psnr", "ssim", "FWL"] and np.isfinite(list(saved.values())).all()
    assert port_evaluate.main(flags + ["--harness_tolerance", "0.002"]) == 0
    targets.write_text(json.dumps({**saved, "psnr": saved["psnr"] * 1.01}))
    assert port_evaluate.main(flags + ["--harness_tolerance", "0.002"]) == 1
    with pytest.raises(SystemExit):
        port_evaluate.parse_args(["--harness_mode", "mvsec_full", "--path_to_test_data", "x"])


def test_mvsec_main_parses_the_sensor_flag(recordings, tmp_path, monkeypatch):
    """``main`` builds its config from the flags and runs on the device it
    is given. Like the JAX CLI it has no ``--mvsec_sensor_size``: the
    sensor is DAVIS346's unless a caller sets the config's field."""
    seen = {}
    monkeypatch.setattr(test_mvsec, "evaluate",
                        lambda cfg, device=None: seen.update(cfg=cfg, device=device))
    assert test_mvsec.main(["--path_to_test_data", str(tmp_path), "--device", "cpu",
                            "--num_events", "3000"]) == 0
    assert seen["cfg"].mvsec_sensor_size is None and seen["device"] == "cpu"
    with pytest.raises(SystemExit):
        test_mvsec.main(["--path_to_test_data", str(tmp_path), "--mvsec_sensor_size", "48", "64"])
    assert seen["cfg"].num_events == 3000
    assert test_mvsec.discover_mvsec(Config(model_mode="cista-eiflow",
                                            path_to_test_data=str(recordings["port"].parent))) \
        == ([str(recordings["port"])], [SPLIT])


def small_sensor_flags(monkeypatch, work, recordings, **kw):
    """``test_mvsec.main``'s flags for the simulated 48x64 sensor, which
    goes in through ``config.from_args`` (the CLI has no sensor flag)."""
    from_args = test_mvsec.config.from_args

    def small_sensor(a):
        cfg = from_args(a)
        cfg.mvsec_sensor_size = (H, W)
        return cfg

    monkeypatch.setattr(test_mvsec.config, "from_args", small_sensor)
    return ["--model_mode", "cista-eiflow", "--image_dim", str(H), str(W), "-d", "1", "-c", "16",
            "--flow_iters", "1", "--path_to_test_data", str(recordings["port"].parent),
            "--num_events", "400", "--test_img_num", "7", "--is_write_flow",
            "--path_to_test_model", checkpoint(work, "cista-eiflow"), "--device", "cpu"]


MESH2 = ["--mesh_shape", "2", "--mesh_axes", "spatial"]


def test_mvsec_on_two_ranks_writes_one_process_files(work, recordings, tmp_path, monkeypatch):
    """``test_mvsec --mesh_shape 2 --mesh_axes spatial`` on two gloo ranks
    (rank 0 reads, scores and writes; each rank a 24-row band of the 48x64
    frame) against one process: every CSV byte for byte, the pictures as
    ``assert_same_mvsec_outputs`` holds them."""
    flags = small_sensor_flags(monkeypatch, work, recordings)
    for name, extra in (("one", []), ("two", MESH2)):
        assert test_mvsec.main(flags + ["-o", str(tmp_path / name)] + extra) == 0
    assert_same_mvsec_outputs(tmp_path / "one", tmp_path / "two")


def test_mvsec_mesh_refusals(work, recordings, monkeypatch, capsys):
    """A data axis and too many ranks for the frame refuse as in the other
    serving CLIs (``spatial.serving_world``)."""
    flags = small_sensor_flags(monkeypatch, work, recordings)
    for extra, message in ((["--mesh_shape", "2"], "replicates the stream"),
                           (["--mesh_shape", "8", "--mesh_axes", "spatial"],
                            "ranks for this frame")):
        with pytest.raises(SystemExit):
            test_mvsec.main(flags + extra)
        assert message in capsys.readouterr().err


@pytest.mark.slow
def test_mvsec_two_ranks_against_the_jax_mesh(work, recordings, tmp_path):
    """The root ``test_mvsec.evaluate`` on the JAX runner's own spatial
    mesh (2 virtual CPU devices) against the port's two ranks: the rows as
    text (4 decimals) and every CSV byte for byte, as
    ``test_mvsec_cli_matches_jax`` holds the unsharded pair."""
    from cista_flow_tpu.configs import Config as JConfig
    ck = checkpoint(work, "cista-eiflow")
    jrows, jkeys = jax_cli("test_mvsec").evaluate(
        cli_cfg(JConfig, recordings, tmp_path / "jax", path_to_test_model=ck,
                mesh_shape="2", mesh_axes="spatial"))
    cfg = cli_cfg(Config, recordings, tmp_path / "port", path_to_test_model=ck,
                  mesh_shape="2", mesh_axes="spatial")
    test_mvsec.spatial.serve(2, "cpu", "cista_flow_torch.test_mvsec", "evaluate", cfg)
    assert jkeys == ["mse", "psnr", "ssim", "FWL"]
    assert_same_mvsec_outputs(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_sim_main_writes_the_jax_files(tmp_path, mode):
    """``python -m cista_flow_torch.data.sim`` against the JAX module's
    ``main`` at the same flags: the same files, text and arrays equal,
    frames equal once decoded (each package has its own PNG encoder)."""
    flags = ["--mode", mode, "--image_dim", "24", "32", "--n_frames", "4", "--n_videos", "2",
             "--n_sequences", "2", "--seed", "3", "--speed", "50"]
    assert sim.main(["--out", str(tmp_path / "port"), *flags]) == 0
    assert JSIM.main(["--out", str(tmp_path / "jax"), *flags]) == 0
    a = {p.relative_to(tmp_path / "jax"): p for p in sorted((tmp_path / "jax").rglob("*.*"))}
    b = {p.relative_to(tmp_path / "port"): p for p in sorted((tmp_path / "port").rglob("*.*"))}
    assert list(a) == list(b) and len(a) >= 2 * 4 + 2
    for rel, path in a.items():
        if rel.suffix == ".png":
            np.testing.assert_array_equal(cv2.imread(str(b[rel]), cv2.IMREAD_UNCHANGED),
                                          cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
        elif rel.suffix == ".npz":
            x, y = np.load(path), np.load(b[rel])
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype and x[k].tobytes() == y[k].tobytes(), (rel, k)
        else:
            assert path.read_text() == b[rel].read_text(), rel


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
