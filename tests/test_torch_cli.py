"""The port's three serving CLIs against the JAX package's root CLIs of the
same name, on the CPU, on tiny simulated data (48x64).

Each case runs ``cista_flow_torch.<cli>`` with ``device='cpu'`` and the
root ``<cli>.py`` of the JAX package at the same flags, on the same data
and the same reference-layout checkpoint: a JAX ``composite.init`` at width
16, depth 1, written with ``ti.save_torch_checkpoint`` and served with
``flow_iters`` 1. Both sides voxelize on their default path, each
package's host event library built from the same source, so both see the
same voxels bit for bit. Held: the ``all.csv`` rows equal to 4 decimals
(the CSVs' text), every written PNG equal after decoding, the output
trees' relative paths equal. Flow pictures are held loosely: the two packages' flows differ by
f32 rounding (about 1e-5 px), which moves a hue or value bin where a pixel
sits on its edge, so a flow picture is held to within 9 levels on every
pixel and equal on at least 90% of them.

The cases: ``test_wo_flow`` with ``--dataset ECD`` on a ``.zip`` stream
under cista-eiflow ('upsampled' windows in the fast tier; 'real' windows,
whose JAX CLI compiles a second window length, slow), ``test_with_flow
--is_gt_flow`` under cista-gtflow (fast tier), ``test_noeval`` on a
``.txt`` stream under cista-idnet (slow: the JAX CLI compiles two window
lengths), and the samsung rotation of ``tests/test_cli_e2e.py:197-244``
through the port.
"""
import os
import sys
import zipfile
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest

from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import composite as JCOMP
from cista_flow_torch import test_noeval, test_with_flow, test_wo_flow
from cista_flow_torch.config import Config
from cista_flow_torch.data import sim
from test_torch_surface import jax_native_library

REPO = Path(__file__).resolve().parent.parent
H, W = 48, 64
COMMON = dict(image_dim=(H, W), depth=1, base_channels=16, flow_iters=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU shapes: the test
    runner's workers share the machine's cores, and torch's thread pools
    then wait on one another."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


def checkpoint(work: Path, mode: str) -> str:
    path = work / f"{mode}_init.pth.tar"
    if not path.exists():
        cfg = JConfig(image_dim=(H, W), model_mode=mode, depth=1, base_channels=16)
        params, mstate = JCOMP.init(jax.random.PRNGKey(0), cfg)
        ti.save_torch_checkpoint(str(path), params, mstate, mode, epoch=1, depth=1)
    return str(path)


def write_stream(path: Path, windows, header: bool) -> None:
    """The simulated windows as one text stream (``t x y p``, ``%.9f``
    timestamps), with a ``W H`` header line for ``FixedSizeEventReader``;
    zipped when ``path`` ends in ``.zip``."""
    ev = np.concatenate([np.stack(w, 1) for w in windows])
    txt = path.with_suffix(".txt")
    with open(txt, "w") as f:
        if header:
            f.write(f"{W} {H}\n")
        np.savetxt(f, ev, fmt="%.9f %d %d %d")
    if path.suffix == ".zip":
        with zipfile.ZipFile(path, "w") as z:
            z.write(txt, "events.txt")
        txt.unlink()


def jax_cli(name: str):
    sys.path.insert(0, str(REPO))
    import importlib
    return importlib.import_module(name)


def outputs(base: Path) -> dict:
    return {str(p.relative_to(base)): p for p in sorted(base.rglob("*")) if p.is_file()}


def assert_same_outputs(a: Path, b: Path) -> None:
    fa, fb = outputs(a), outputs(b)
    assert list(fa) == list(fb)
    assert any(k.endswith("all.csv") for k in fa) or any(k.endswith(".png") for k in fa)
    for rel in fa:
        if rel.endswith(".csv"):
            assert fa[rel].read_text() == fb[rel].read_text(), rel
            continue
        x = cv2.imread(str(fa[rel]), cv2.IMREAD_UNCHANGED)
        y = cv2.imread(str(fb[rel]), cv2.IMREAD_UNCHANGED)
        assert x.shape == y.shape and x.dtype == y.dtype, rel
        if "/flow/" in rel:
            d = np.abs(x.astype(int) - y.astype(int))
            assert d.max() <= 9 and (d.max(-1) == 0).mean() >= 0.90, (rel, d.max())
        else:
            np.testing.assert_array_equal(x, y, err_msg=rel)


@pytest.fixture(scope="module")
def ecd(work):
    """One ECD-layout sequence: PNG frames, timestamps and one headerless
    ``events.zip`` (ECD's events have no header line; the JAX reader
    refuses one)."""
    seq = work / "ecd" / "seq_0"
    sq = sim.simulate_sequence(21, 10, H, W)
    sim.write_eval_sequence(str(seq), sq)
    for f in seq.glob("*.npz"):
        f.unlink()
    write_stream(seq / "events.zip", sq["events"], header=False)
    return work / "ecd"


@pytest.mark.parametrize("mode", ["upsampled", pytest.param("real", marks=pytest.mark.slow)])
def test_wo_flow_ecd_zip_matches_jax(work, ecd, tmp_path, mode):
    """ECD normalisation, FWL, event previews and flow pictures; windows of
    about 2000 events in 'upsampled' mode (one voxel each) and in 'real'
    mode (round(n / 2000) voxels of a window)."""
    kw = dict(COMMON, model_mode="cista-eiflow", path_to_test_data=str(ecd),
              path_to_test_model=checkpoint(work, "cista-eiflow"), dataset="ECD",
              num_events=2000, test_data_mode=mode, is_write_event=True, is_write_flow=True)
    a, b = tmp_path / "jax", tmp_path / "port"
    jrows, jkeys = jax_cli("test_wo_flow").evaluate_sequences(JConfig(**kw, output_folder=str(a)))
    rows, keys, _ = test_wo_flow.evaluate_sequences(Config(**kw, output_folder=str(b)),
                                                    device="cpu")
    assert keys == jkeys == ["mse", "psnr", "ssim", "FWL"]
    assert [list(map(str, r)) for r in rows] == [list(map(str, r)) for r in jrows]
    assert rows[-1][-1] > 0
    assert_same_outputs(a, b)


def test_wo_flow_lpips_from_env_matches_jax(work, ecd, tmp_path, monkeypatch):
    """With ``CISTA_LPIPS`` naming a weights file (AlexNet LPIPS from a seed,
    in the JAX npz layout) both CLIs add an 'lpips' column, the same rows."""
    from cista_flow_torch.losses import lpips as TL
    weights = tmp_path / "alex.npz"
    TL.save_npz(TL.init(seed=3), str(weights))
    monkeypatch.setenv("CISTA_LPIPS", str(weights))
    kw = dict(COMMON, model_mode="cista-eiflow", path_to_test_data=str(ecd),
              path_to_test_model=checkpoint(work, "cista-eiflow"), dataset="ECD",
              num_events=2000, test_data_mode="upsampled", is_write_image=False)
    jrows, jkeys = jax_cli("test_wo_flow").evaluate_sequences(
        JConfig(**kw, output_folder=str(tmp_path / "jax")))
    rows, keys, _ = test_wo_flow.evaluate_sequences(
        Config(**kw, output_folder=str(tmp_path / "port")), device="cpu")
    assert keys == jkeys == ["mse", "psnr", "ssim", "lpips", "FWL"]
    assert [list(map(str, r)) for r in rows] == [list(map(str, r)) for r in jrows]
    assert rows[-1][keys.index("lpips") + 1] > 0


def test_with_flow_gt_flow_matches_jax(work, tmp_path):
    """``--is_gt_flow`` under cista-gtflow: the warps follow the GT flow,
    which is also the flow scored (EPE 0); two sequences, flow pictures."""
    data = work / "wf"
    for s in range(2):
        sim.write_eval_sequence(str(data / f"seq_{s}"), sim.simulate_sequence(11 + s, 8, H, W))
    kw = dict(COMMON, model_mode="cista-gtflow", path_to_test_data=str(data),
              path_to_test_model=checkpoint(work, "cista-gtflow"), test_data_mode="upsampled",
              is_gt_flow=True, is_write_flow=True)
    jrows, jkeys = jax_cli("test_with_flow").evaluate_sequences(
        JConfig(**kw, output_folder=str(tmp_path / "jax")))
    rows, keys, _ = test_with_flow.evaluate_sequences(
        Config(**kw, output_folder=str(tmp_path / "port")), device="cpu")
    assert keys == jkeys and [r[0] for r in rows] == ["seq_0", "seq_1", "mean"]
    assert [list(map(str, r)) for r in rows] == [list(map(str, r)) for r in jrows]
    assert rows[-1][keys.index("epe") + 1] == 0.0
    assert_same_outputs(tmp_path / "jax", tmp_path / "port")


@pytest.mark.slow
def test_noeval_txt_stream_matches_jax(work, tmp_path):
    """A ``.txt`` stream with its ``W H`` header under cista-idnet: windows
    of 800 events, chunks of 8, every 5th frame written with its event
    preview and flow picture."""
    path = work / "stream.txt"
    write_stream(path, sim.simulate_sequence(31, 8, H, W)["events"], header=True)
    kw = dict(COMMON, model_mode="cista-idnet", path_to_test_data=str(path),
              path_to_test_model=checkpoint(work, "cista-idnet"), num_events=800,
              test_img_num=11, is_write_event=True, is_write_flow=True)
    jax_cli("test_noeval").run(JConfig(**kw, output_folder=str(tmp_path / "jax")))
    test_noeval.run(Config(**kw, output_folder=str(tmp_path / "port")), device="cpu")
    # steps 0, 1, 5 and 10 write a frame, its event preview and its flow picture
    assert len(outputs(tmp_path / "port")) == 12
    assert_same_outputs(tmp_path / "jax", tmp_path / "port")


def test_noeval_samsung_rotation(tmp_path):
    """The samsung 180-degree rotation (as tests/test_cli_e2e.py:197-244 for
    the JAX CLI): the rotated stream under ``--dvs samsung`` gives the
    unrotated stream's frames, bit for bit, through the port's CLI."""
    rng = np.random.default_rng(6)
    n = 2400
    t = np.sort(rng.random(n))
    x, y, p = rng.integers(0, W, n), rng.integers(0, H, n), rng.integers(0, 2, n)

    def run(name, xs, ys, dvs):
        os.makedirs(tmp_path / name)
        path = tmp_path / name / "stream.txt"
        np.savetxt(path, np.stack([t, xs, ys, p], axis=1), fmt="%.6f %d %d %d")
        cfg = Config(**dict(COMMON, depth=2), model_mode="cista-idnet",
                     path_to_test_data=str(path), output_folder=str(tmp_path / f"out_{name}"),
                     num_events=800, test_img_num=2, dvs=dvs)
        test_noeval.run(cfg, device="cpu")
        return {k: cv2.imread(str(v), cv2.IMREAD_GRAYSCALE)
                for k, v in outputs(tmp_path / f"out_{name}").items()}

    a = run("plain", x, y, None)
    b = run("rot", W - 1 - x, H - 1 - y, "samsung")
    assert list(a) == list(b) and len(a) == 2          # steps 0 and 1 are written
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cli_mains_parse_the_reference_flags(tmp_path):
    """The three CLIs' ``main`` take the reference's flag names and short
    forms plus ``--device``, set the frame size from the data
    (test_noeval.py:103-108), and refuse the JAX package's TPU-only flags."""
    from cista_flow_torch import config
    import argparse
    ap = argparse.ArgumentParser()
    config.add_args(ap)
    args = ap.parse_args(["-b", "5", "-d", "2", "-c", "32", "-o", str(tmp_path), "--no_write_image",
                          "--model_mode", "cista-gtflow", "--is_gt_flow", "--k_shift", "100",
                          "--dvs", "samsung", "--load_epoch_for_test", "3", "--flow_half",
                          "--device", "cpu"])
    cfg = config.from_args(args)
    assert (cfg.num_bins, cfg.depth, cfg.base_channels, cfg.output_folder) == \
        (5, 2, 32, str(tmp_path))
    assert not cfg.is_write_image and cfg.is_gt_flow and cfg.flow_half and cfg.k_shift == 100
    assert args.device == "cpu" and not hasattr(cfg, "device")
    cfg.path_to_test_data = "/data/240fps/"
    cfg.dvs = None
    test_noeval.frame_size(cfg)
    assert cfg.image_dim == (180, 320)
    cfg.dvs = "samsung"
    test_noeval.frame_size(cfg)
    assert cfg.image_dim == (480, 640)
    for flag in config.TPU_ONLY_FLAGS:
        with pytest.raises(SystemExit):
            ap.parse_args([flag])
    assert ap.parse_args([]).model_mode == "cista-lstc"       # the reference's default


def test_harness_saves_and_holds_targets(work, ecd, tmp_path):
    """``python -m cista_flow_torch.evaluate --harness_mode wo_flow``, the
    twin of ``eval_harness.py``: ``--save_targets`` writes the mean row,
    the same run then passes against it (exit 0) and fails against a
    target moved by 1% at a 0.2% tolerance (exit 1)."""
    import json

    from cista_flow_torch import evaluate
    targets = tmp_path / "targets.json"
    flags = ["--model_mode", "cista-eiflow", "--image_dim", str(H), str(W), "-d", "1", "-c", "16",
             "--flow_iters", "1", "--path_to_test_data", str(ecd), "--path_to_test_model",
             checkpoint(work, "cista-eiflow"), "--dataset", "ECD", "--num_events", "2000",
             "--test_data_mode", "upsampled", "--device", "cpu", "-o", str(tmp_path / "out"),
             "--harness_mode", "wo_flow", "--targets", str(targets)]
    assert evaluate.main(flags + ["--save_targets"]) == 0
    saved = json.loads(targets.read_text())
    assert list(saved) == ["mse", "psnr", "ssim", "FWL"]
    assert evaluate.main(flags + ["--harness_tolerance", "0.002"]) == 0
    targets.write_text(json.dumps({**saved, "psnr": saved["psnr"] * 1.01}))
    assert evaluate.main(flags + ["--harness_tolerance", "0.002"]) == 1


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
