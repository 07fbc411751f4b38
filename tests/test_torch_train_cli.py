"""The port's trainer takes the JAX trainer's command line, its TensorBoard
writer, and ``CISTA_NO_NATIVE``, on the CPU.

- Every option string of the JAX trainer's parser
  (``cista_flow_tpu.configs.add_args``) parses in
  ``cista_flow_torch.train.parse_args``, but for the TPU-only routings
  (``config.TPU_ONLY_FLAGS`` and their ``--no-`` forms), which are refused
  with a message naming the flag; for each accepted flag, and for a set of
  whole command lines (no ``--model_mode``, ``--no_shuffle``,
  ``--flow_half``, ``--no-flow_half``, ``--is_SummaryWriter``, short
  forms), the port's ``Config`` equals, field by field,
  ``configs.from_args`` of the same argv after ``shuffle = True``, as the
  JAX trainer sets it (train.py:253-257).
- With no ``--model_mode`` the trainer trains ``cista-lstc``; with
  ``--is_SummaryWriter`` and a stand-in ``torch.utils.tensorboard`` it
  writes one ``add_scalar("loss", ...)`` per optimizer step into
  ``./summary/{model_name}``; without tensorboard it prints the JAX
  trainer's message and trains on; ``--flow_half`` reaches the composite,
  which refuses the flow-supervised phase as the JAX composite asserts.
- Under ``CISTA_NO_NATIVE=1`` (in a subprocess: both packages read it at
  import) the port's voxels and ``event_preprocess`` 'std' are bit for bit
  the JAX package's and the numpy versions', and the port's host library is
  not called.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from cista_flow_tpu import configs as JCFG
from cista_flow_torch import config, train
from cista_flow_torch.config import Config
from cista_flow_torch.data.sim import write_train_dataset

REPO = Path(__file__).resolve().parents[1]
H, W = 48, 64
# a value for each option that takes one (the rest take the type's example)
VALUES = {"--model_mode": ["cista-eraft"], "--dtype": ["bfloat16"], "--image_dim": ["96", "128"],
          "--mesh_shape": ["1"], "--mesh_axes": ["data"], "--warp_mode": ["backward"],
          "--encoder_merge": ["pair"], "--dvs": ["samsung"], "--time_unit": ["us"]}
EXAMPLE = {int: "3", float: "0.5", str: "x", None: "x"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    JCFG.add_args(ap)
    return ap


def jax_trainer_config(argv):
    """What the JAX trainer trains with for ``argv`` (train.py:253-257)."""
    cfgs = JCFG.from_args(jax_parser().parse_args(argv))
    cfgs.shuffle = True
    return cfgs


def same_fields(ours: Config, theirs) -> None:
    common = {f.name for f in dataclasses.fields(Config)} & \
        {f.name for f in dataclasses.fields(type(theirs))}
    assert len(common) >= 60
    diff = {k: (getattr(ours, k), getattr(theirs, k)) for k in sorted(common)
            if getattr(ours, k) != getattr(theirs, k)}
    assert not diff


def flag_argv(action, flag):
    if action.nargs == 0:
        return [flag]
    return [flag, *VALUES.get(flag, [EXAMPLE[action.type]])]


def test_every_jax_trainer_flag_parses_or_is_refused_by_name(tmp_path, capsys):
    data = ["--path_to_train_data", str(tmp_path)]
    refused = set(config.TPU_ONLY_FLAGS) | {"--no-" + f[2:] for f in config.TPU_ONLY_FLAGS
                                            if f != "--encoder_merge"}
    seen = 0
    flags = {f: a for f, a in jax_parser()._option_string_actions.items()
             if f not in ("-h", "--help")}
    for flag, action in flags.items():
        argv = flag_argv(action, flag)
        if flag in refused:
            with pytest.raises(SystemExit):
                train.parse_args(data + argv)
            assert f"{flag}: a TPU-only" in capsys.readouterr().err, flag
            continue
        cfgs, device = train.parse_args(data + argv)
        assert device == "cuda"
        same_fields(cfgs, jax_trainer_config(data + argv))
        seen += 1
    assert len(refused) == 9 and seen == len(flags) - 9 >= 70


@pytest.mark.parametrize("argv", [
    [],
    ["--no_shuffle"],
    ["--flow_half", "--model_mode", "cista-eiflow"],
    ["--no-flow_half"],
    ["--is_SummaryWriter", "--model_name", "run", "-s", "4", "-d", "3", "-c", "32", "-b", "5"],
    ["--model_mode", "cista-idnet", "--image_dim", "96", "128", "--flow_iters", "2", "--lr",
     "3e-4", "--epochs", "7", "--flow_epoch", "2", "--rec_epoch", "3", "--batch_size", "4",
     "--load_lr", "2e-5", "--train_all", "--no_warp", "--is_bi", "--is_reverse_events",
     "--reader_type", "zip", "--dataset", "ECD", "--num_events", "30000", "--seed", "5",
     "--dtype", "bfloat16", "--remat", "--save_every_steps", "3", "--orbax_ckpt"],
])
def test_config_equals_the_jax_trainers(tmp_path, argv):
    argv = ["--path_to_train_data", str(tmp_path), *argv]
    cfgs, _ = train.parse_args(argv)
    same_fields(cfgs, jax_trainer_config(argv))
    assert cfgs.shuffle


def test_defaults_are_the_jax_packages():
    assert Config().model_mode == JCFG.Config().model_mode == "cista-lstc"
    same_fields(Config(), JCFG.Config())


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    path = tmp_path_factory.mktemp("train")
    write_train_dataset(str(path), 2, 4, H, W, seed=1)
    return str(path)


def trainer_argv(data, out, *extra):
    return ["--device", "cpu", "--path_to_train_data", data, "--path_to_model", str(out),
            "--image_dim", str(H), str(W), "-c", "16", "-d", "1", "-s", "3", "--batch_size", "2",
            *extra]


class FakeWriter:
    made = []

    def __init__(self, logdir):
        self.logdir, self.scalars, self.closed = logdir, [], 0
        FakeWriter.made.append(self)

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, value, step))

    def close(self):
        self.closed += 1


def test_no_model_mode_trains_cista_lstc_and_logs_every_step(tiny_set, tmp_path, monkeypatch,
                                                             capsys):
    """``train`` with no ``--model_mode``, ``--no_shuffle`` and
    ``--is_SummaryWriter`` (a stand-in ``torch.utils.tensorboard``): the
    ``cista-lstc`` checkpoints; one ``add_scalar("loss", loss, step)`` per
    optimizer step, steps 0, 1, ... over both epochs, each value the loss
    the step printed where it printed one; the writer opened on
    ``./summary/{model_name}`` and closed once."""
    FakeWriter.made.clear()
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=FakeWriter))
    monkeypatch.chdir(tmp_path)
    assert train.main(trainer_argv(tiny_set, tmp_path / "models", "--no_shuffle",
                                   "--is_SummaryWriter", "--epochs", "2")) == 0
    out = capsys.readouterr().out
    name = "cista-lstc_b5_d1_c16"
    assert sorted(os.listdir(tmp_path / "models" / name)) == [f"{name}_1.pth.tar"]
    (writer,) = FakeWriter.made
    assert writer.logdir == f"./summary/{name}" and writer.closed == 1
    steps = len(writer.scalars)
    assert steps >= 2 and steps % 2 == 0          # the same batches in each epoch
    assert [s for _, _, s in writer.scalars] == list(range(steps))
    assert {t for t, _, _ in writer.scalars} == {"loss"}
    assert all(isinstance(v, float) and np.isfinite(v) for _, v, _ in writer.scalars)
    printed = [float(line.rsplit("loss: ", 1)[1]) for line in out.splitlines()
               if line.startswith("Train Epoch:")]
    assert printed == [pytest.approx(writer.scalars[0][1], abs=1e-6),
                       pytest.approx(writer.scalars[steps // 2][1], abs=1e-6)]


def test_without_tensorboard_it_says_so_and_trains_on(tiny_set, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)   # import raises
    monkeypatch.chdir(tmp_path)
    assert train.main(trainer_argv(tiny_set, tmp_path / "models", "--is_SummaryWriter")) == 0
    out = capsys.readouterr().out
    assert "tensorboard unavailable; scalar logging disabled" in out
    assert out.count("Train Epoch:") == 1 and not (tmp_path / "summary").exists()


def test_flow_half_reaches_the_composite(tiny_set, tmp_path):
    """``--flow_half`` on cista-eiflow's first epoch (phase 1, a
    flow-supervised graph): the composite refuses, as the JAX composite
    asserts (composite.py:147-157 there)."""
    cfgs, device = train.parse_args(trainer_argv(tiny_set, tmp_path, "--model_mode",
                                                 "cista-eiflow", "--flow_half",
                                                 "--flow_iters", "1"))
    assert cfgs.flow_half
    trainer = train.Trainer(cfgs, device)
    assert trainer.model.cfg.flow_half
    with pytest.raises(ValueError, match="flow_half serves and runs rec-phase graphs only"):
        trainer.run()


NO_NATIVE = r"""
import json, sys
import numpy as np
from cista_flow_tpu.events import voxel as JV
from cista_flow_torch.events import native, voxel as TV

def refuse(*a, **k):
    raise AssertionError("the host library ran under CISTA_NO_NATIVE=1")
native.voxelize_events = native.preprocess_std = refuse
rng = np.random.default_rng(0)
out = {}
for n, (w, h) in ((15000, (240, 180)), (20000, (346, 260)), (0, (64, 48))):
    ev = np.stack([np.sort(rng.random(n)), rng.integers(0, w, n).astype(np.float64),
                   rng.integers(0, h, n).astype(np.float64),
                   rng.integers(0, 2, n).astype(np.float64)], axis=1)
    for rev in (False, True):
        ours = TV.events_to_voxel_grid(ev, 5, w, h, rev)
        theirs = JV.events_to_voxel_grid(ev, 5, w, h, rev)
        golden = TV.events_to_voxel_grid_numpy(ev, 5, w, h, rev)
        for hot in (False, True):
            a = TV.event_preprocess(ours.copy(), "std", hot)
            b = JV.event_preprocess(theirs.copy(), "std", hot)
            c = TV.event_preprocess_numpy(golden.copy(), "std", hot)
            out[f"{n}-{rev}-{hot}"] = [bool(np.array_equal(ours, theirs)),
                                       bool(np.array_equal(ours, golden)),
                                       bool(np.array_equal(a, b)), bool(np.array_equal(a, c)),
                                       int(np.count_nonzero(ours))]
print(json.dumps({"flags": [TV._USE_NATIVE, JV._USE_NATIVE], "cases": out}))
"""


def test_no_native_selects_numpy_voxels_in_both_packages():
    env = dict(os.environ, CISTA_NO_NATIVE="1", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    run = subprocess.run([sys.executable, "-c", NO_NATIVE], cwd=REPO, env=env, text=True,
                         capture_output=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["flags"] == [False, False]
    assert len(got["cases"]) == 12
    for case, (vox_jax, vox_numpy, std_jax, std_numpy, nonzero) in got["cases"].items():
        assert vox_jax and vox_numpy and std_jax and std_numpy, case
        assert nonzero > 0 or case.startswith("0-"), case
