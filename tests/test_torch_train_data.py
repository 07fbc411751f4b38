"""The port's training data against the JAX package's: the simulator's
training layout (``write_train_dataset``) and the loader over it
(``TrainSequenceDataset``, ``StackedSequenceLoader``), bit for bit up to the
layout (the port is NCHW and writes PNGs with its own codec, the JAX
package NHWC through OpenCV).

Both loaders voxelize on their default path, each package's host event
library built from the same source, so the voxels must be equal bit for
bit.
"""
import os

import numpy as np
import pytest

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.data import sim as JSIM
from cista_flow_tpu.data import train_loader as JTL
from cista_flow_torch.config import Config
from cista_flow_torch.data import sim as TSIM
from cista_flow_torch.data import train_loader as TTL
from cista_flow_torch.data.png import read_png
from test_torch_surface import jax_native_library

H, W = 36, 48
VIDEOS, FRAMES = 2, 6


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    j = JSIM.write_train_dataset(str(root / "jax"), VIDEOS, FRAMES, H, W, seed=3,
                                 speed_range=(20.0, 80.0))
    t = TSIM.write_train_dataset(str(root / "torch"), VIDEOS, FRAMES, H, W, seed=3,
                                 speed_range=(20.0, 80.0))
    return j, t


def test_write_train_dataset_matches_jax(datasets):
    jidx, tidx = datasets
    with open(jidx) as f, open(tidx) as g:
        lines = f.read()
        assert lines == g.read()
    assert len(lines.splitlines()) == VIDEOS * (FRAMES - 1)
    jroot, troot = os.path.dirname(jidx), os.path.dirname(tidx)
    import cv2
    for vid in range(VIDEOS):
        names = sorted(os.listdir(os.path.join(jroot, f"v{vid:03d}")))
        assert names == sorted(os.listdir(os.path.join(troot, f"v{vid:03d}")))
        for name in names:
            jp, tp = (os.path.join(r, f"v{vid:03d}", name) for r in (jroot, troot))
            if name.endswith(".png"):
                np.testing.assert_array_equal(read_png(tp), cv2.imread(jp, cv2.IMREAD_GRAYSCALE))
                np.testing.assert_array_equal(read_png(tp), read_png(jp))
            else:
                with np.load(jp) as a, np.load(tp) as b:
                    assert a.files == b.files
                    for k in a.files:
                        np.testing.assert_array_equal(a[k], b[k])


def _cfgs(root, **kw):
    kw = {"image_dim": (H, W), "path_to_train_data": root, "model_mode": "cista-eiflow",
          **kw}
    return JConfig(**kw), Config(**kw)


def _nchw(a):
    """JAX's (H, W, C) step arrays (and (T, B, H, W, C) batches) to NCHW."""
    return np.moveaxis(a, -1, -3)


CASES = {"by_video": dict(len_sequence=3),
         "by_event_count": dict(len_sequence=0, num_events=2500),
         "bi_reversed": dict(len_sequence=2, is_bi=True, is_reverse_events=True),
         "forward_flow_backward_warp": dict(len_sequence=3, is_forward_flow=True,
                                            warp_mode="backward"),
         "eraft_voxel_old": dict(len_sequence=3, model_mode="cista-eraft")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_jax(datasets, case):
    idx = datasets[0]
    jcfg, tcfg = _cfgs(os.path.dirname(idx), **CASES[case])
    jds, tds = JTL.TrainSequenceDataset(idx, jcfg), TTL.TrainSequenceDataset(idx, tcfg)
    assert tds.sequence_line_id == jds.sequence_line_id
    assert len(tds) == len(jds) > 0
    if case == "by_event_count":
        assert any(len(group) > 1 for seq in tds.sequence_line_id for group in seq)
    for i in range(len(jds)):
        jitem, titem = jds[i], tds[i]
        assert len(jitem) == len(titem)
        for (jd, jt), (td, tt) in zip(jitem, titem):
            assert sorted(jd) == sorted(td) and sorted(jt) == sorted(tt)
            for k in jd:
                np.testing.assert_array_equal(td[k], jd[k])
            for k in jt:
                np.testing.assert_array_equal(tt[k], jt[k] if jt[k].ndim == 3 else jt[k][None])

    t_len = max(tcfg.len_sequence, 1)
    jl = JTL.StackedSequenceLoader(jds, 2, t_len, shuffle=True, seed=5, num_workers=2)
    tl = TTL.StackedSequenceLoader(tds, 2, t_len, shuffle=True, seed=5, num_workers=2)
    assert len(tl) == len(jl)
    jb, tb = list(jl), list(tl)
    assert len(tb) == len(jb) > 0
    for j, t in zip(jb, tb):
        assert sorted(j) == sorted(t)
        for k in j:
            assert t[k].shape[:2] == (t_len, 2)
            np.testing.assert_array_equal(t[k], _nchw(j[k]))


def test_eraft_training_data_is_refused(datasets):
    """Once refused, cista-eraft's training data now loads: each step's
    ``event_voxel_old`` is zeros at a video's first frame (the first line,
    or an events file whose frame index is 0) and the previous line's
    window voxelized elsewhere, bit for bit the JAX loader's
    (cista_flow_tpu/data/train_loader.py:148-157)."""
    idx = datasets[1]
    jcfg, tcfg = _cfgs(os.path.dirname(idx), len_sequence=3, model_mode="cista-eraft")
    jds, tds = JTL.TrainSequenceDataset(idx, jcfg), TTL.TrainSequenceDataset(idx, tcfg)
    firsts = 0
    for line in range(len(tds.event_paths)):
        (td, _), (jd, _) = tds.get_step(line), jds.get_step(line)
        np.testing.assert_array_equal(td["event_voxel_old"], jd["event_voxel_old"])
        if tds.event_paths[line].endswith("_000000.npz"):
            firsts += 1
            assert not td["event_voxel_old"].any()
        else:
            np.testing.assert_array_equal(td["event_voxel_old"],
                                          tds.get_step(line - 1)[0]["event_voxel"])
            assert td["event_voxel_old"].any()
    assert firsts == VIDEOS


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
