"""The quality gate replayed through the PyTorch port on the CPU in f32.

``python -m cista_flow_torch.evaluate`` runs each row of
``tests/test_quality_gate.py`` (the same anchors, targets and flags) on the
held-out simulated sequences that the port's own ``ensure_eval_data``
writes (seed 0, 180x240, 30 frames, 2 sequences), and holds the rounded
mean row to the committed ``gate/targets_*.json`` at 0.2%, the JAX gate's
tolerance. The admitted serving points of cista-eiflow and cista-idnet run
in the fast tier; the other four rows are marked slow.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from cista_flow_torch.data.sim import ensure_eval_data

REPO = Path(__file__).resolve().parent.parent
GATE = REPO / "gate"

# row -> (model_mode, anchor stem, targets name, extra flags), as the JAX gate
ROWS = {
    "serve-eiflow-d1i1": ("cista-eiflow", "flagship_ft1_f16", "targets_sim_flagship_ft1.json",
                          ("--depth", "1", "--flow_iters", "1")),
    "serve-idnet-d2": ("cista-idnet", "idnet_ft2_f16", "targets_sim_idnet_ft2.json",
                       ("--depth", "2")),
    "cista-eiflow": ("cista-eiflow", "flagship_sim40_f16", "targets_sim_eiflow.json", ()),
    "cista-eraft": ("cista-eraft", "eraft_sim40_f16", "targets_sim_eraft.json", ()),
    "cista-idnet": ("cista-idnet", "idnet_sim40_f16", "targets_sim_idnet.json", ()),
    "serve-eraft-d1i1": ("cista-eraft", "eraft_ft1_f16", "targets_sim_eraft_ft1.json",
                         ("--depth", "1", "--flow_iters", "1")),
}
FAST = ("serve-eiflow-d1i1", "serve-idnet-d2")


@pytest.fixture(scope="module")
def eval_dir(tmp_path_factory):
    return ensure_eval_data(str(tmp_path_factory.mktemp("gate")), 180, 240,
                            eval_frames=30, seed=0)


@pytest.mark.parametrize("row", [r if r in FAST else pytest.param(r, marks=pytest.mark.slow)
                                 for r in ROWS])
def test_gate_row_through_the_port(row, eval_dir, tmp_path):
    mode, stem, targets, extra = ROWS[row]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "cista_flow_torch.evaluate", "--model_mode", mode,
         "--image_dim", "180", "240", "--path_to_test_data", eval_dir,
         "--test_data_mode", "upsampled", "--path_to_test_model", str(GATE / f"{stem}.npz"),
         "--dtype", "float32", "--device", "cpu", "--output_folder", str(tmp_path / "out"),
         "--targets", str(GATE / targets), "--harness_tolerance", "0.002", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"{row} drifted beyond 0.2%:\n{r.stdout[-3000:]}{r.stderr[-3000:]}"
    assert "PASS" in r.stdout.splitlines()[-1]
    # the CSVs: one result.csv per sequence, all.csv with the mean row
    with open(GATE / targets) as f:
        keys = list(json.load(f))
    lines = (tmp_path / "out" / stem / "all.csv").read_text().splitlines()
    assert lines[0].split("\t") == ["Dataset"] + keys + ["N_frames"]
    assert [ln.split("\t")[0] for ln in lines[1:]] == ["sim_00", "sim_01", "mean"]
    assert lines[-1].split("\t")[-1] == "52"          # 2 x (29 packs - 3 skipped)
    for seq in ("sim_00", "sim_01"):
        assert (tmp_path / "out" / stem / seq / "result.csv").exists()
