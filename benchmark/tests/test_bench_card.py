"""On the card, at each cell's own size: a short run is correct, and the
fp8 control is not (``calibrate.py`` reads both). Skips without a card;
run on the card with ``python -m pytest benchmark/tests -m cuda``."""
import json
import subprocess
import sys

import pytest
import torch

import harness

CELLS = [w["name"] for w in harness.read_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"], out.stderr[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limits(card, cell):
    out = subprocess.run([sys.executable, "benchmark/calibrate.py", "--workload", cell,
                          "--calls", "40", "--seeds", "5", "--control-seeds", "5"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    limits = {k: v for k, v in harness.load_cell(cell)[0]["check"]["limits"].items()
              if v is not None}
    for row in rows:
        over = any(row[k] > limit for k, limit in limits.items())
        assert over == (row["side"] == "control_fp8"), row
