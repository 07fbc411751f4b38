"""The last line a run prints, and the runs it refuses."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

import harness
from conftest import tiny_cell

SPEC = harness.read_json(harness.ROOT / "BENCHMARK.json")


def _names(kind, cell):
    return {m["name"] for m in SPEC[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line(cell, trace):
    # long enough on the CPU for the traced slice (four calls skipped, two traced)
    result, lines, run, _ = harness.measure(cell, 2 ** 33 + 1, 4.0 if trace else 0.8, trace,
                                            device="cpu", cell=tiny_cell(cell))
    assert list(result)[-1] == "checks"
    line = json.loads(json.dumps(result))
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["attempted"] == run.calls > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        # on the CPU only the host's metric has something to read
        assert set(line["metrics"]) <= _names("per_layer", cell)
    else:
        assert set(line["metrics"]) == _names("end_to_end", cell)
    limits = {k for k, v in harness.load_cell(cell)[0]["check"]["limits"].items() if v is not None}
    assert set(line["checks"]) == limits
    assert {ln.split()[1] for ln in lines if ln.startswith("check ")} == limits


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "eiflow-live-vga-b8", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _run(harness.ROOT)
    assert out.returncode != 0 and "{" not in out.stdout


def test_refuses_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
