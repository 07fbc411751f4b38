"""What the benchmark loads, by whole top-level module name: never JAX or
the JAX package; the reference nothing of the program either."""
import json
import os
import subprocess
import sys

from harness import BENCH, FORBIDDEN, PROGRAM, ROOT

PRELUDE = f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
TOPS = "print(__import__('json').dumps(sorted({n.split('.')[0] for n in sys.modules})))"


def _tops(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code + "\n" + TOPS],
                         capture_output=True, text=True, check=True, cwd=ROOT,
                         env={**os.environ, "USE_FLAX": "0"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_the_program():
    tops = _tops("import reference, reference.nets, reference.ops")
    assert not tops & set(FORBIDDEN) and PROGRAM not in tops


def test_harness_and_a_run_load_no_jax():
    code = """
import harness, check, calibrate, tracing, traffic, reference
from tracing import load_files
load_files(harness.BENCH / 'metrics'); load_files(harness.BENCH / 'kernels')
sys.path.insert(0, str(harness.BENCH / 'tests'))
from conftest import tiny_cell
harness.measure('eiflow-live-vga-b8', 5, 0.5, True, device='cpu',
                cell=tiny_cell('eiflow-live-vga-b8', 48, 64))
assert not harness.forbidden_modules()
"""
    tops = _tops(code)
    assert PROGRAM in tops
    assert not tops & set(FORBIDDEN)
