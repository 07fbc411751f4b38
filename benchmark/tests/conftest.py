"""Paths and a cell cut to a size the CPU runs in seconds, for the
benchmark's own tests (``python -m pytest benchmark/tests``)."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str, height=48, width=64, streams=2, frames=5, steps=None, limits=None):
    """A cell's files with its traffic shrunk: the same configuration,
    metrics and check, a frame of ``height`` x ``width``."""
    import harness
    cell, cfg, mix = harness.load_cell(name)
    mix = dict(mix, height=height, width=width, streams=streams, frames=frames)
    if mix["steps_per_call"] > 1:
        mix["steps_per_call"] = steps or 2 * (frames - 1) // 2
    check = dict(cell["check"], limits=limits or cell["check"]["limits"])
    cell = dict(cell, trace={"calls": 2}, check=check)
    return cell, cfg, mix
