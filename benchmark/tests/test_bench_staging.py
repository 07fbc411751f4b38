"""``pinned_copy_pct``: the share of the runner's host bytes that went
through page-locked memory, from the program's counters, by hand; nothing
from a program without the counter (a version before it, or a run off the
card, where the program stages nothing) or from a run with no traced
slice."""
import sys
import types

import pytest

from harness import BENCH, Run
from tracing import load_files

METRICS = load_files(BENCH / "metrics")
PROFILING = "cista_flow_torch.utils.profiling"


def _program(monkeypatch, counters):
    """The program's profiling module as the reader finds it loaded."""
    mod = types.ModuleType(PROFILING)
    if counters is not None:
        mod.counters = lambda: dict(counters)
    monkeypatch.setitem(sys.modules, PROFILING, mod)


def _traced_run():
    run = Run()
    run.trace, run.traced_steps = object(), 2
    return run


@pytest.mark.parametrize("staged,want", [(9000, 100.0), (4500, 50.0), (0, 0.0)])
def test_pinned_copy_pct_by_hand(monkeypatch, staged, want):
    _program(monkeypatch, {"runner.bytes_up": 6000, "runner.bytes_down": 3000,
                           "runner.bytes_staged": staged})
    assert METRICS["pinned_copy_pct"].read(_traced_run()) == pytest.approx(want)


@pytest.mark.parametrize("counters", [None, {}, {"runner.bytes_up": 6000},
                                      {"runner.bytes_staged": 0}])
def test_pinned_copy_pct_reads_nothing_without_the_counter(monkeypatch, counters):
    """A program before the counter, one that counted no staged bytes (off
    the card) or no bytes at all reads nothing; so does a run with no
    traced slice."""
    _program(monkeypatch, counters)
    assert METRICS["pinned_copy_pct"].read(_traced_run()) is None
    _program(monkeypatch, {"runner.bytes_up": 6000, "runner.bytes_staged": 6000})
    assert METRICS["pinned_copy_pct"].read(Run()) is None

