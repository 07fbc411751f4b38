"""Host-clock split of the eval CLIs' loops.

Each CLI times the items of its loop (parse, voxelize, device, metrics,
writers) with one ``HostSplit``; ``chip_smoke.py`` prints them per window.
The device item is host time too: the call returns once the outputs are on
the host, so it includes the wait for the card.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class HostSplit:
    """Seconds per item, summed over a run, and the windows counted."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.windows = 0

    @contextlib.contextmanager
    def __call__(self, item: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[item] += time.perf_counter() - t0

    @contextlib.contextmanager
    def reading(self, reader):
        """A call of an ``ImageReader``: its ``_voxelize`` time goes to
        'voxelize', the rest (files, PNG, event text) to 'parse'."""
        t0, v0 = time.perf_counter(), reader.voxelize_seconds
        try:
            yield
        finally:
            dv = reader.voxelize_seconds - v0
            self.seconds["voxelize"] += dv
            self.seconds["parse"] += time.perf_counter() - t0 - dv

    def per_window_ms(self) -> dict:
        return {k: 1e3 * v / max(self.windows, 1) for k, v in self.seconds.items()}
