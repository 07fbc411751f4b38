"""The kernels' work counters against chip_smoke.py's bounds (PERF.md's
kernel table, bf16, batch 8): each input read and each output written
once, the operations at the dtype's peak."""
import pytest
import torch

import peaks
from tracing import load_files
from harness import BENCH

KERNELS = load_files(BENCH / "kernels")
BF16 = torch.bfloat16


def meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def bound_ms(key, *args):
    nbytes, ops, dtype = KERNELS[key].work(*args)
    return peaks.least_seconds(nbytes, ops, dtype) * 1e3


def ista_weights(c):
    return (meta(c, 2 * c, 3, 3), meta(c), meta(2 * c, c, 3, 3), meta(2 * c), meta(2 * c))


CASES = [
    # (kernel, arguments, chip_smoke.py's bound in ms)
    ("K2", (meta(8, 128, 90, 120), meta(8, 2, 90, 120, dtype=torch.float32), -1.0), 0.0134),
    ("K2", (meta(8, 1, 180, 240), meta(8, 2, 180, 240, dtype=torch.float32), -1.0), 0.0012),
    ("K3", (ista_weights(64), meta(64, 128, 3, 3), meta(64), meta(8, 64, 90, 120),
            meta(8, 128, 90, 120), 5), 0.1417),
    ("K4", (meta(8, 64, 96, 128),), 0.0075),
    ("K4", (meta(8, 96, 48, 64),), 0.0028),
    ("K4", (meta(8, 128, 24, 32),), 0.0009),
    ("K5", (meta(8, 64, 96, 128), meta(64, 64, 3, 3), meta(64)), 0.0075),
    ("K5", (meta(8, 128, 24, 32), meta(128, 128, 3, 3), meta(128)), 0.0018),
    ("K5", (meta(8, 64, 180, 240), meta(64, 64, 3, 3), meta(64), "reflect"), 0.0264),
]


@pytest.mark.parametrize("key,args,expected", CASES, ids=[f"{c[0]}-{i}" for i, c in
                                                          enumerate(CASES)])
def test_bound_matches_chip_smoke(key, args, expected):
    assert bound_ms(key, *args) == pytest.approx(expected, abs=1e-4)


def test_k1_counts_whole_windows():
    """K1 reads the 10 x 10 block of each window at every level, clipped to
    the level: no fewer bytes than chip_smoke.py counted for the pyramid
    entries its test coordinates touched (0.0017 ms at n = 6144)."""
    from collections import namedtuple
    pyr = namedtuple("Pyr", "levels")([meta(6144, 24 >> i, 32 >> i) for i in range(4)])
    coords = meta(8, 2, 24, 32, dtype=torch.float32)
    ms = bound_ms("K1", pyr, coords, meta(256, 324, 1, 1), meta(256, dtype=torch.float32))
    assert 0.0017 <= ms < 0.0017 * 1.2


def test_every_counter_names_a_function_of_the_program():
    import importlib
    for key, mod in KERNELS.items():
        for module_name, attr in mod.TARGETS:
            assert callable(getattr(importlib.import_module(module_name), attr)), (key, attr)
