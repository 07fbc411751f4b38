"""``correct`` against a broken timed path and against the control, at a
size the CPU holds: the cell's own limits, its check, its traffic cut to
48 x 64 (two streams).

Each fault is planted under the harness's call into the program; the
run must then read ``correct`` false. The exchange between chips is no
fault these one-chip cells can have."""
import numpy as np
import pytest

import check
import harness
import reference
import traffic
from conftest import tiny_cell
from reference.ops import fp8_rounding

CELLS = ["eiflow-live-vga-b8", "eraft-replay-b8w16", "eraft-live-vga-b8"]
SEED = 2 ** 32 + 77


def frozen_state(call, recon):
    """Every step returns the recurrent state it was given."""
    def broken(voxels):
        state = recon.state
        out = call(voxels)
        recon.state = state
        return out
    return broken


def half_the_batch(call, recon):
    """Half of the streams left out, the mean of the rest in their place."""
    def broken(voxels):
        frames, flows = (np.array(x) for x in call(voxels))
        h = frames.shape[1] // 2
        frames[:, h:] = frames[:, :h].mean(axis=1, keepdims=True)
        flows[:, h:] = flows[:, :h].mean(axis=1, keepdims=True)
        return frames, flows
    return broken


def altered_answer(call, recon):
    """One stream's frame of every call moved by one pixel where it is made."""
    calls = [0]

    def broken(voxels):
        frames, flows = call(voxels)
        frames = np.array(frames)
        s = calls[0] % frames.shape[1]
        calls[0] += 1
        frames[:, s] = np.roll(frames[:, s], 1, axis=-1)
        return frames, flows
    return broken


def _run(cell, program=None):
    result, *_ = harness.measure(cell, SEED, 1.5, False, device="cpu", cell=tiny_cell(cell),
                                 program=program)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("fault", [frozen_state, half_the_batch, altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_is_not_correct(cell, fault):
    result = _run(cell, fault)
    assert result["attempted"] > 0 and not result["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_fp8_control_is_not_correct(cell):
    c, cfg, mix = tiny_cell(cell)
    pool = traffic.make_pool(SEED, mix, "cpu")
    params = reference.load_params(str(harness.ROOT / cfg["weights"]), "cpu")
    worst = check.compare(None, pool, SEED, cfg, mix, c["check"], params, "cpu",
                          rounding=fp8_rounding, calls=len(pool))
    limits = {k: v for k, v in c["check"]["limits"].items() if v is not None}
    assert any(worst.value[k] > limit for k, limit in limits.items())
