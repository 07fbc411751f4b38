"""The generator against the program's simulator and voxels (numpy), and
the pool the window walks."""
import numpy as np
import pytest

import traffic
from cista_flow_torch.data import sim
from cista_flow_torch.events import voxel

MIX = {"height": 36, "width": 48, "frames": 4, "fps": 25.0, "speed": 60.0, "omega": 0.25,
       "substeps": 10, "c_pos": 0.18, "c_neg": 0.18, "log_eps": 0.01, "bins": 5}


def test_voxels_match_the_program_simulator():
    got = traffic.streams_voxels([7], MIX, "cpu")[0].numpy()
    seq = sim.simulate_sequence(7, MIX["frames"], MIX["height"], MIX["width"],
                                fps=MIX["fps"], substeps=MIX["substeps"], speed=MIX["speed"],
                                omega=MIX["omega"])
    for i, (t, x, y, p) in enumerate(seq["events"]):
        ev = np.stack([t, x, y, p], 1)
        v = voxel.events_to_voxel_grid_numpy(ev, 5, MIX["width"], MIX["height"])
        want = voxel.event_preprocess_numpy(v, "std")
        assert len(t) > 100
        # the program sums each event into an f32 grid, the generator in f64
        np.testing.assert_allclose(got[i], want, atol=2e-5)


def test_the_same_seed_gives_the_same_pool_and_another_seed_another():
    mix = dict(MIX, streams=2, steps_per_call=1)
    a = traffic.make_pool(2 ** 31 + 11, mix, "cpu")
    b = traffic.make_pool(2 ** 31 + 11, mix, "cpu")
    c = traffic.make_pool(2 ** 31 + 12, mix, "cpu")
    assert len(a) == 2 * (MIX["frames"] - 1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    assert not np.array_equal(a[0][0], a[0][1])          # each stream its own scene


def test_the_pool_plays_forward_then_back():
    mix = dict(MIX, streams=1, steps_per_call=1)
    pool = traffic.make_pool(3, mix, "cpu")
    n = MIX["frames"] - 1
    for i in range(n):
        np.testing.assert_array_equal(pool[2 * n - 1 - i], -pool[i][:, ::-1])


def test_a_window_pool_holds_whole_calls():
    mix = dict(MIX, streams=2, steps_per_call=3)
    pool = traffic.make_pool(3, mix, "cpu")
    assert [p.shape for p in pool] == [(3, 2, 5, 36, 48)] * 2
    with pytest.raises(ValueError):
        traffic.make_pool(3, dict(mix, steps_per_call=4), "cpu")


def test_seeds_past_32_bits():
    assert traffic.stream_seed(2 ** 40 + 5, 1) != traffic.stream_seed(2 ** 40 + 5, 2)
