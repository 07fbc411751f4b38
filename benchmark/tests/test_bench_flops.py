"""The model operations that ``mfu_pct`` divides by."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import harness
import reference
from reference import nets
from reference.ops import Ops


def _cfg(name):
    return harness.read_json(harness.BENCH / "configs" / f"{name}.json")


def _params(cfg):
    return reference.load_params(str(harness.ROOT / cfg["weights"]), "cpu")


def test_meta_count_equals_a_count_on_real_tensors():
    cfg = _cfg("cista-eiflow-6x5")
    params = _params(cfg)
    mix = {"height": 64, "width": 64, "streams": 2, "steps_per_call": 1}
    meta = reference.flops_per_frame(params, cfg, mix)
    streams = reference.make_streams(params, cfg, 2, (64, 64), "cpu")
    with FlopCounterMode(display=False) as counter:
        streams.steps(torch.zeros((1, 2, 5, 64, 64)))
    assert meta == counter.get_total_flops() / 2


def test_cista_lstc_count_is_the_sum_of_its_convs():
    cfg = _cfg("cista-eiflow-6x5")
    params = _params(cfg)
    b, h, w, c, depth = 1, 32, 48, 64, 5
    h2, w2 = h // 2, w // 2
    ops = Ops(params)
    state = nets.zero_state(b, (h, w), "cpu")
    with FlopCounterMode(display=False) as counter:
        nets.cista_lstc(ops, torch.zeros(b, 5, h, w), torch.zeros(b, 1, h, w), state, depth)

    def conv(cin, cout, hh, ww):
        return 2 * 9 * cin * cout * hh * ww * b
    # W0 has stride 2: its outputs are at half size
    full = conv(5, c // 2, h, w) + conv(1, c // 2, h, w) + conv(c, c, h2, w2)
    half = (conv(3 * c, 4 * c, h2, w2) + conv(c, 2 * c, h2, w2) + conv(4 * c, 2 * c, h2, w2)
            + depth * (conv(2 * c, c, h2, w2) + conv(c, 2 * c, h2, w2))
            + conv(2 * c, c, h2, w2) + conv(2 * c, 4 * c, h2, w2))
    out = conv(c, c, h, w) + conv(c, 1, h, w)
    assert counter.get_total_flops() == full + half + out


@pytest.mark.parametrize("config", ["cista-eiflow-6x5", "cista-eraft-12x5"])
def test_count_grows_with_the_frame(config):
    cfg = _cfg(config)
    params = _params(cfg)
    small = reference.flops_per_frame(params, cfg, {"height": 64, "width": 64, "streams": 1,
                                                    "steps_per_call": 1})
    large = reference.flops_per_frame(params, cfg, {"height": 128, "width": 128, "streams": 1,
                                                    "steps_per_call": 1})
    # everything but the correlation (quadratic in the pixels) scales with them
    assert 4.0 <= large / small < 4.4


def test_the_eraft_window_shares_its_feature_maps():
    cfg = _cfg("cista-eraft-12x5")
    params = _params(cfg)
    mix = {"height": 64, "width": 64, "streams": 2, "steps_per_call": 1}
    step = reference.flops_per_frame(params, cfg, mix)
    window = reference.flops_per_frame(params, cfg, dict(mix, steps_per_call=8))
    assert window < step
