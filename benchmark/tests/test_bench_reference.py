"""The plain reference against the program on the CPU: f32, 64x96, one
stream, 3 steps, with the published weights."""
import numpy as np
import pytest
import torch

import harness
import reference

CASES = [("cista-eiflow-6x5", 1), ("cista-eraft-12x5", 1), ("cista-eraft-12x5", 3)]


@pytest.mark.parametrize("config,steps_per_call", CASES,
                         ids=["eiflow-step", "eraft-step", "eraft-window"])
def test_reference_matches_the_program(config, steps_per_call):
    cfg = dict(harness.read_json(harness.BENCH / "configs" / f"{config}.json"), dtype="float32")
    mix = {"height": 64, "width": 96, "streams": 1, "steps_per_call": steps_per_call}
    recon = harness.build_program(cfg, mix, "cpu")
    call = harness.port_call(recon, "step" if steps_per_call == 1 else "step_window", 1)
    rng = np.random.default_rng(0)
    shape = (3, 1, cfg["num_bins"], 64, 96)
    vox = (rng.standard_normal(shape) * (rng.random(shape) < 0.1)).astype(np.float32)
    if steps_per_call == 1:
        outs = [call(np.ascontiguousarray(v[0])) for v in vox]
        frames = np.concatenate([o[0] for o in outs])
        flows = np.concatenate([o[1] for o in outs])
    else:
        frames, flows = call(vox)
    params = reference.load_params(str(harness.ROOT / cfg["weights"]), "cpu")
    ref = reference.make_streams(params, cfg, 1, (64, 96), "cpu")
    ref_frames, ref_flows = ref.steps(torch.from_numpy(vox))
    # f32 on both sides; the orders of summation differ (the program's plain
    # lookup and warp against F.grid_sample and F.avg_pool2d)
    np.testing.assert_allclose(frames, ref_frames.numpy(), atol=2e-5)
    np.testing.assert_allclose(flows, ref_flows.numpy(), atol=2e-4)
    assert float(np.abs(ref_flows.numpy()).max()) > 0.5      # the flow moves
