"""RAFT (``cista_flow_torch/models/raft.py``) against the JAX package's
``models/raft.py`` on the CPU in f32, and the flow-net key map
``weights.flow_net_from_jax`` against the JAX package's exporters.

One set of weights in both: a JAX ``raft.init`` carried across with
``flow_net_from_jax`` and loaded with ``strict=True``. RGB inputs in
[0, 255] from a numpy seed, at 36x44 (padded to 40x48 by the model), 2
iterations. Tolerance: 1e-5 of each output's largest magnitude (chains of
f32 convs summed in another order than XLA's), the BatchNorm running
statistics of a train-mode call 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.ckpt import torch_import as ti
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import dceiflow as JD
from cista_flow_tpu.models import eraft as JE
from cista_flow_tpu.models import raft as JR
from cista_flow_torch import weights
from cista_flow_torch.models.raft import RAFT

H, W = 36, 44


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, -3)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), -3, -1)


@pytest.fixture(scope="module")
def pair():
    jcfg = JConfig(image_dim=(H, W))
    params, state = jax.jit(lambda k: JR.init(k, jcfg))(jax.random.PRNGKey(0))
    model = RAFT()
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           weights.flow_net_from_jax(np_tree(params), np_tree(state)).items()},
                          strict=True)
    return jcfg, params, state, model


@pytest.mark.parametrize("train", [False, True])
def test_raft_forward_matches_jax(pair, train):
    """Every iteration's flow, the 1/8 flow and the unpadded final flow, in
    eval mode and in train mode (BatchNorm on the batch), and in train mode
    the updated running statistics."""
    jcfg, params, state, model = pair
    rng = np.random.default_rng(3)
    im1, im2 = ((255 * rng.random((2, H, W, 3))).astype(np.float32) for _ in range(2))
    ref, new_state = JR.apply(params, state, jnp.asarray(im1), jnp.asarray(im2), jcfg,
                              iters=2, train=train)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           weights.flow_net_from_jax(np_tree(params), np_tree(state)).items()})
    model.train(train)
    with torch.no_grad():
        out = model(nchw(im1), nchw(im2), iters=2, collect_preds=True)
    assert out["flow_preds"].shape == (2, 2, 2, 40, 48)
    assert out["flow_final"].shape == (2, 2, H, W)
    for key in ("flow_preds", "flow_init", "flow_final"):
        want = np.asarray(ref[key])
        np.testing.assert_allclose(nhwc(out[key]), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    stats = weights.flow_net_from_jax(np_tree(params), np_tree(new_state))
    got = model.state_dict()
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-6)
    ticks = {int(got[k]) for k in got if k.endswith("num_batches_tracked")}
    assert ticks == {1 if train else 0}


@pytest.mark.parametrize("arch", ["dceiflow", "eraft", "raft"])
def test_flow_net_from_jax_is_the_jax_export(arch):
    """``flow_net_from_jax`` of a flow net's tree gives the keys and values
    of the JAX package's exporter (``ti.dceiflow_export`` /
    ``eraft_export`` / ``raft_export``, its ``pretrain_flow`` checkpoint),
    and a port model of that arch loads them with ``strict=True``."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.pretrain_flow import flow_net
    init, export = {"dceiflow": (JD.init, ti.dceiflow_export),
                    "eraft": (JE.init, ti.eraft_export),
                    "raft": (JR.init, ti.raft_export)}[arch]
    params, state = np_tree(init(jax.random.PRNGKey(1), JConfig(image_dim=(32, 32))))
    ours, theirs = weights.flow_net_from_jax(params, state), export(params, state)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    model = flow_net(arch, Config(model_mode="cista-eiflow"), device="cpu")
    assert sorted(model.state_dict()) == sorted(ours)
    model.load_state_dict({k: torch.tensor(v) for k, v in ours.items()}, strict=True)


def test_flow_net_init_matches_jax():
    """A fresh flow net's weights are drawn as the JAX package's ``init``
    draws them: every conv weight of 4096 elements or more within 10% of
    the JAX init's standard deviation (the encoders' kaiming normal over
    fan_out, the update block's torch default), BatchNorm at scale 1 and
    bias 0."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.pretrain_flow import flow_net
    params, state = np_tree(JE.init(jax.random.PRNGKey(2), JConfig(image_dim=(32, 32))))
    ref = weights.flow_net_from_jax(params, state)
    got = flow_net("eraft", Config(model_mode="cista-eiflow"), device="cpu").state_dict()
    checked = 0
    for k, v in ref.items():
        if k.endswith(".weight") and v.ndim == 4 and v.size >= 4096:
            assert float(got[k].std()) == pytest.approx(float(v.std()), rel=0.1), k
            checked += 1
        elif "norm" in k and k.endswith((".weight", ".bias")):
            assert torch.equal(got[k], torch.tensor(v)), k
    assert checked > 20
