"""cista-idnet in training on the CPU in f32, against the JAX package: the
composite in train mode and the BPTT train step (with the helpers and
weights of tests/test_torch_train_modes.py: the anchor
``gate/idnet_ft2_f16.npz``'s flow net, the width-16 reconstructor with its
head scaled), IDNet's other branches (the 'patch' deblur scales,
``deblur=False`` with and without ``add_delta``, the ``input_flowmap``
context encoder) and ``rec_ide``, the sequence generator.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.models import idnet as JIDNET
from cista_flow_torch import weights
from cista_flow_torch.data.sim import write_train_dataset
from cista_flow_torch.models import idnet
from test_torch_train_modes import (H, W, check_composite, check_train_step, jax_weights,
                                    nchw, nhwc, np_tree, one_torch_thread)  # noqa: F401


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("idnet")
    write_train_dataset(str(root), 2, 4, H, W, seed=0)
    return str(root)


def test_composite_train_step_matches_jax():
    """``CistaIDNet`` in train mode with the reconstructor frozen against
    ``composite.apply(train=True)`` (see ``check_composite``): the
    reconstruction, ``flow_final``, ``next_flow`` and both histories
    (``flow_preds``, ``delta_flow``) at 1e-4 abs."""
    check_composite("cista-idnet", "rec")


@pytest.mark.parametrize("phase", ["both", pytest.param("rec", marks=pytest.mark.slow)])
def test_train_step_matches_jax(data, phase):
    """One ``make_train_step`` step of cista-idnet: the phase-3 flow half
    (flow net trains, loss 'both', IDNet's listed ``flow_preds`` through
    ``_seq_loss``) and phase 2 (the reconstructor trains); the tolerances of
    ``check_train_step``."""
    check_train_step(data, "cista-idnet", phase)



@functools.lru_cache(maxsize=None)
def _idnet_pair(input_flowmap: bool):
    """JAX IDNet params (the anchor's, plus a random context encoder with
    ``input_flowmap``) and the port's IDNet with the same weights."""
    params, _ = jax_weights("cista-idnet")
    flow = dict(params["flow"])
    if input_flowmap:
        rand = JIDNET.init(jax.random.PRNGKey(3), JConfig(image_dim=(H, W)), input_flowmap=True)
        flow["cnet"] = rand["cnet"]
    sd = weights.from_jax({"cista": params["cista"], "flow": np_tree(flow)}, {"flow": {}})
    net = idnet.IDNet(input_flowmap=input_flowmap)
    net.load_state_dict({k[len("event_flownet."):]: torch.tensor(np.asarray(v))
                         for k, v in sd.items() if k.startswith("event_flownet.")}, strict=True)
    return flow, net


@pytest.mark.parametrize("case", ["patch_mode", "no_deblur", "no_deblur_add_delta",
                                  "input_flowmap", "input_flowmap_init"])
def test_idnet_branches_match_jax(case):
    """The reference's IDNet branches against ``idnet.apply``, 2 deblur
    iterations at 48x64: 'patch' deblur scales, ``deblur=False`` with and
    without ``add_delta``, the context encoder over the running flow map
    (``input_flowmap``, from iteration 1, or 0 with a ``flow_init``):
    ``flow_final``, ``next_flow`` and both histories to 1e-4 abs."""
    flowmap = case.startswith("input_flowmap")
    flow, net = _idnet_pair(flowmap)
    rng = np.random.default_rng(11)
    vox = rng.standard_normal((2, H, W, 5)).astype(np.float32)
    fi = (2 * rng.standard_normal((2, 64, 64, 2))).astype(np.float32) \
        if case == "input_flowmap_init" else None          # padded to a multiple of 32
    kw = {"patch_mode": dict(deblur_mode="patch"), "no_deblur": dict(deblur=False),
          "no_deblur_add_delta": dict(deblur=False, add_delta=True)}.get(case, {})
    ref = JIDNET.apply(flow, jnp.asarray(vox), JConfig(image_dim=(H, W)),
                       flow_init=None if fi is None else jnp.asarray(fi), deblur_iters=2,
                       input_flowmap=flowmap, **kw)
    net.deblur_mode = kw.pop("deblur_mode", "voxel")
    with torch.no_grad():
        out = net(nchw(vox), flow_init=None if fi is None else nchw(fi), iters=2,
                  collect_preds=True, **kw)

    def close(a, b):
        np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=0, atol=1e-4)
    close(out["flow_final"], ref["flow_final"])
    close(out["next_flow"], ref["next_flow"])
    for key in ("flow_preds", "delta_flow"):
        assert len(out[key]) == len(ref[key]) == (2 if key == "flow_preds" else 3)
        for a, b in zip(out[key], ref[key]):
            close(a, b)


def test_rec_ide_matches_jax():
    """``rec_ide`` (tests/test_variants.py:129) against the JAX generator:
    4 steps yielding every 2, each yield's flows and next-flow trajectory to
    1e-4 abs; the chained flow is detached at each yield (the gradient of
    the second yield's flow reaches nothing of the first window's input)."""
    flow, net = _idnet_pair(False)
    rng = np.random.default_rng(12)
    batch = [rng.standard_normal((2, H, W, 5)).astype(np.float32) for _ in range(4)]
    ref = list(JIDNET.rec_ide(flow, [jnp.asarray(b) for b in batch],
                              JConfig(image_dim=(H, W)), yield_every=2))
    xs = [nchw(b).requires_grad_(True) for b in batch]
    outs = list(idnet.rec_ide(net, xs, yield_every=2))
    assert len(outs) == len(ref) == 2
    for o, r in zip(outs, ref):
        np.testing.assert_allclose(nhwc(o["flow_final"]), np.asarray(r["flow_final"]),
                                   rtol=0, atol=1e-4)
        for key in ("flow_preds", "flow_next_trajectory"):
            assert len(o[key]) == len(r[key]) == 2
            for a, b in zip(o[key], r[key]):
                np.testing.assert_allclose(nhwc(a), np.asarray(b), rtol=0, atol=1e-4)
    outs[1]["flow_final"].sum().backward()
    assert xs[0].grad is None and xs[1].grad is None and xs[3].grad is not None


