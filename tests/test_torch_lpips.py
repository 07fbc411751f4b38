"""The port's LPIPS (``cista_flow_torch/losses/lpips.py``) against the JAX
package's (``cista_flow_tpu/losses/lpips.py``) on the CPU in f32.

One seeded random parameter set is carried across: the port's
``init(seed)``, written in the JAX npz layout by the port's ``save_npz`` and
read by the JAX ``load_npz``. The repo holds no trained LPIPS weights, so
none is used. Inputs come from a numpy seed at 48x64. Tolerances: 1e-5
relative on the distance (f32 sums over a few thousand terms in another
order); the gradient to 1e-4 of its largest magnitude against the JAX
package's for AlexNet, and for VGG to 2e-2 of it and 5e-3 relative L2: the
JAX package's own f32 VGG gradient is that far (1.3e-2, 1.9e-3) from an
f64 evaluation of the same function, the port's 3e-6. So the port's f32
gradient is also held to its own f64 evaluation at 1e-5 of its largest
magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.losses import lpips as JL
from cista_flow_tpu.losses import recon as JR
from cista_flow_torch.config import Config
from cista_flow_torch.losses import lpips as TL
from cista_flow_torch.losses import recon as TR

H, W = 48, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this module's small CPU shapes: the test
    runner's workers share the machine's cores, and torch's thread pools
    then wait on one another."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close_grad(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module", params=["alex", "vgg"])
def pair(request, tmp_path_factory):
    """(net, the port's params from init(seed), the JAX params read from
    the npz the port wrote)."""
    params = TL.init(seed=3, net=request.param)
    path = str(tmp_path_factory.mktemp("lpips") / f"{request.param}.npz")
    TL.save_npz(params, path)
    return request.param, params, JL.load_npz(path)


@pytest.mark.parametrize("channels", [1, 3])
def test_lpips_matches_jax(pair, channels):
    """The distance and its gradient with respect to the prediction, one
    channel (tiled to three, as the reconstruction loss calls it) and three,
    against ``jax.value_and_grad`` of the JAX function."""
    net, params, jparams = pair
    rng = np.random.default_rng(4 + channels)
    pred = rng.random((2, H, W, channels)).astype(np.float32)
    target = rng.random((2, H, W, channels)).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(lambda p, t: JL.lpips(jparams, p, t)))(
        jnp.asarray(pred), jnp.asarray(target))
    grads = {}
    for dt in (torch.float32, torch.float64):
        p = nchw(pred).to(dt).requires_grad_(True)
        tv = TL.lpips({k: [{n: v.to(dt) for n, v in q.items()} for q in ps]
                       for k, ps in params.items()}, p, nchw(target).to(dt))
        tv.backward()
        assert tv.shape == () and tv.dtype == dt and float(tv) > 0
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
        grads[dt] = nhwc(p.grad)
    g, jg = grads[torch.float32], np.asarray(jg)
    np.testing.assert_allclose(g, grads[torch.float64], rtol=0,
                               atol=1e-5 * np.abs(grads[torch.float64]).max())
    if net == "alex":
        _close_grad(g, jg)
    else:
        np.testing.assert_allclose(g, jg, rtol=0, atol=2e-2 * np.abs(jg).max())
        assert np.linalg.norm(g - jg) <= 5e-3 * np.linalg.norm(jg)
    assert len(params["convs"]) == {"alex": 5, "vgg": 13}[net]


def test_npz_layout_round_trip(pair, tmp_path):
    """``load_npz`` reads back what ``save_npz`` wrote, and the JAX
    ``save_npz`` of the JAX-read params gives the same tensors."""
    _, params, jparams = pair
    path = str(tmp_path / "j.npz")
    JL.save_npz(jparams, path)
    for loaded in (TL.load_npz(path), TL.load_weights(path)):
        for kind in ("convs", "lins"):
            assert len(loaded[kind]) == len(params[kind])
            for a, b in zip(loaded[kind], params[kind]):
                assert sorted(a) == sorted(b)
                for k in a:
                    assert torch.equal(a[k], b[k]), (kind, k)


def test_load_full_lpips_state_dict(tmp_path):
    """``load_weights`` of a full ``lpips.LPIPS`` state dict (the layout of
    tests/test_lpips_convert.py) against the JAX ``load_torch_weights``:
    the same distance."""
    rng = np.random.default_rng(8)
    sd = {}
    idx = [(0, 1), (3, 2), (6, 3), (8, 4), (10, 5)]
    for (i, sl), (cout, cin, k, _, _) in zip(idx, TL.ALEX):
        sd[f"net.slice{sl}.{i}.weight"] = torch.tensor(
            rng.normal(0, 0.1, (cout, cin, k, k)), dtype=torch.float32)
        sd[f"net.slice{sl}.{i}.bias"] = torch.tensor(rng.normal(0, 0.1, cout),
                                                     dtype=torch.float32)
    for i, (cout, *_) in enumerate(TL.ALEX):
        sd[f"lin{i}.model.1.weight"] = torch.tensor(
            np.abs(rng.normal(0, 0.05, (1, cout, 1, 1))), dtype=torch.float32)
    path = str(tmp_path / "lpips_full.pth")
    torch.save(sd, path)
    params = TL.load_weights(path)
    jparams = JL.load_torch_weights(lpips_full_path=path)
    pred = rng.random((1, H, W, 1)).astype(np.float32)
    target = rng.random((1, H, W, 1)).astype(np.float32)
    np.testing.assert_allclose(
        float(TL.lpips(params, nchw(pred), nchw(target))),
        float(jax.jit(JL.lpips)(jparams, jnp.asarray(pred), jnp.asarray(target))), rtol=1e-5)


def test_params_from_env(pair, tmp_path, monkeypatch, capsys):
    """``params_from_env`` reads the first of CISTA_LPIPS, CISTA_LPIPS_ALEX,
    CISTA_LPIPS_VGG that names a file; None when none does."""
    _, params, _ = pair
    for var in TL.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    assert TL.params_from_env() is None
    path = str(tmp_path / "p.npz")
    TL.save_npz(params, path)
    monkeypatch.setenv("CISTA_LPIPS", str(tmp_path / "absent.npz"))
    monkeypatch.setenv("CISTA_LPIPS_VGG", path)
    got = TL.params_from_env()
    assert got is not None and len(got["convs"]) == len(params["convs"])
    assert "CISTA_LPIPS_VGG" in capsys.readouterr().out


@pytest.mark.parametrize("consis", [True, False])
def test_recon_loss_with_lpips_matches_jax(consis, tmp_path):
    """``recon_loss`` with LPIPS (AlexNet) against the JAX package's, value
    and gradient with respect to the reconstruction: the term the trainer
    adds when CISTA_LPIPS is set."""
    params = TL.init(seed=6)
    TL.save_npz(params, str(tmp_path / "a.npz"))
    jparams = JL.load_npz(str(tmp_path / "a.npz"))
    rng = np.random.default_rng(9)
    out = rng.random((2, H, W, 1)).astype(np.float32)
    prev = rng.random((2, H, W, 1)).astype(np.float32)
    tgt = {"gt_img1": rng.random((2, H, W, 1)).astype(np.float32),
           "gt_flow": (2.0 * rng.standard_normal((2, H, W, 2))).astype(np.float32),
           "valid": rng.random((2, H, W, 1)).astype(np.float32)}
    jcfg, tcfg = JConfig(image_dim=(H, W)), Config(model_mode="cista-eiflow", image_dim=(H, W))
    jv, jg = jax.jit(jax.value_and_grad(lambda o, prev, tgt: JR.recon_loss(
        o, prev, tgt, jcfg, lpips_params=jparams, is_loss_consis=consis)[0]))(
        jnp.asarray(out), jnp.asarray(prev), {k: jnp.asarray(v) for k, v in tgt.items()})
    o = nchw(out).requires_grad_(True)
    tv, parts = TR.recon_loss(o, nchw(prev), {k: nchw(v) for k, v in tgt.items()}, tcfg,
                              lpips_params=params, is_loss_consis=consis)
    tv.backward()
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    _close_grad(nhwc(o.grad), jg)
    assert float(parts["LPIPS"]) > 0
