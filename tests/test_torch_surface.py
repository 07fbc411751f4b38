"""The rest of the JAX package's library surface in the port, on the CPU.

- The host event library (``cista_flow_torch/events/native.py``, built from
  ``csrc/host/cista_events.cpp``): the source is the JAX package's, its
  voxels are bit for bit the JAX package's native library's and the numpy
  golden's, ``preprocess_std`` is bit for bit the JAX library's and within
  rtol 1e-5 / atol 1e-6 of numpy's (f64 against pairwise f32 sums, as
  tests/test_native_events.py holds the JAX library), the triangular voxel
  bit for bit the JAX library's; a missing or failing compiler raises,
  naming it; the port never loads the JAX package's library.
- ``SmallEncoder`` (instance, batch, group and no norm, 48x64), ``SmallUpdateBlock``,
  ``lookup_efficient_corr`` (against the JAX function and against the
  port's materialised ``lookup_corr``) and the cell variants, each against
  its JAX counterpart (jitted) with the weights carried over by
  ``weights.py``, at rtol and atol 1e-5; ``SmallEncoder`` at 1e-5 of its
  output's largest magnitude (both packages' f32 outputs lie 0.5-2e-5
  from an f64 evaluation of the port at outputs up to 10-22: seven norms
  of 48- to 768-pixel planes carry the rounding).
- The polarity voxel, the noise and 'maxmin' bit for bit; the image and
  metric helpers equal the JAX ones; ``ErrorMapWriter``'s PNG decoded by
  cv2 equal to the JAX writer's; ``trace``/``summarize`` on a tiny run.
"""
import os
import random
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cista_flow_tpu import metrics as JMET
from cista_flow_tpu.data import io as JIO
from cista_flow_tpu.data import mvsec_utils as JMU
from cista_flow_tpu.events import native as JN
from cista_flow_tpu.events import voxel as JV
from cista_flow_tpu.nn import encoders as JENC
from cista_flow_tpu.nn import gru as JGRU
from cista_flow_tpu.nn import layers as JL
from cista_flow_tpu.ops import corr as JCORR
from cista_flow_tpu.utils import image as JIMG
from cista_flow_torch import metrics, weights
from cista_flow_torch.data import io
from cista_flow_torch.events import native, voxel
from cista_flow_torch.nn import encoders, gru, layers
from cista_flow_torch.ops import corr
from cista_flow_torch.utils import image, profiling, trace_tools

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


def jax_native_library() -> None:
    """Load the JAX package's native event library in this process,
    building it first where it is missing. Its own build (``make`` straight
    into the library's path, at first use) is not atomic: test workers
    that start together can load a half-written file and fall back to numpy
    for the rest of the process, and the port's tests compare with its
    default, native, path. Here one process at a time builds it, with the
    JAX Makefile's flags, into a temporary file renamed into place, and
    every process then (re)loads it."""
    import ctypes
    import fcntl
    import re
    import subprocess

    so, src = Path(JN._LIB_PATH), REPO / "native" / "cista_events.cpp"
    (REPO / "build").mkdir(exist_ok=True)
    with open(REPO / "build" / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            ctypes.CDLL(str(so))
        except OSError:
            flags = re.search(r"^CXXFLAGS \?= (.*)$", (REPO / "native" / "Makefile").read_text(),
                              re.M).group(1).split()
            tmp = REPO / "build" / f"jax_native.{os.getpid()}.so"
            subprocess.run(["g++", *flags, "-o", str(tmp), str(src)], check=True,
                           capture_output=True)
            os.replace(tmp, so)
        JN._lib, JN._tried = None, False
        assert JN.get_lib() is not None


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    jax_native_library()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nhwc(x):
    return jnp.asarray(np.moveaxis(np.asarray(x), 1, -1))


def close(ours, theirs, tol=TOL, of_scale=False):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    if of_scale:
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=tol * np.abs(theirs).max())
    else:
        np.testing.assert_allclose(ours, theirs, rtol=tol, atol=tol)


def module_from(cls_instance, sd):
    cls_instance.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                                 strict=True)
    return cls_instance.eval()


def randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def random_events(rng, n, w, h):
    t = np.sort(rng.random(n))
    x = rng.integers(0, w, n).astype(np.float64)
    y = rng.integers(0, h, n).astype(np.float64)
    p = rng.integers(0, 2, n).astype(np.float64)
    return np.stack([t, x, y, p], axis=1)


# ------------------------------ the host event library -----------------------

def test_host_library_source_is_the_jax_source():
    assert native.SOURCE.read_bytes() == (REPO / "native" / "cista_events.cpp").read_bytes()
    assert native.CXX_FLAGS == ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]
    assert native.BUILD_DIR == REPO / "build" / "host"
    assert native.so_path().name.startswith("libcista_events_torch-")


@pytest.mark.parametrize("is_reverse", [False, True])
def test_host_library_voxels_bit_for_bit(is_reverse):
    """Against the JAX library (which must have been built) and the numpy
    golden, both polarity kinds; ``preprocess_std`` with and without the
    hot-pixel filter."""
    rng = np.random.default_rng(7)
    for n, w, h in ((20000, 240, 180), (3000, 64, 48)):
        e = random_events(rng, n, w, h)
        ours = voxel.events_to_voxel_grid(e, 5, w, h, is_reverse)
        assert ours.tobytes() == JN.voxelize_events(e, 5, w, h, is_reverse).tobytes()
        np.testing.assert_array_equal(ours, JV.events_to_voxel_grid_numpy(e, 5, w, h, is_reverse))
        for hot in (False, True):
            a = voxel.event_preprocess(ours.copy(), filter_hot_pixel=hot)
            b = ours.copy()
            assert JN.preprocess_std(b, filter_hot_pixel=hot)
            assert a.tobytes() == b.tobytes()
            np.testing.assert_allclose(a, JV.event_preprocess_numpy(ours.copy(), "std", hot),
                                       rtol=1e-5, atol=1e-6)


def test_host_library_triangular_voxel():
    rng = np.random.default_rng(8)
    n = 5000
    exytp = np.stack([rng.integers(0, 346, n).astype(np.float64),
                      rng.integers(0, 260, n).astype(np.float64), np.sort(rng.random(n)),
                      rng.choice([-1.0, 1.0], n)], axis=1)
    ours = native.voxelize_triangular(exytp, 5, 260, 346)
    assert ours.tobytes() == JN.voxelize_triangular(exytp, 5, 260, 346).tobytes()
    np.testing.assert_allclose(ours, JMU.events_to_voxel_triangular(exytp, 5, 260, 346),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_broken_compiler_raises(tmp_path, monkeypatch, compiler):
    """No fallback to numpy: the build raises, naming the compiler, and so
    does the voxelization that needs it."""
    path = tmp_path / "g++"
    if compiler == "failing":
        path.write_text("#!/bin/sh\necho 'cc1plus: error: broken on purpose' >&2\nexit 1\n")
        path.chmod(0o755)
    monkeypatch.setattr(native, "COMPILER", str(path))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+") as err:
        native.get_lib()
    if compiler == "failing":
        assert "broken on purpose" in str(err.value)
    with pytest.raises(RuntimeError):
        voxel.events_to_voxel_grid(random_events(np.random.default_rng(0), 10, 8, 8), 5, 8, 8)
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").glob("*.so"))


def test_host_library_refuses_events_it_would_write_outside_its_output():
    """Pixel coordinates outside the frame (or NaN) and times outside the
    window's first and last raise before the library writes."""
    e = random_events(np.random.default_rng(1), 50, 8, 6)
    for col, value in ((1, 8.0), (2, -1.0), (1, np.nan)):
        bad = e.copy()
        bad[10, col] = value
        with pytest.raises(ValueError, match="outside"):
            voxel.events_to_voxel_grid(bad, 5, 8, 6)
        with pytest.raises(ValueError, match="outside"):
            native.voxelize_triangular(bad[:, [1, 2, 0, 3]], 5, 6, 8)
    bad = e.copy()
    bad[10, 0] = e[-1, 0] + 1.0
    with pytest.raises(ValueError, match="times"):
        voxel.events_to_voxel_grid(bad, 5, 8, 6)
    assert voxel.events_to_voxel_grid(e[::-1], 5, 8, 6, is_reverse=True).shape == (5, 6, 8)


def test_port_loads_only_its_own_library():
    """A process that voxelizes through the port maps the port's library
    and nothing under the JAX package's ``native/``."""
    import subprocess
    import sys
    code = ("import numpy as np\n"
            "from cista_flow_torch.events import events_to_voxel_grid, event_preprocess\n"
            "e = np.array([[0.1, 1, 2, 1], [0.5, 3, 1, 0]], float)\n"
            "event_preprocess(events_to_voxel_grid(e, 5, 8, 8))\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('libcista_events_torch-' in maps, 'native/libcista_events' in maps)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "False"]


# ------------------------------ SmallEncoder ----------------------------------

def random_tree(init, *args, seed=0):
    """A parameter (and state) tree of ``init``'s structure, filled from
    numpy: weights at 1/sqrt(fan in), BatchNorm scales and variances in
    [0.5, 1.5), biases and means at 0.2 sigma. ``jax.eval_shape`` gives the
    structure without running JAX's initialisers, which compile per shape."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: init(key, *args), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "w":
            return randn(rng, *shape, scale=float(np.prod(shape[:-1])) ** -0.5)
        if name in ("scale", "var"):
            return (0.5 + rng.random(shape)).astype(np.float32)
        return randn(rng, *shape, scale=0.2)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("norm_fn", ["instance", "batch", "none", "group"])
def test_small_encoder_matches_jax(norm_fn):
    rng = np.random.default_rng(1)
    p, s = random_tree(JENC.small_encoder_init, 3, 128, norm_fn, seed=3)
    x = randn(rng, 2, 3, 48, 64)
    ref, _ = jax.jit(JENC.small_encoder, static_argnums=(3, 4))(p, s, nhwc(x), norm_fn, False)
    enc = module_from(encoders.SmallEncoder(3, 128, norm_fn),
                      weights.small_encoder_from_jax(p, s, norm_fn))
    with torch.no_grad():
        out = enc(torch.from_numpy(x))
    assert out.shape == (2, 128, 6, 8)
    close(out, np.moveaxis(np.asarray(ref), -1, 1), of_scale=True)


def test_small_encoder_init_is_kaiming_over_fan_out():
    torch.manual_seed(0)
    enc = encoders.SmallEncoder(3, 128, "instance")
    w = enc.layer2[0].conv2.weight          # 16 -> 16, 3x3: fan_out 144
    assert abs(float(w.detach().std()) - (2.0 / 144) ** 0.5) < 0.02
    assert set(enc.state_dict()) == set(weights.small_encoder_from_jax(
        *random_tree(JENC.small_encoder_init, 3, 128, "instance"), "instance"))


# ------------------------------ SmallUpdateBlock -------------------------------

def test_small_update_block_matches_jax():
    rng = np.random.default_rng(2)
    p = random_tree(JGRU.small_update_block_init, 324, 96, seed=4)
    b, h, w = 2, 6, 8
    net, inp = randn(rng, b, 96, h, w), randn(rng, b, 64, h, w)
    cor, emap, flow = randn(rng, b, 324, h, w), randn(rng, b, 128, h, w), randn(rng, b, 2, h, w, scale=3)
    jnet, jmask, jdelta = jax.jit(JGRU.small_update_block)(p, nhwc(net), nhwc(inp), nhwc(cor),
                                                           nhwc(emap), nhwc(flow))
    block = module_from(gru.SmallUpdateBlock(324, 96), weights.small_update_block_from_jax(p))
    with torch.no_grad():
        tnet, tmask, tdelta = block(*(torch.from_numpy(a) for a in (net, inp, cor, emap, flow)))
    assert jmask is None and tmask is None and tdelta.shape == (b, 2, h, w)
    close(tnet, np.moveaxis(np.asarray(jnet), -1, 1))
    close(tdelta, np.moveaxis(np.asarray(jdelta), -1, 1))


# ------------------------------ EfficientCorr ---------------------------------

@pytest.mark.parametrize("h,w", [(6, 8), (12, 16)])
def test_lookup_efficient_corr_matches_jax_and_the_volume(h, w):
    """Coordinates around the grid and far outside it; at 6x8 the third
    level is 1x2 and the fourth empty."""
    rng = np.random.default_rng(3)
    f1, f2 = randn(rng, 2, 32, h, w), randn(rng, 2, 32, h, w)
    coords = corr.coords_grid(2, h, w) + torch.from_numpy(randn(rng, 2, 2, h, w, scale=3))
    coords[0, :, 0, 0] = torch.tensor([-40.0, 70.0])
    ours = corr.lookup_efficient_corr(corr.build_efficient_corr(torch.from_numpy(f1),
                                                                torch.from_numpy(f2)), coords)
    assert ours.shape == (2, 4 * 81, h, w) and ours.dtype == torch.float32
    jec = JCORR.build_efficient_corr(nhwc(f1), nhwc(f2))
    ref = jax.jit(JCORR.lookup_efficient_corr)(jec, nhwc(coords))
    close(ours, np.moveaxis(np.asarray(ref), -1, 1))
    volume = corr.lookup_corr(corr.build_corr_pyramid(torch.from_numpy(f1), torch.from_numpy(f2)),
                              coords)
    close(ours, volume)


# ------------------------------ the cell variants ------------------------------

def test_doubletanh_matches_jax():
    rng = np.random.default_rng(4)
    x, u, lam = randn(rng, 2, 8, 5, 6), randn(rng, 1, 8, 1, 1), randn(rng, 1, 8, 1, 1)
    ref = JL.doubletanh(nhwc(x), nhwc(u), nhwc(lam))
    close(layers.doubletanh(*(torch.from_numpy(a) for a in (x, u, lam))),
          np.moveaxis(np.asarray(ref), -1, 1))


@pytest.mark.parametrize("activation", [None, "relu"])
def test_recurrent_conv_layers_match_jax(activation):
    rng = np.random.default_rng(5)
    x, hc = randn(rng, 2, 6, 10, 12), (randn(rng, 2, 8, 10, 12), randn(rng, 2, 8, 10, 12))
    p = random_tree(JL.recurrent_conv_layer_init, 6, 8, seed=5)
    jh, (_, jc) = jax.jit(JL.recurrent_conv_layer, static_argnames="activation")(
        p, nhwc(x), tuple(map(nhwc, hc)), activation=activation)
    m = module_from(layers.RecurrentConvLayer(6, 8, activation), weights.recurrent_layer_from_jax(p))
    with torch.no_grad():
        th, (th2, tc) = m(torch.from_numpy(x), tuple(map(torch.from_numpy, hc)))
    assert th is th2
    close(th, np.moveaxis(np.asarray(jh), -1, 1))
    close(tc, np.moveaxis(np.asarray(jc), -1, 1))

    hc2 = (randn(rng, 2, 8, 20, 24), randn(rng, 2, 8, 20, 24))
    p = random_tree(JL.recurrent_upsample_conv_layer_init, 6, 8, seed=6)
    jh, (_, jc) = jax.jit(JL.recurrent_upsample_conv_layer, static_argnames="activation")(
        p, nhwc(x), tuple(map(nhwc, hc2)), activation=activation)
    m = module_from(layers.RecurrentUpsampleConvLayer(6, 8, activation),
                    weights.recurrent_layer_from_jax(p))
    with torch.no_grad():
        th, (_, tc) = m(torch.from_numpy(x), tuple(map(torch.from_numpy, hc2)))
    close(th, np.moveaxis(np.asarray(jh), -1, 1))
    close(tc, np.moveaxis(np.asarray(jc), -1, 1))


def test_decay_gates_and_neuron_lstc_match_jax():
    rng = np.random.default_rng(6)
    x, x1 = randn(rng, 2, 8, 7, 9), randn(rng, 2, 24, 7, 9)
    p = random_tree(JL.decay_gates_init, 8, 24, 3, seed=7)
    m = module_from(layers.DecayGates(8, 24, 3), weights.decay_gates_from_jax(p))
    with torch.no_grad():
        close(m(torch.from_numpy(x), torch.from_numpy(x1)),
              jax.jit(JL.decay_gates)(p, nhwc(x), nhwc(x1)))
    p2 = random_tree(JL.decay_gates_init, 8, 8, 3, seed=8)
    m2 = module_from(layers.DecayGates(8, 8, 3), weights.decay_gates_from_jax(p2))
    with torch.no_grad():
        close(m2(torch.from_numpy(x)), jax.jit(JL.decay_gates)(p2, nhwc(x)))

    prev = randn(rng, 2, 8, 7, 9)
    p = random_tree(JL.neuron_lstc_init, 8, 8, seed=9)
    m = module_from(layers.NeuronLSTC(8, 8), weights.neuron_lstc_from_jax(p))
    with torch.no_grad():
        out = m(torch.from_numpy(x), torch.from_numpy(prev))
    close(out, np.moveaxis(np.asarray(jax.jit(JL.neuron_lstc)(p, nhwc(x), nhwc(prev))), -1, 1))


# ------------------------------ voxel variants, helpers -------------------------

def test_voxel_variants_bit_for_bit():
    rng = np.random.default_rng(9)
    e = random_events(rng, 4000, 40, 30)
    for ev in (e, e[:0], e[:1]):
        ours = voxel.events_to_voxel_grid_pol(ev, 5, 40, 30)
        assert ours.shape == (5, 2, 30, 40)
        assert ours.tobytes() == JV.events_to_voxel_grid_pol(ev, 5, 40, 30).tobytes()
    v = voxel.events_to_voxel_grid_numpy(e, 5, 40, 30)
    for hot in (False, True):
        a = voxel.event_preprocess(v.copy(), "maxmin", hot)
        assert a.tobytes() == JV.event_preprocess(v.copy(), "maxmin", hot).tobytes()
    for std, frac in ((1.0, 0.1), (0.5, 1.0)):
        a = voxel.add_noise_to_voxel(v, std, frac, rng=np.random.default_rng(11))
        b = JV.add_noise_to_voxel(v, std, frac, rng=np.random.default_rng(11))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    with pytest.raises(TypeError):
        voxel.add_noise_to_voxel(v)


def test_image_helpers_match_jax(monkeypatch):
    rng = np.random.default_rng(10)
    for size, f in ((180, 3), (260, 4), (64, 2), (346, 3)):
        assert image.optimal_crop_size(size, f) == JIMG.optimal_crop_size(size, f)
    x4, x2 = randn(rng, 2, 37, 53, 3), randn(rng, 37, 53)
    for w, h, n in ((53, 37, 3), (346, 260, 4)):
        a, b = image.CropParameters(w, h, n), JIMG.CropParameters(w, h, n)
        assert vars(a) == vars(b)
    cp, jcp = image.CropParameters(53, 37, 3), JIMG.CropParameters(53, 37, 3)
    for x in (x4, x2, x4[0]):
        assert np.array_equal(cp.pad(x), jcp.pad(x))
        assert np.array_equal(cp.crop(cp.pad(x)), x)
    for mode in ("sintel", "kitti"):
        a, b = image.InputPadder(x4.shape[:3], 8, mode), JIMG.InputPadder(x4.shape[:3], 8, mode)
        pa, pb = a.pad(x4, x4[0]), b.pad(x4, x4[0])
        assert all(np.array_equal(u, v) for u, v in zip(pa, pb))
        assert np.array_equal(a.unpad(pa[0]), x4) and np.array_equal(a.unpad(pa[1]), x4[0])
    flow = randn(rng, 2, 12, 16, scale=2)
    assert image.forward_interpolate(flow).tobytes() == JIMG.forward_interpolate(flow).tobytes()

    np_state, py_state, t_state = np.random.get_state(), random.getstate(), torch.get_rng_state()
    monkeypatch.setenv("PYTHONHASHSEED", "0")
    try:
        draws = []
        for fn in (image.setup_seed, JIMG.setup_seed):
            fn(17)
            draws.append((os.environ["PYTHONHASHSEED"], np.random.rand(), random.random(),
                          float(torch.rand(1))))
        assert draws[0] == draws[1] and draws[0][0] == "17"
    finally:
        np.random.set_state(np_state)
        random.setstate(py_state)
        torch.set_rng_state(t_state)


def test_metric_helpers_match_jax():
    rng = np.random.default_rng(12)
    a, b = rng.random((2, 20, 30)).astype(np.float32), rng.random((2, 20, 30)).astype(np.float32)
    assert metrics.mse_np(a, b) == JMET.mse_np(a, b)
    assert metrics.psnr_np(a, b) == JMET.psnr_np(a, b) and metrics.psnr_np(a, a) == 100.0
    fp, fg = randn(rng, 2, 20, 30, 2, scale=4), randn(rng, 2, 20, 30, 2, scale=4)
    valid = rng.random((2, 20, 30)).astype(np.float32)
    assert metrics.epe_np(fp, fg) == JMET.epe_np(fp, fg)
    assert metrics.epe_np(fp, fg, valid) == JMET.epe_np(fp, fg, valid)
    from cista_flow_torch import losses
    for name in ("flow_evaluate", "fwl_metric", "psnr", "recon_evaluate", "ssim"):
        assert getattr(metrics, name) is getattr(losses, name) and hasattr(JMET, name)


def test_error_map_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    img = rng.integers(0, 256, (30, 41)).astype(np.uint8)
    gt = np.clip(img.astype(int) + rng.integers(-160, 160, img.shape), 0, 255).astype(np.uint8)
    files = []
    for mod, name in ((io, "port"), (JIO, "jax")):
        cfg = types.SimpleNamespace(output_folder=str(tmp_path / name), test_data_name="seq",
                                    is_write_emap=True)
        mod.ErrorMapWriter(cfg, "model")(img, gt, 3)
        files.append(tmp_path / name / "model" / "seq" / "error_maps" / "frame_0000000003.png")
    ours, theirs = (cv2.imread(str(f), cv2.IMREAD_UNCHANGED) for f in files)
    assert ours.shape == (30, 41, 3) and np.array_equal(ours, theirs)
    lut = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[None], cv2.COLORMAP_COOL)[0]
    assert np.array_equal(io.COOL_BGR, lut)
    off = types.SimpleNamespace(output_folder=str(tmp_path / "off"), test_data_name="seq",
                                is_write_emap=False)
    io.ErrorMapWriter(off, "model")(img, gt, 0)
    assert not list((tmp_path / "off").rglob("*.png"))


def test_trace_and_summarize_a_tiny_run(tmp_path):
    x, w = torch.randn(1, 4, 16, 16), torch.randn(4, 4, 3, 3)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("tiny_region"):
            for _ in range(3):
                torch.nn.functional.conv2d(x, w, padding=1).relu()
    events = trace_tools.load_events(str(tmp_path))
    assert any(e["name"] == "cista.tiny_region" for e in events)
    assert trace_tools.summarize(str(tmp_path)) == []          # no card: no device events
    host = trace_tools.summarize(str(tmp_path), runs=3, top=50, side="host")
    names = [k for k, _, _ in host]
    assert "cista.tiny_region" not in names and "aten::conv2d" not in names   # containers left out
    assert all(ms >= 0 for _, ms, _ in host) and sum(n for _, _, n in host) > 3
    assert {e.get("cat") for e in events} <= {"cpu_op", "user_annotation"}
    with pytest.raises(FileNotFoundError):
        trace_tools.load_events(str(tmp_path / "none"))
