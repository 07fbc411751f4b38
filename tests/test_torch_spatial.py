"""Row-sharded serving (``--mesh_shape N --mesh_axes spatial``) on the CPU.

Each of N gloo ranks on 127.0.0.1 (``parallel.mesh.launch``; the ranks'
function is ``parallel.check.spatial_rank``) holds a band of rows of every
activation (``parallel/spatial.py``, ``ops/bands.py``). One spawned pool of
ranks per rank count runs every job that needs ranks; the banded ops take
their halos as arguments, so they are held in one process by cutting a
tensor into bands:

* (b) each banded op against the unsharded op: convs (3x3 zeros and
  reflect, 7x7 and 3x3 stride 2, 1x1 stride 2, (1,5) and (5,1)) at 1e-6
  (relative too where the values pass 1),
  the ISTA loop + Dg on a widened band, instance norm from the bands'
  combined statistics at 1e-5, the correlation pyramid and lookup of a
  band's rows at its offset coordinates, the banded warp under the whole
  flow's gate (one band's flow all zero), and the resizes: ``upflow``,
  x0.5, x2 and ``convex_upsample``;
* (a) ``halo`` and ``gather_rows`` of uneven bands on 2 and 3 ranks;
* (c) ``Reconstructor`` on 2 ranks (cista-eiflow window, cista-eraft window
  and steps, cista-gtflow window with GT flows, cista-idnet window and
  steps with ``next_flow`` chained) at 64x96 and on 3 ranks (cista-eiflow
  and cista-idnet, uneven bands) at 80x96, 3 closed-loop steps with the
  gate weights and ``flow_iters`` 1 (cista-idnet 2 deblur iterations, the
  second from the gathered deblurred voxel). 64 rows cannot take 3 ranks:
  a band needs 3 rows at 1/8 of the padded frame (``spatial.max_world``).
  cista-eiflow ``flow_half`` on 2 ranks at 96x96 and on 3 at 144x96: its
  flow net's frame is the half frame, whose padded rows at 1/8 (8 at 64
  rows, 8 at 80) take one band only. Held against
  the port's one process (frames atol 1e-6, flows atol 1e-4, every step:
  tighter than the JAX test) and against the JAX package's unsharded
  ``Reconstructor`` at tests/test_sharded_inference.py:66-71's tolerances
  (frames rtol 1e-4 atol 1e-6 at every step, flows rtol 1e-3 atol 1e-4
  from step 1 on: at step 0 cista-eraft's all-zero previous voxel leaves
  its instance norms degenerate, and the two packages' flows part by
  0.65 px there, sharded or not);
* (d) ``python -m cista_flow_torch.test_noeval --device cpu --mesh_shape 2
  --mesh_axes spatial`` writes one process's files (frames within one grey
  level, flow pictures as tests/test_torch_cli.py holds them), and the
  serving CLIs' refusals;
* (e, slow) against the JAX package's own sharded runner
  (``Config(mesh_shape="2", mesh_axes="spatial")`` on conftest's virtual
  CPU devices).
"""
import os
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.runner import Reconstructor as JReconstructor
from cista_flow_torch import test_noeval
from cista_flow_torch.config import Config
from cista_flow_torch.data import sim
from cista_flow_torch.models.cista_lstc import CistaLSTC
from cista_flow_torch.ops import bands, corr, cuda_aug, cuda_corr, cuda_norm, resize, upsample
from cista_flow_torch.ops.conv import conv2d, conv2d_rows
from cista_flow_torch.parallel import check, spatial
from cista_flow_torch.runner import Reconstructor
from test_torch_cli import write_stream

REPO = Path(__file__).resolve().parent.parent
GATE = REPO / "gate"
ANCHORS = {"cista-eiflow": GATE / "flagship_ft1_f16.npz", "cista-eraft": GATE / "eraft_ft1_f16.npz",
           "cista-gtflow": GATE / "flagship_ft1_f16.npz", "cista-idnet": GATE / "idnet_ft2_f16.npz"}
T = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread_a_process():
    """One intra-op thread here and in every spawned rank
    (``OMP_NUM_THREADS``), as tests/test_torch_parallel.py runs."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


def cut(x: torch.Tensor, sizes) -> list:
    """(first row, band) of each band of ``x`` (dim -2)."""
    out, first = [], 0
    for n in sizes:
        out.append((first, x[..., first:first + n, :]))
        first += n
    return out


def halos(x: torch.Tensor, sizes, r: int) -> list:
    """(first row, band, top, bottom): each band with ``r`` rows of each
    neighbour, None at the frame's edge."""
    out = []
    for i, (a, band) in enumerate(cut(x, sizes)):
        b = a + band.shape[-2]
        top = x[..., a - r:a, :] if i > 0 and r else None
        bottom = x[..., b:b + r, :] if i < len(sizes) - 1 and r else None
        out.append((a, band, top, bottom))
    return out


def randn(*shape, seed=0, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * scale


# ------------------------------- (b) the banded ops ----------------------------

def test_partition_rule():
    """Boundaries are multiples of 8 of the padded frame and even rows of
    the unpadded one; rank 0's band carries the padding; 180 rows go over
    3 ranks unevenly; too many ranks refuse, naming the most the frame
    allows."""
    p = spatial.partition((180, 240), 3, 5)
    assert p.pad == 12 and p.cuts == (0, 72, 136, 192)
    assert p.sizes() == [60, 64, 56] and p.sizes(2) == [30, 32, 28]
    assert p.sizes(8, padded=True) == [9, 8, 7]
    assert all(c % 8 == 0 for c in p.cuts) and all((c - 12) % 2 == 0 for c in p.cuts[1:])
    assert spatial.partition((480, 640), 2, 5).sizes() == [240, 240]
    assert spatial.max_world((180, 240), 5) == 7 and spatial.max_world((64, 96), 1) == 2
    with pytest.raises(ValueError, match="at most 7 ranks"):
        spatial.partition((180, 240), 8, 5)


def test_partition_rule_of_the_half_frame():
    """``flow_half``: the cuts are multiples of 8 of the half frame padded
    (90 rows of 180 padded by 6 at the top), so even rows of the frame;
    rank 0's band carries the half frame's padding; the half-resolution
    maps' bands are the half frame's unpadded bands."""
    p = spatial.partition((180, 240), 3, 5, half=True)
    assert (p.pad, p.cuts, p.down) == (6, (0, 40, 64, 96), 2)
    assert p.sizes(8, padded=True) == [5, 3, 4]
    assert p.sizes() == [68, 48, 64] and p.sizes(2) == [34, 24, 32]
    assert [p.rows(r, 2) for r in range(3)] == [(0, 34, 90), (34, 58, 90), (58, 90, 90)]
    assert spatial.max_world((180, 240), 5, half=True) == 3
    assert spatial.max_world((64, 96), 1, half=True) == 1
    with pytest.raises(ValueError, match="at most 3 ranks"):
        spatial.partition((180, 240), 4, 5, half=True)


CONVS = [  # (cin, cout, (kh, kw), stride, (ph, pw), padding mode)
    (8, 8, (3, 3), 1, (1, 1), "zeros"),
    (8, 8, (3, 3), 1, (1, 1), "reflect"),
    (64, 64, (3, 3), 1, (1, 1), "zeros"),        # K5's shape
    (5, 16, (7, 7), 2, (3, 3), "zeros"),         # the encoders' head
    (8, 8, (3, 3), 2, (1, 1), "reflect"),        # CISTA's W0
    (8, 8, (1, 1), 2, (0, 0), "zeros"),          # a residual stage's downsample
    (12, 8, (1, 5), 1, (0, 2), "zeros"),         # SepConvGRU
    (12, 8, (5, 1), 1, (2, 0), "zeros"),
    (2, 16, (7, 7), 1, (3, 3), "zeros"),         # the motion encoders' convf1
]


@pytest.mark.parametrize("cin,cout,k,stride,pad,mode", CONVS)
def test_conv_rows_match_the_frame(cin, cout, k, stride, pad, mode):
    x = randn(2, cin, 24, 10, seed=1)
    w = randn(cout, cin, *k, seed=2, scale=(cin * k[0] * k[1]) ** -0.5)
    b = randn(cout, seed=3, scale=0.1)
    ref = conv2d(x, w, b, stride, pad, mode, relu=True)
    r = bands.conv_halo(k[0], stride, pad[0])
    got = torch.cat([conv2d_rows(band, top, bottom, w, b, (stride, stride), pad, mode, True)
                     for _, band, top, bottom in halos(x, [8, 10, 6], r)], dim=-2)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_ista_on_a_widened_band_matches_the_frame():
    """K3's function (the plain loop on the CPU) at depth 2: one halo of
    2*depth+1 rows of x1 and z, one call, cropped."""
    torch.manual_seed(4)
    m = CistaLSTC(5, 16, 2)
    x1, z = randn(1, 16, 20, 12, seed=5), randn(1, 32, 20, 12, seed=6, scale=0.1)
    ref = m.ista(x1, z)
    xz = torch.cat([x1, z], 1)
    parts = [m.ista_rows(None, band[:, :16], band[:, 16:], halos=(top, bottom))
             for _, band, top, bottom in halos(xz, [6, 8, 6], 5)]
    for i in range(2):
        torch.testing.assert_close(torch.cat([p[i] for p in parts], dim=-2), ref[i],
                                   rtol=0, atol=1e-6)


def test_instance_norm_from_combined_statistics():
    """Each band's (mean, inverse std) as K4s gives them, combined by
    element counts, normalise the band as the frame's statistics do; a
    zero-padded top band (rank 0's) included."""
    x = randn(2, 6, 24, 10, seed=7, scale=3.0) + 1.5
    x[..., :5, :] = 0.0
    sizes = [7, 9, 8]
    stats = torch.stack([bands.band_stats(*cuda_norm.instance_norm_stats_plain(band),
                                          band.shape[-2] * band.shape[-1], 1e-5)
                         for _, band in cut(x, sizes)])
    mean, inv = bands.combine_stats(stats, 1e-5)
    got = torch.cat([bands.normalise(band, mean, inv, True) for _, band in cut(x, sizes)], -2)
    torch.testing.assert_close(got, cuda_norm.instance_norm_plain(x, relu=True),
                               rtol=0, atol=1e-5)


def test_corr_lookup_of_a_band_at_its_offset():
    """A band's fmap1 rows against the whole fmap2: the pyramid's slices
    are the frame's, and the lookup (with convc1) at the band's coordinates
    (its first row as offset) gives the frame's rows."""
    f1, f2 = randn(1, 32, 12, 10, seed=8), randn(1, 32, 12, 10, seed=9)
    flow = randn(1, 2, 12, 10, seed=10, scale=3.0)
    w, b = randn(256, 324, 1, 1, seed=11, scale=0.05), randn(256, seed=12, scale=0.1)
    ref = cuda_corr.lookup_plain(corr.build_corr_pyramid(f1, f2, 4),
                                 corr.coords_grid(1, 12, 10) + flow, w, b)
    got = []
    for a, band in cut(f1, [4, 5, 3]):
        rows = band.shape[-2]
        coords = corr.coords_grid(1, rows, 10, row0=a) + flow[..., a:a + rows, :]
        got.append(cuda_corr.lookup_plain(corr.build_corr_pyramid(band, f2, 4), coords, w, b))
    torch.testing.assert_close(torch.cat(got, -2), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("channels", [1, 8])
@pytest.mark.parametrize("moving", [True, False])
def test_banded_warp_under_the_whole_flows_gate(channels, moving):
    """Each band warps its rows of the whole source (the row offset, the
    frame's normalization) under the gate of the whole flow. The middle
    band's flow is all zero: under a gate of its own band it would pass its
    rows through where the frame warps them."""
    img = randn(2, channels, 20, 12, seed=13)
    flow = randn(2, 2, 20, 12, seed=14, scale=2.5) * float(moving)
    flow[..., 6:14, :] = 0.0
    gate = torch.any(flow)
    ref = cuda_aug.warp_reflect(img, flow, -1.0, gate)
    got = torch.cat([cuda_aug.warp_reflect(img, fb, -1.0, gate, row0=a)
                     for a, fb in cut(flow, [6, 8, 6])], dim=-2)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)
    own = cuda_aug.warp_reflect(img, flow[..., 6:14, :], -1.0, torch.any(flow[..., 6:14, :]), 6)
    assert torch.equal(own, img[..., 6:14, :])
    assert moving == (not torch.equal(got[..., 6:14, :], img[..., 6:14, :]))


def resized(x, sizes_in, scale_in, scale_out, out_w, align_corners):
    """The bands' rows of a resize from 1/scale_in to 1/scale_out, each from
    its band and one row of each neighbour (as ``bands.resize``)."""
    in_h = x.shape[-2]
    out = []
    for a, band, top, bottom in halos(x, sizes_in, 1):
        first = a - (0 if top is None else top.shape[-2])
        b = a + band.shape[-2]
        rows = (a * scale_in // scale_out, b * scale_in // scale_out)
        out.append(bands.resize_rows(bands.widen(band, top, bottom), first, in_h,
                                     (in_h * scale_in // scale_out, out_w), rows, align_corners))
    return torch.cat(out, dim=-2)


def test_resizes_of_bands():
    """``upflow`` x8 and the code's x0.5 flow (align_corners=True), the
    decoder's x2 (align_corners=False), and E-RAFT's convex upsampling, each
    band's rows from one halo row of each neighbour."""
    coarse = randn(1, 2, 8, 12, seed=15, scale=2.0)
    # x8 flows of up to ~30 px: 1e-6 of them is below their ulp
    torch.testing.assert_close(resized(coarse, [3, 3, 2], 8, 1, 96, True) * 8.0,
                               resize.upflow(coarse, 8), rtol=1e-6, atol=1e-6)
    flow = randn(1, 2, 24, 16, seed=16, scale=2.0)
    torch.testing.assert_close(resized(flow, [8, 10, 6], 1, 2, 8, True),
                               resize.interpolate_scale(flow, 0.5, align_corners=True),
                               rtol=0, atol=1e-6)
    hidden = randn(2, 4, 12, 8, seed=17)
    torch.testing.assert_close(resized(hidden, [4, 5, 3], 2, 1, 16, False),
                               resize.resize_bilinear(hidden, (24, 16), align_corners=False),
                               rtol=0, atol=1e-6)
    mask = randn(1, 9 * 64, 8, 6, seed=18)
    small = coarse[..., :6]
    got = torch.cat([bands.convex_upsample_rows(band, top, bottom, mask[..., a:a + band.shape[-2], :], 8)
                     for a, band, top, bottom in halos(small, [3, 3, 2], 1)], dim=-2)
    torch.testing.assert_close(got, upsample.convex_upsample(small, mask, 8), rtol=0, atol=1e-6)


# ------------------------------- (a), (c): the ranks ---------------------------

def voxels(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((T, 5, h, w)).astype(np.float32) * 2.0
    return v * (rng.random((T, 5, h, w)) < 0.2)


def serve_job(mode: str, h: int, window: bool, gt: bool = False, half: bool = False) -> dict:
    cfg = Config(image_dim=(h, 96), model_mode=mode, depth=1,
                 flow_iters=2 if mode == "cista-idnet" else 1, flow_half=half,
                 path_to_test_model=str(ANCHORS[mode]))
    gts = (np.random.default_rng(2).standard_normal((T, 2, h, 96)).astype(np.float32) * 2.0
           if gt else None)
    return dict(kind="serve", cfg=cfg, voxels=voxels(1, h, 96), gt_flows=gts, window=window)


EXCHANGES = {2: [6, 9], 3: [5, 7, 4]}
CASES = {2: {"eiflow window": serve_job("cista-eiflow", 64, True),
             "eiflow followed": dict(serve_job("cista-eiflow", 64, True), follow=True),
             "eraft window": serve_job("cista-eraft", 64, True),
             "eraft steps": serve_job("cista-eraft", 64, False),
             "gtflow window": serve_job("cista-gtflow", 64, True, gt=True),
             "idnet window": serve_job("cista-idnet", 64, True),
             "idnet steps": serve_job("cista-idnet", 64, False),
             "flow_half window": serve_job("cista-eiflow", 96, True, half=True)},
         3: {"eiflow window": serve_job("cista-eiflow", 80, True),
             "idnet window": serve_job("cista-idnet", 80, True),
             "flow_half window": serve_job("cista-eiflow", 144, True, half=True)}}


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    """Every rank job, one spawned pool per rank count: {world: (the
    exchange's frame and results by rank, {case: rank 0's result})}."""
    out = {}
    for world, sizes in EXCHANGES.items():
        x = randn(2, 3, sum(sizes), 5, seed=19)
        jobs = [dict(kind="exchange", x=x, sizes=sizes, above=2, below=3),
                *CASES[world].values()]
        ranks = check.run(check.spatial_rank, world, "cpu", jobs,
                          str(tmp_path_factory.mktemp(f"spatial{world}")))
        out[world] = ((x, [r[0] for r in ranks]),
                      {name: [r[i + 1] for r in ranks] for i, name in enumerate(CASES[world])})
    return out


@pytest.mark.parametrize("world", [2, 3])
def test_halo_and_gather_rows_of_uneven_bands(pools, world):
    (x, results), _ = pools[world]
    sizes = EXCHANGES[world]
    for r, ((a, band), res) in enumerate(zip(cut(x, sizes), results)):
        b = a + band.shape[-2]
        assert (res["top"] is None) == (r == 0) and (res["bottom"] is None) == (r == world - 1)
        if r > 0:
            assert torch.equal(res["top"], x[..., a - 2:a, :])
        if r < world - 1:
            assert torch.equal(res["bottom"], x[..., b:b + 3, :])
        assert torch.equal(res["frame"], x) and res["max"] == 1


def one_process(job: dict):
    rec = Reconstructor(job["cfg"], device="cpu")
    return run_reconstructor(rec, job)


def run_reconstructor(rec, job: dict):
    gts = job["gt_flows"]
    if job["window"]:
        return rec.step_window(job["voxels"], gts, use_gt_flow=gts is not None, return_all=True)
    steps = [rec.step(v, None if gts is None else gts[t], use_gt_flow=gts is not None)
             for t, v in enumerate(job["voxels"])]
    return tuple(np.stack(o) for o in zip(*steps))


def jax_unsharded(job: dict, **mesh):
    cfg = job["cfg"]
    jr = JReconstructor(JConfig(image_dim=cfg.image_dim, model_mode=cfg.model_mode, depth=1,
                                flow_iters=cfg.flow_iters, flow_half=cfg.flow_half,
                                path_to_test_model=cfg.path_to_test_model, **mesh))
    gts = job["gt_flows"]
    if job["window"]:
        return jr.step_window(list(job["voxels"]), None if gts is None else list(gts),
                              use_gt_flow=gts is not None, return_all=True)
    return tuple(np.stack(o) for o in zip(*[jr.step(v) for v in job["voxels"]]))


def hold_against_jax(got, ref):
    recs, flows = got
    for t in range(T):
        np.testing.assert_allclose(recs[t], ref[0][t], rtol=1e-4, atol=1e-6)
        if t > 0:
            np.testing.assert_allclose(flows[t], ref[1][t], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("world,case", [(w, name) for w in CASES for name in CASES[w]])
def test_row_sharded_reconstructor(pools, world, case):
    """N ranks of ``Reconstructor(mesh=...)`` against the port's one
    process and the JAX package's unsharded runner, the other ranks making
    the same calls (returning None) or following rank 0's (``follow``,
    after its ``reset``, until its ``close``); bytes went through every
    kind of exchange but the norms' in the modes without instance norms
    (no flow net, IDNet), and no rank built an autograd graph."""
    job = CASES[world][case]
    ranks = pools[world][1][case]
    assert all(r["out"] is None for r in ranks[1:])
    recs, flows = ranks[0]["out"]
    h = job["cfg"].image_dim[0]
    assert recs.shape == (T, h, 96) and flows.shape == (T, 2, h, 96)
    one = one_process(job)
    np.testing.assert_allclose(recs, one[0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(flows, one[1], rtol=0, atol=1e-4)
    hold_against_jax((recs, flows), jax_unsharded(job))
    for r in ranks:
        assert r["sent"]["halo"] > 0 and r["sent"]["gather"] > 0
        assert (r["sent"]["stats"] > 0) == (job["cfg"].model_mode
                                            not in ("cista-gtflow", "cista-idnet"))
        assert not r["graph"]           # the ranks step without autograd, followers too


@pytest.mark.slow
def test_against_the_jax_sharded_runner(pools):
    """The JAX runner's own spatial mesh (2 virtual CPU devices) on the JAX
    test's case, cista-eraft stepping 64x96, at its tolerances."""
    job = CASES[2]["eraft steps"]
    hold_against_jax(pools[2][1]["eraft steps"][0]["out"],
                     jax_unsharded(job, mesh_shape="2", mesh_axes="spatial"))


# ------------------------------- (d) the CLIs ----------------------------------

@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    path = tmp_path_factory.mktemp("spatial_cli") / "stream.txt"
    write_stream(path, sim.simulate_sequence(31, 8, 48, 64)["events"], header=True)
    return path


def test_noeval_on_two_ranks_writes_one_process_files(stream, tmp_path):
    """``test_noeval`` on two gloo ranks (rank 0 reads and writes) against
    one process: the same files; frames within one grey level, flow
    pictures within 9 levels and equal on 90% of pixels
    (tests/test_torch_cli.py's rule for pictures of f32-close flows)."""
    flags = ["--model_mode", "cista-eiflow", "--image_dim", "48", "64", "-d", "1",
             "--flow_iters", "1", "--path_to_test_model", str(ANCHORS["cista-eiflow"]),
             "--path_to_test_data", str(stream), "--num_events", "800", "--test_img_num", "11",
             "--is_write_flow", "--device", "cpu"]
    for name, extra in (("one", []), ("two", ["--mesh_shape", "2", "--mesh_axes", "spatial"])):
        assert test_noeval.main(flags + ["-o", str(tmp_path / name)] + extra) == 0
    files = {p.relative_to(tmp_path / "one") for p in (tmp_path / "one").rglob("*.png")}
    assert files == {p.relative_to(tmp_path / "two") for p in (tmp_path / "two").rglob("*.png")}
    assert len(files) == 8              # steps 0, 1, 5 and 10: a frame and a flow picture each
    for rel in files:
        a = cv2.imread(str(tmp_path / "one" / rel), cv2.IMREAD_UNCHANGED).astype(int)
        b = cv2.imread(str(tmp_path / "two" / rel), cv2.IMREAD_UNCHANGED).astype(int)
        d = np.abs(a - b)
        if "flow" in str(rel):
            assert d.max() <= 9 and (d.reshape(*d.shape[:2], -1).max(-1) == 0).mean() >= 0.9
        else:
            assert d.max() <= 1, rel


@pytest.mark.parametrize("flags,message", [
    (["--flow_half", "--model_mode", "cista-eiflow", "--mesh_shape", "4", "--mesh_axes",
      "spatial"], "at most 3 ranks for this frame"),
    (["--mesh_shape", "2"], "replicates the stream"),
    (["--mesh_shape", "2,2", "--mesh_axes", "data,spatial"], "replicates the stream"),
    (["--model_mode", "cista-eiflow", "--mesh_shape", "8", "--mesh_axes", "spatial"],
     "at most 7 ranks for this frame")])
def test_serving_cli_refusals(capsys, flags, message):
    """A data axis refuses (the JAX runner replicates the stream there);
    too many ranks for the frame refuse, naming the most it allows (180x240
    at depth 5: 7; under ``--flow_half`` 3, the half frame's)."""
    with pytest.raises(SystemExit):
        test_noeval.main(flags + ["--device", "cpu"])
    assert message in capsys.readouterr().err
