"""The port's data-parallel training against one process and against the
JAX package's mesh, on the CPU: ranks are gloo processes on 127.0.0.1
(``parallel.mesh.launch``; their functions are ``parallel.check``'s).

* the loader's shard (``StackedSequenceLoader(process_index=,
  process_count=, local_index=, local_count=)``) against the JAX loader's
  host batches and ``shard_seq_batch``'s device split;
* BatchNorm with global statistics (``ops.conv.global_bn_stats``) on two
  ranks against one process on the concatenated batch and against JAX's
  ``batch_norm``;
* one train step on two ranks (local batch 1) against the port's one
  process on the global batch 2 at ``test_train_step_matches_jax``'s
  tolerances (``check_step``), with remat, and against JAX's
  ``make_train_step`` over a 2-device mesh;
* the CUDA-stream prefetcher's order on the CPU, the device guard of
  ``cuda_build.Kernel.call``, and ``python -m cista_flow_torch.train
  --device cpu --mesh_shape 2`` against one process, with its refusals.
"""
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cista_flow_tpu import parallel as JP
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_tpu.data import train_loader as JTL
from cista_flow_tpu.ops import conv as JC
from cista_flow_torch import ckpt, train, weights
from cista_flow_torch.config import Config
from cista_flow_torch.data import train_loader as TTL
from cista_flow_torch.data.prefetch import device_prefetch
from cista_flow_torch.data.sim import write_train_dataset
from cista_flow_torch.ops import conv as TC
from cista_flow_torch.ops import cuda_build
from cista_flow_torch.parallel import check
from cista_flow_torch.parallel import train_step as TS
from test_torch_train_step import (PHASES, SMALL, _port, check_step, grads_of, np_tree,  # noqa: F401
                                   seq, small, state_of)
from test_torch_surface import jax_native_library

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_thread_a_process():
    """One intra-op thread in this process and in every rank it spawns
    (``OMP_NUM_THREADS``, which a spawned process reads as it starts):
    beside the test runner's other workers, torch's thread pools otherwise
    stall one another, and a step that takes a second alone takes minutes."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = env


# ----------------------------- the loader's shard ---------------------------

LH, LW = 24, 32
VIDEOS = 9             # 9 chunks of 3 steps: every split below is uneven


@pytest.fixture(scope="module")
def shard_data(tmp_path_factory):
    idx = write_train_dataset(str(tmp_path_factory.mktemp("shard")), VIDEOS, 4, LH, LW, seed=2)
    kw = dict(image_dim=(LH, LW), model_mode="cista-eiflow",
              path_to_train_data=os.path.dirname(idx), len_sequence=3)
    return (JTL.TrainSequenceDataset(idx, JConfig(**kw)),
            TTL.TrainSequenceDataset(idx, Config(**kw)))


@pytest.mark.parametrize("hosts,cards", [(1, 2), (2, 1), (2, 2)])
def test_loader_shard_matches_jax(shard_data, hosts, cards):
    """Host h's batches are JAX's ``StackedSequenceLoader(process_index=h,
    process_count=hosts)``'s (the host batch is 2 x cards sequences), cut to
    the common batch count; rank (h, l) yields the slice of each that
    ``shard_seq_batch`` puts on the host's l-th device, and the ranks'
    slices in rank order are the hosts' batches in host order."""
    jds, tds = shard_data
    batch = 2 * cards
    mesh = JP.make_mesh((cards,), ("data",))
    n_batches = (VIDEOS // hosts) // batch
    for h in range(hosts):
        jb = list(JTL.StackedSequenceLoader(jds, batch, 3, seed=5, num_workers=0,
                                            process_index=h, process_count=hosts))
        ranks = [list(TTL.StackedSequenceLoader(tds, batch, 3, seed=5, num_workers=2,
                                                process_index=h, process_count=hosts,
                                                local_index=r, local_count=cards))
                 for r in range(cards)]
        assert [len(r) for r in ranks] == [len(jb)] * cards
        assert len(jb) == n_batches > 0
        for i, host_batch in enumerate(jb):
            sharded = JP.shard_seq_batch(host_batch, mesh)
            for k, v in host_batch.items():
                on_device = {s.device: np.asarray(s.data) for s in sharded[k].addressable_shards}
                for r, dev in enumerate(mesh.devices.flat):
                    mine = np.moveaxis(on_device[dev], -1, -3)     # f32 on the device
                    assert ranks[r][i][k].shape == mine.shape and mine.shape[1] == 2
                    np.testing.assert_array_equal(ranks[r][i][k].astype(mine.dtype), mine)
                np.testing.assert_array_equal(
                    np.concatenate([ranks[r][i][k] for r in range(cards)], axis=1),
                    np.moveaxis(v, -1, -3))


def test_loader_shard_cuts_and_refuses(shard_data):
    """Over 2 hosts the 9 chunks split 5 and 4, and both hosts keep the
    common count of 4 batches of 1 (a host with a fifth would wait on a
    collective); a host batch that does not split over the local ranks is
    refused, as JAX's sharding refuses it."""
    _, tds = shard_data
    loaders = [TTL.StackedSequenceLoader(tds, 1, 3, process_index=h, process_count=2)
               for h in range(2)]
    assert [len(ld.chunks) for ld in loaders] == [4, 4]
    assert [len(list(ld)) for ld in loaders] == [4, 4]
    assert loaders[0].chunks == TTL.StackedSequenceLoader(tds, 1, 3).chunks[0:8:2]
    with pytest.raises(ValueError, match="does not split"):
        TTL.StackedSequenceLoader(tds, 3, 3, local_index=0, local_count=2)


# ----------------------------- global BatchNorm -----------------------------

BN_SHAPE = (4, 6, 5, 7)         # (B, C, H, W), two samples a rank


def _bn_case(frozen: bool) -> dict:
    rng = np.random.default_rng(11)
    b, c, h, w = BN_SHAPE
    return {"x": (3.0 * rng.standard_normal(BN_SHAPE) + 1.0).astype(np.float32),
            "grad": rng.standard_normal(BN_SHAPE).astype(np.float32),
            "weight": (rng.random(c) + 0.5).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32),
            "running_mean": rng.standard_normal(c).astype(np.float32),
            "running_var": (rng.random(c) + 0.1).astype(np.float32), "frozen": frozen}


@pytest.fixture(scope="module")
def bn_ranks(tmp_path_factory):
    jobs = [_bn_case(False), _bn_case(True)]
    return jobs, check.run(check.batch_norm_rank, 2, "cpu", jobs,
                           str(tmp_path_factory.mktemp("bn")))


@pytest.mark.parametrize("frozen", [False, True])
def test_global_batch_norm_matches_one_process_and_jax(bn_ranks, frozen):
    """Two ranks of two samples each against one process on the four, and
    against JAX's ``batch_norm`` (train mode, whose statistics GSPMD takes
    over the global batch) with its gradients from ``jax.vjp``, at 1e-6:
    the output, the gradients to x, weight and bias (the ranks' shares
    summed), and the running statistics; inside ``frozen_bn_stats`` the
    same output and gradients, and the statistics left as they were."""
    jobs, ranks = bn_ranks
    job, got = jobs[frozen], [r[frozen] for r in ranks]
    x = torch.from_numpy(job["x"]).requires_grad_()
    bn = torch.nn.BatchNorm2d(BN_SHAPE[1]).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(job[name]))
    y = TC.batch_norm(x, bn)
    (y * torch.from_numpy(job["grad"])).sum().backward()

    nhwc = lambda a: jnp.asarray(np.moveaxis(a, 1, -1))  # noqa: E731
    p = {"scale": jnp.asarray(job["weight"]), "bias": jnp.asarray(job["bias"])}
    s = {"mean": jnp.asarray(job["running_mean"]), "var": jnp.asarray(job["running_var"])}
    (jy, js), vjp = jax.vjp(lambda p, x: JC.batch_norm(p, s, x, train=True), p, nhwc(job["x"]))
    jgp, jgx = vjp((nhwc(job["grad"]), jax.tree_util.tree_map(jnp.zeros_like, js)))

    def close(a, ref):
        np.testing.assert_allclose(a, ref, rtol=1e-6, atol=1e-6)
    glob = {"y": torch.cat([r["y"] for r in got]).numpy(),
            "x_grad": torch.cat([r["x_grad"] for r in got]).numpy(),
            "weight_grad": sum(r["weight_grad"] for r in got).numpy(),
            "bias_grad": sum(r["bias_grad"] for r in got).numpy()}
    for k, one in (("y", y.detach()), ("x_grad", x.grad), ("weight_grad", bn.weight.grad),
                   ("bias_grad", bn.bias.grad)):
        close(glob[k], one.numpy())
    for k, ref in (("y", jy), ("x_grad", jgx), ("weight_grad", jgp["scale"]),
                   ("bias_grad", jgp["bias"])):
        close(glob[k], np.moveaxis(np.asarray(ref), -1, 1) if ref.ndim == 4 else ref)
    for r in got:
        buf = r["buffers"]
        if frozen:
            np.testing.assert_array_equal(buf["running_mean"], job["running_mean"])
            np.testing.assert_array_equal(buf["running_var"], job["running_var"])
            assert int(buf["num_batches_tracked"]) == 0
        else:
            close(buf["running_mean"], bn.running_mean.numpy())
            close(buf["running_var"], bn.running_var.numpy())
            close(buf["running_mean"], js["mean"])
            close(buf["running_var"], js["var"])
            assert int(buf["num_batches_tracked"]) == 1


# ----------------------------- the train step -------------------------------

STEP_CASES = {"phase2": ("phase2", False), "phase3_flow_half": ("phase3_flow_half", False),
              "phase3_flow_half_remat": ("phase3_flow_half", True)}
KEYS = ["event_voxel", "gt_img0", "gt_img1", "gt_flow"]


def _step_job(small, seq, case):
    _, _, params, mstate = small
    phase, remat = STEP_CASES[case]
    fix, mode, gt_flow, _ = PHASES[phase]
    return {"cfg": Config(**SMALL), "weights": weights.from_jax(np_tree(params), np_tree(mstate)),
            "seq": {k: torch.from_numpy(seq[k]) for k in KEYS}, "fix": fix, "loss_mode": mode,
            "use_gt_flow": gt_flow, "remat": remat}


@pytest.fixture(scope="module")
def step_ranks(small, seq, tmp_path_factory):
    """Every case of ``STEP_CASES`` on two ranks, in one launch."""
    jobs = [_step_job(small, seq, c) for c in STEP_CASES]
    ranks = check.run(check.train_step_rank, 2, "cpu", jobs, str(tmp_path_factory.mktemp("dp")))
    return {c: [r[i] for r in ranks] for i, c in enumerate(STEP_CASES)}


def _one_process(small, seq, phase):
    """The port's step on one process over the global batch: its loss,
    gradients and state after, and the state before."""
    _, cfg, params, mstate = small
    fix, mode, gt_flow, _ = PHASES[phase]
    model = _port(cfg, params, mstate)
    before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    loss = TS.make_train_step(cfg, TS.make_optimizer(model, 1e-4), mode, fix, gt_flow)(
        model, {k: torch.from_numpy(seq[k]) for k in KEYS})
    return float(loss), grads_of(model), state_of(model), before


def _adam_fed(small, fix, grads) -> dict:
    """The port's optimizer step from the initial weights, fed ``grads``."""
    _, cfg, params, mstate = small
    model = _port(cfg, params, mstate)
    TS.freeze(model, fix)
    for k, p in model.named_parameters():
        p.grad = grads.get(k)
    TS.optimizer_step(model, TS.make_optimizer(model, 1e-4))
    return state_of(model)


def _check_ranks(small, ranks, fix, ref):
    """Both ranks hold the same loss and state; rank 0's step against
    ``ref`` = (loss, gradients, state after) by ``check_step``."""
    r0, r1 = ranks
    assert r0["losses"] == r1["losses"] and r0["digest"] == r1["digest"]
    grads = {k: None for k in ref[1]}
    grads.update({k: g.numpy() for k, g in r0["grads"].items()})
    _, _, params, mstate = small
    before = state_of(_port(small[1], params, mstate))
    check_step(fix, r0["losses"][0], ref[0], grads, ref[1],
               {k: v.numpy() for k, v in r0["state"].items()}, ref[2],
               _adam_fed(small, fix, r0["grads"]), before)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_data_parallel_step_matches_one_process(small, seq, step_ranks, case):
    """One train step on two ranks (local batch 1, global BatchNorm, the
    gradients and the loss averaged) against the port's one process on the
    global batch 2, in phase 2 and in phase 3's flow half (cnet's BatchNorm
    trains), and the second with ``remat`` on the ranks: the loss, every
    gradient leaf, the parameters after Adam (and against the port's Adam
    fed the ranks' gradients), the running statistics and the frozen
    subnet, by ``check_step``; both ranks bit for bit the same."""
    phase, _ = STEP_CASES[case]
    fix = PHASES[phase][0]
    _check_ranks(small, step_ranks[case], fix, _one_process(small, seq, phase)[:3])


MODES = ("cista-eraft", "cista-idnet", "cista-gtflow", "cista-lstc")
FLOW_ANCHORS = {"cista-eraft": "eraft_ft1_f16.npz", "cista-idnet": "idnet_ft2_f16.npz"}


def _mode_case(tmp_path_factory, mode):
    """(cfg, the path of its weights, fix, loss mode, use_gt_flow, global
    batch) of ``mode``'s first epoch, at 48x64, base width 16, depth 2, one
    flow iteration, T = 2, batch 2 from a tiny simulated set (cista-eraft's
    with the previous voxel). The weights: the seeded reconstructor and the
    anchor's trained flow net (a flow net at its random init puts
    near-dead channels into its norms, whose f32 gradients rounding
    decides; see tests/test_torch_train_step.py)."""
    root = tmp_path_factory.getbasetemp() / "modes"
    if not (root / "train_e2v_estflow.txt").exists():
        write_train_dataset(str(root), 2, 3, H, W, seed=4)
    cfg = Config(**{**SMALL, "model_mode": mode, "flow_iters": 1, "len_sequence": 2},
                 path_to_train_data=str(root))
    model = train.composite.init(cfg, device="cpu")
    if mode in FLOW_ANCHORS:
        sd = weights.load_state_dict(str(REPO / "gate" / FLOW_ANCHORS[mode]))
        model.event_flownet.load_state_dict(
            {k[len("event_flownet."):]: torch.tensor(v) for k, v in sd.items()
             if k.startswith("event_flownet.")}, strict=True)
    path = str(root / f"{mode}.pth.tar")
    weights.save_checkpoint(path, model, 0)
    fix, loss_mode, gt_flow, _ = train.phase_for_epoch(cfg, 0)
    loader = TTL.StackedSequenceLoader(TTL.TrainSequenceDataset(
        str(root / "train_e2v_estflow.txt"), cfg), 2, 2, shuffle=False, num_workers=0)
    batch = {k: torch.from_numpy(v).float() for k, v in next(iter(loader)).items()}
    return cfg, path, fix, loss_mode, gt_flow, batch


def test_data_parallel_step_every_mode(tmp_path_factory):
    """Every other mode the trainer trains, in its first epoch (phase 1 for
    cista-eraft and cista-idnet: the flow net trains, E-RAFT's cnet
    BatchNorm in train mode; the reconstructor on the GT flow for
    cista-gtflow and cista-lstc): one step on two ranks against one
    process on the global batch by ``check_step``."""
    cases = [_mode_case(tmp_path_factory, m) for m in MODES]
    jobs = [dict(cfg=cfg, weights=path, seq=batch, fix=fix, loss_mode=mode, use_gt_flow=gt)
            for cfg, path, fix, mode, gt, batch in cases]
    ranks = check.run(check.train_step_rank, 2, "cpu", jobs,
                      str(tmp_path_factory.mktemp("modes_dp")))

    def load(cfg, path):
        model = train.composite.init(cfg, device="cpu")
        model.load_reference_state(weights.load_state_dict(path))
        return model
    for i, (cfg, path, fix, mode, gt, batch) in enumerate(cases):
        model = load(cfg, path)
        before = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        loss = TS.make_train_step(cfg, TS.make_optimizer(model, 1e-4), mode, fix, gt)(
            model, batch)
        r0, r1 = ranks[0][i], ranks[1][i]
        assert r0["losses"] == r1["losses"] and r0["digest"] == r1["digest"]
        fed = load(cfg, path)
        TS.freeze(fed, fix)
        for k, p in fed.named_parameters():
            p.grad = r0["grads"].get(k)
        TS.optimizer_step(fed, TS.make_optimizer(fed, 1e-4))
        grads = {k: None for k in grads_of(model)}
        grads.update({k: g.numpy() for k, g in r0["grads"].items()})
        check_step(fix, r0["losses"][0], float(loss), grads, grads_of(model),
                   {k: v.numpy() for k, v in r0["state"].items()}, state_of(model),
                   state_of(fed), before, normed=cfg.model_mode != "cista-idnet")


@pytest.mark.slow
def test_data_parallel_step_matches_jax_mesh(small, seq, step_ranks):
    """The two ranks' step in phase 2 against JAX's
    ``make_train_step(..., mesh=make_mesh((2,), ('data',)))`` on
    ``shard_seq_batch``, by ``check_step``. Slow: the mesh step's compile
    alone takes most of a minute here. Phase 2, not phase 3's flow half:
    there JAX's own 2-device step parts from its 1-device step past the
    leaf limit at a few elements of ``update_block.flow_head.conv1.weight``,
    where the port's one process stays within it of JAX's 1-device step
    (``test_train_step_matches_jax``) and the two ranks of the one process
    (``test_data_parallel_step_matches_one_process``)."""
    from test_torch_train_step import _capturing, _port_grads_as_jax
    jcfg, cfg, params, mstate = small
    fix, mode, gt_flow, _ = PHASES["phase2"]
    mesh = JP.make_mesh((2,), ("data",))
    jopt = _capturing(JP.make_optimizer(1e-4))
    jstep = JP.make_train_step(jcfg, jopt, mode, fix, gt_flow, mesh=mesh, donate=False)
    jparams, jmstate, (_, jgrads), jloss = jstep(
        JP.replicate_tree(params, mesh), JP.replicate_tree(mstate, mesh),
        JP.replicate_tree(jopt.init(params), mesh),
        JP.shard_seq_batch({k: jnp.asarray(np.moveaxis(seq[k], 2, -1)) for k in KEYS}, mesh))
    ranks = step_ranks["phase2"]
    model = _port(cfg, params, mstate)
    for k, p in model.named_parameters():
        p.grad = ranks[0]["grads"].get(k)
    adam = JP.make_optimizer(1e-4)
    jadam = weights.from_jax(np_tree(optax.apply_updates(params, adam.update(
        _port_grads_as_jax(model, params), adam.init(params), params)[0])), np_tree(mstate))
    grads = {k: None for k, _ in model.named_parameters()}
    grads.update({k: g.numpy() for k, g in ranks[0]["grads"].items()})
    check_step(fix, ranks[0]["losses"][0], float(jloss), grads,
               weights.from_jax(np_tree(jgrads), np_tree(mstate)),
               {k: v.numpy() for k, v in ranks[0]["state"].items()},
               weights.from_jax(np_tree(jparams), np_tree(jmstate)), jadam,
               state_of(_port(cfg, params, mstate)))


# ----------------------------- the prefetcher -------------------------------

def _batches(n):
    rng = np.random.default_rng(n)
    return [{"a": rng.standard_normal((2, 3)).astype(np.float32),
             "b": rng.integers(0, 9, (4,)).astype(np.float64)} for _ in range(n)]


@pytest.mark.parametrize("size", [0, 1, 2])
def test_prefetch_yields_every_batch_in_order(size):
    """``size`` 0, 1 and 2 on the CPU: every batch once, in order, as f32
    tensors; an empty iterator yields nothing; ``size`` batches past the
    one handed out have been read."""
    src = _batches(5)
    read = []

    def reading():
        for b in src:
            read.append(b)
            yield b
    for i, got in enumerate(device_prefetch(reading(), size=size, device="cpu")):
        assert len(read) == min(i + 1 + size, len(src))
        assert sorted(got) == ["a", "b"]
        for k in got:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), src[i][k].astype(np.float32))
    assert i == len(src) - 1
    assert list(device_prefetch(iter([]), size=size)) == []


def test_prefetch_put():
    """A ``put`` callable makes what is yielded, in order."""
    src = _batches(3)
    got = list(device_prefetch(src, size=2, put=lambda b: {"n": torch.tensor(b["b"].sum())}))
    assert [float(g["n"]) for g in got] == [float(b["b"].sum()) for b in src]


@pytest.mark.cuda
def test_prefetch_copies_on_a_side_stream():
    """On the card: the batches in order, their copies on another stream
    than the consumer's, which waits for them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    src = _batches(4)
    for i, got in enumerate(device_prefetch(src, size=2, device="cuda")):
        assert got["a"].is_cuda
        np.testing.assert_array_equal(got["a"].cpu().numpy(), src[i]["a"])


# ----------------------------- the device guard -----------------------------

def test_kernel_call_runs_on_the_tensors_device(monkeypatch):
    """``Kernel.call`` enters ``torch.cuda.device`` with the tensors'
    device around the C call and reads that device's stream inside it (a
    stub library, no CUDA here); no wrapper enters a device or reads a
    stream itself, so the call is the one place."""
    events = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            events.append(("enter", self.device))

        def __exit__(self, *exc):
            events.append(("exit", self.device))

    class Lib:
        @staticmethod
        def cista_fn(*args):
            events.append(("call", args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(cuda_build, "stream_ptr",
                        lambda d: events.append(("stream", d)) or 4096)
    kernel = cuda_build.Kernel("warp.cu", {})
    kernel._lib = Lib()
    shared = cuda_build.SharedKernel(kernel)
    dev = torch.device("cuda", 1)
    kernel.launch("cista_fn", 7, None, device=dev)
    shared.launch("cista_fn", 8, device=dev)
    assert events == [("enter", dev), ("stream", dev), ("call", (7, None, 4096)), ("exit", dev),
                      ("enter", dev), ("stream", dev), ("call", (8, 4096)), ("exit", dev)]
    assert (kernel.launches, shared.launches) == (1, 1)
    for path in (REPO / "cista_flow_torch" / "ops").glob("cuda_*.py"):
        if path.name != "cuda_build.py":
            text = path.read_text()
            assert "torch.cuda.device(" not in text and "stream_ptr" not in text, path.name


# ----------------------------- the CLI --------------------------------------

H, W = SMALL["image_dim"]


def _train(data, out, *extra):
    """``python -m cista_flow_torch.train`` (its ``main``) on the tiny set:
    one epoch of phase 1 (the flow net trains, cnet's BatchNorm in train
    mode), a host batch of 2, with full-state saves."""
    return train.main(["--device", "cpu", "--model_mode", "cista-eiflow",
                       "--path_to_train_data", str(data), "--path_to_model", str(out),
                       "--image_dim", str(H), str(W), "-c", "16", "-d", "2",
                       "--flow_iters", "2", "-s", "3", "--batch_size", "2", "--orbax_ckpt",
                       *extra])


def _start(path):
    """The runs' start, as ``--path_to_e2vflow``: the seeded reconstructor
    with its output conv scaled by 300 and the committed anchor's flow net
    (the weights of ``test_torch_train_step``'s ``small`` and the reason
    there: at its init the reconstruction is flat, and a flow net at its
    init puts near-dead channels into its norms)."""
    model = train.composite.init(Config(**SMALL), device="cpu")
    with torch.no_grad():
        for p in model.cista_net.final_conv.parameters():
            p.mul_(300.0)
    sd = weights.load_state_dict(str(REPO / "gate" / "flagship_sim40_f16.npz"))
    model.event_flownet.load_state_dict(
        {k[len("event_flownet."):]: torch.tensor(v) for k, v in sd.items()
         if k.startswith("event_flownet.")}, strict=True)
    weights.save_checkpoint(str(path), model, 0)


def test_train_cli_mesh_matches_one_process(tmp_path, capfd):
    """``--device cpu --mesh_shape 2``: two ranks of one sequence each
    against one process on the same host batch of 2, one epoch of phase 1
    (the flow net trains, cnet's BatchNorm in train mode) from ``_start``.
    Rank 0 alone logs and writes (one ``.pth.tar``, one full state); the
    printed loss, and the full state's weights, BatchNorm statistics and
    Adam moments (``exp_avg`` is 0.1 of the gradient) against the one
    process's, by ``check_step``."""
    import re
    data = tmp_path / "data"
    write_train_dataset(str(data), 2, 4, H, W, seed=1)
    start = tmp_path / "start.pth.tar"
    _start(start)
    name = "cista-eiflow_b5_d2_c16"
    runs, losses = {}, {}
    for run, extra in (("one", []), ("two", ["--mesh_shape", "2"])):
        assert _train(data, tmp_path / run, "--path_to_e2vflow", str(start), *extra) == 0
        out = capfd.readouterr().out
        assert out.count("Train Epoch:") == 1 and out.count("saved ") == 1, out
        losses[run] = float(re.search(r"loss: (\S+)", out).group(1))
        root = tmp_path / run / name
        assert sorted(os.listdir(root)) == [f"{name}_1.pth.tar", "full_state"]
        assert ckpt.steps(str(root / "full_state")) == [1]
        runs[run] = torch.load(root / "full_state" / "1.pt", weights_only=True)

    def load():
        model = train.composite.init(Config(**SMALL), device="cpu")
        model.load_reference_state(weights.load_state_dict(str(start)))
        return model
    names = [k for k, _ in load().named_parameters()]

    def grads(state):
        g = dict.fromkeys(names)
        for i, st in state["optimizer"]["state"].items():
            g[names[i]] = (st["exp_avg"] / 0.1).numpy()
        return g
    fed = load()
    TS.freeze(fed, "rec")
    for k, p in fed.named_parameters():
        g = grads(runs["two"])[k]
        p.grad = None if g is None else torch.from_numpy(g)
    TS.optimizer_step(fed, TS.make_optimizer(fed, 1e-4))
    check_step("rec", losses["two"], losses["one"], grads(runs["two"]), grads(runs["one"]),
               {k: v.numpy() for k, v in runs["two"]["model"].items()},
               {k: v.numpy() for k, v in runs["one"]["model"].items()}, state_of(fed),
               state_of(load()))


@pytest.mark.parametrize("flags,message", [
    (["--mesh_shape", "2,2"], "one rank count for each axis"),
    (["--distributed", "--device", "cpu"], "--mesh_shape N")])
def test_train_cli_refuses_other_meshes(tmp_path, capsys, flags, message):
    """Two rank counts for the one data axis, and ``--distributed`` on the
    CPU without a rank count are refused with a message (the spatial
    meshes, tests/test_torch_spatial_train.py); the serving CLIs take both
    mesh flags (a spatial axis, tests/test_torch_spatial.py) and refuse
    the other TPU-only flags (``config.TPU_ONLY_FLAGS``,
    tests/test_torch_cli.py)."""
    with pytest.raises(SystemExit):
        train.parse_args(["--path_to_train_data", str(tmp_path), *flags])
    assert message in capsys.readouterr().err
    from cista_flow_torch import config
    assert not set(config.MESH_FLAGS) & set(config.TPU_ONLY_FLAGS)


@pytest.fixture(autouse=True, scope="module")
def jax_native():
    """The JAX package's native event library loaded (its default path,
    which the port's voxels must equal bit for bit)."""
    jax_native_library()
