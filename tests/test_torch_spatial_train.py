"""Row-sharded training (``make_train_step(mesh=Grid, spatial_axis='spatial')``,
``train --mesh_axes spatial`` and ``data,spatial``) on the CPU.

Ranks are gloo processes on 127.0.0.1 (``parallel.mesh.launch``; their
function is ``parallel.check.spatial_train_rank``), one spawned pool per
rank count, ``OMP_NUM_THREADS=1`` in each:

* the backward of the exchanges (``spatial.halo``, ``gather_rows``,
  ``all_gather`` and the instance norm of the bands' combined statistics)
  on 2 and 3 ranks against autograd of one process, in f64;
* one train step on a ``1,2`` mesh at 48x64 (cista-eiflow in phase 2, in
  phase 3's flow half and with remat there; cista-eraft's and
  cista-idnet's phase 1, the flow net training; cista-gtflow) and on a
  ``2,2`` mesh (phase 3's flow half, 4 ranks, one sequence a data slice),
  against the port's one process on the global batch by ``check_step``,
  every rank bit for bit the same; the bands' gradients summed once: a
  replicated loss behind the gathers' summing backward would double them
  and fail every leaf;
* the ``1,2`` ranks' step against the JAX package's unsharded
  ``make_train_step`` (phase 2) at tests/test_torch_train_step.py's
  tolerances, and (slow) against its ``make_train_step(spatial_axis=
  'spatial')`` over a ``(1, 2)`` mesh of conftest's virtual CPU devices;
* ``python -m cista_flow_torch.train --device cpu --mesh_shape 1,2
  --mesh_axes data,spatial``: one epoch against one process, and the exact
  resume on the mesh bit for bit a straight run; the refusals.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cista_flow_tpu import parallel as JP
from cista_flow_tpu.configs import Config as JConfig
from cista_flow_torch import ckpt, train, weights
from cista_flow_torch.config import Config
from cista_flow_torch.data.sim import write_train_dataset
from cista_flow_torch.ops import cuda_norm
from cista_flow_torch.parallel import check
from cista_flow_torch.parallel import train_step as TS
from test_torch_parallel import H, W, _adam_fed, _mode_case, _one_process, _start, _train
from test_torch_train_step import (PHASES, SMALL, _capturing, _port, _port_grads_as_jax,  # noqa: F401
                                   check_step, grads_of, np_tree, seq, small, state_of)

KEYS = ["event_voxel", "gt_img0", "gt_img1", "gt_flow"]


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


# ------------------------------- the jobs -------------------------------------

EXCHANGES = {2: [8, 9], 3: [5, 7, 5]}
EIFLOW = {"eiflow phase2": ("phase2", False), "eiflow phase3 flow half": ("phase3_flow_half", False),
          "eiflow phase3 flow half remat": ("phase3_flow_half", True)}
MODES = {"eraft": "cista-eraft", "idnet": "cista-idnet", "gtflow": "cista-gtflow"}
GRID_CASES = {(1, 2): [*EIFLOW, *MODES], (2, 2): ["eiflow phase3 flow half"]}


def exchange_frame(world: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(world)
    return torch.randn(2, 3, sum(EXCHANGES[world]), 5, generator=g, dtype=torch.float64)


def _eiflow_job(small, seq, case):
    _, _, params, mstate = small
    phase, remat = EIFLOW[case]
    fix, mode, gt_flow, _ = PHASES[phase]
    return dict(cfg=Config(**SMALL), weights=weights.from_jax(np_tree(params), np_tree(mstate)),
                seq={k: torch.from_numpy(seq[k]) for k in KEYS}, fix=fix, loss_mode=mode,
                use_gt_flow=gt_flow, remat=remat)


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """``_mode_case`` of each other mode: (cfg, weights' path, fix, loss
    mode, use_gt_flow, global batch)."""
    return {name: _mode_case(tmp_path_factory, mode) for name, mode in MODES.items()}


def _job(small, seq, modes, grid, case):
    if case in EIFLOW:
        job = _eiflow_job(small, seq, case)
    else:
        cfg, path, fix, mode, gt, batch = modes[case]
        job = dict(cfg=cfg, weights=path, seq=batch, fix=fix, loss_mode=mode, use_gt_flow=gt)
    return dict(job, kind="step", grid=grid)


@pytest.fixture(scope="module")
def pools(small, seq, modes, tmp_path_factory):
    """Every rank job, one spawned pool per rank count: {job's key: its
    results by rank}; 2 ranks take the exchanges and the ``1,2`` steps, 3
    the exchanges, 4 the ``2,2`` step."""
    jobs = {w: {("exchange", w): dict(kind="exchange_grad", x=exchange_frame(w),
                                      sizes=EXCHANGES[w], above=2, below=3)}
            for w in EXCHANGES}
    for grid, cases in GRID_CASES.items():
        for c in cases:
            jobs.setdefault(grid[0] * grid[1], {})[grid, c] = _job(small, seq, modes, grid, c)
    out = {}
    for w, js in jobs.items():
        ranks = check.run(check.spatial_train_rank, w, "cpu", list(js.values()),
                          str(tmp_path_factory.mktemp(f"spatial_train{w}")))
        out.update({key: [r[i] for r in ranks] for i, key in enumerate(js)})
    return out


# ------------------------------- the exchanges' backward ----------------------

@pytest.mark.parametrize("world", [2, 3])
def test_exchange_backward_matches_one_process(pools, world):
    """Each band's gradient of ``check.exchange_objective`` summed over the
    ranks (the halos go back to their owners, the gathered frame's and the
    stacked statistics' gradients are summed over the ranks, the combined
    instance-norm statistics carry theirs) against autograd of the same
    sum in one process, f64."""
    x = exchange_frame(world).requires_grad_()
    sizes = EXCHANGES[world]
    total, first = 0.0, 0
    bands = [x[..., sum(sizes[:r]):sum(sizes[:r + 1]), :] for r in range(world)]
    stats = torch.stack([b.square().sum(-2) for b in bands])
    normed = cuda_norm.instance_norm_plain(x)
    for r, band in enumerate(bands):
        a, b = first, first + sizes[r]
        top = x[..., a - 2:a, :] if r > 0 else None
        bottom = x[..., b:b + 3, :] if r < world - 1 else None
        total = total + check.exchange_objective(r, band, top, bottom, x, stats,
                                                 normed[..., a:b, :])
        first = b
    total.backward()
    got = torch.cat([res["grad"] for res in pools["exchange", world]], dim=-2)
    torch.testing.assert_close(got, x.grad, rtol=1e-10, atol=1e-10)


# ------------------------------- the train step --------------------------------

def _reference(small, seq, modes, case):
    """(fix, normed, one process's (loss, grads, state after), Adam fed a
    step's gradients, state before) of ``case``."""
    if case in EIFLOW:
        phase = EIFLOW[case][0]
        fix = PHASES[phase][0]
        _, cfg, params, mstate = small
        return (fix, True, _one_process(small, seq, phase)[:3],
                lambda grads: _adam_fed(small, fix, grads),
                state_of(_port(cfg, params, mstate)))
    cfg, path, fix, mode, gt, batch = modes[case]

    def load():
        model = train.composite.init(cfg, device="cpu")
        model.load_reference_state(weights.load_state_dict(path))
        return model
    model = load()
    before = state_of(model)
    loss = TS.make_train_step(cfg, TS.make_optimizer(model, 1e-4), mode, fix, gt)(model, batch)

    def fed(grads):
        m = load()
        TS.freeze(m, fix)
        for k, p in m.named_parameters():
            p.grad = grads.get(k)
        TS.optimizer_step(m, TS.make_optimizer(m, 1e-4))
        return state_of(m)
    return (fix, cfg.model_mode != "cista-idnet", (float(loss), grads_of(model), state_of(model)),
            fed, before)


def check_ranks(ranks, fix, normed, ref, fed, before):
    """Every rank the same loss and state; rank 0's step against ``ref`` by
    ``check_step``; every rank's exchanges sent bytes, forward and back."""
    r0 = ranks[0]
    assert all(r["losses"] == r0["losses"] and r["digest"] == r0["digest"] for r in ranks)
    assert all(r["sent"]["halo"] > 0 and r["sent"]["halo_grad"] > 0
               and r["sent"]["gather_grad"] > 0 for r in ranks)
    grads = {k: None for k in ref[1]}
    grads.update({k: g.numpy() for k, g in r0["grads"].items()})
    check_step(fix, r0["losses"][0], ref[0], grads, ref[1],
               {k: v.numpy() for k, v in r0["state"].items()}, ref[2], fed(r0["grads"]), before,
               normed=normed)


@pytest.mark.parametrize("grid,case", [(g, c) for g, cases in GRID_CASES.items() for c in cases])
def test_spatial_step_matches_one_process(small, seq, modes, pools, grid, case):
    """One train step on the bands of a (data, spatial) mesh against the
    port's one process on the global batch: the loss to 1e-5 relative,
    every gradient leaf, the parameters after Adam, BatchNorm's running
    statistics (cnet's, over every rank's rows and batch) and the frozen
    subnet by ``check_step``, at the tolerances two data-parallel ranks are
    held to (tests/test_torch_parallel.py)."""
    fix, normed, ref, fed, before = _reference(small, seq, modes, case)
    check_ranks(pools[grid, case], fix, normed, ref, fed, before)


def _jax_step(small, seq, phase, **mesh_kw):
    """JAX's ``make_train_step`` on ``small`` and ``seq``: (loss, grads,
    params after, model state after, Adam of the params fed ``grads``)."""
    jcfg, _, params, mstate = small
    fix, mode, gt_flow, _ = PHASES[phase]
    jopt = _capturing(JP.make_optimizer(1e-4))
    batch = {k: jnp.asarray(np.moveaxis(seq[k], 2, -1)) for k in KEYS}
    if "mesh" in mesh_kw:
        mesh = mesh_kw["mesh"]
        params_in, mstate_in = JP.replicate_tree(params, mesh), JP.replicate_tree(mstate, mesh)
        opt_in = JP.replicate_tree(jopt.init(params), mesh)
        batch = JP.shard_seq_batch(batch, mesh, spatial_axis="spatial")
    else:
        params_in, mstate_in, opt_in = params, mstate, jopt.init(params)
    jstep = JP.make_train_step(jcfg, jopt, mode, fix, gt_flow, donate=False, **mesh_kw)
    jparams, jmstate, (_, jgrads), jloss = jstep(params_in, mstate_in, opt_in, batch)
    return float(jloss), jgrads, jparams, jmstate


def _hold_against_jax(small, ranks, phase, jax_out):
    _, cfg, params, mstate = small
    fix = PHASES[phase][0]
    jloss, jgrads, jparams, jmstate = jax_out
    model = _port(cfg, params, mstate)
    for k, p in model.named_parameters():
        p.grad = ranks[0]["grads"].get(k)
    adam = JP.make_optimizer(1e-4)
    jadam = weights.from_jax(np_tree(optax.apply_updates(params, adam.update(
        _port_grads_as_jax(model, params), adam.init(params), params)[0])), np_tree(mstate))
    grads = {k: None for k, _ in model.named_parameters()}
    grads.update({k: g.numpy() for k, g in ranks[0]["grads"].items()})
    check_step(fix, ranks[0]["losses"][0], jloss, grads,
               weights.from_jax(np_tree(jgrads), np_tree(mstate)),
               {k: v.numpy() for k, v in ranks[0]["state"].items()},
               weights.from_jax(np_tree(jparams), np_tree(jmstate)), jadam,
               state_of(_port(cfg, params, mstate)))


def test_spatial_step_matches_jax(small, seq, pools):
    """The ``1,2`` ranks' phase-2 step against the JAX package's unsharded
    ``make_train_step`` on the same parameters and batch, by ``check_step``
    (tests/test_torch_train_step.py's tolerances)."""
    _hold_against_jax(small, pools[(1, 2), "eiflow phase2"], "phase2",
                      _jax_step(small, seq, "phase2"))


@pytest.mark.slow
def test_spatial_step_matches_jax_spatial_mesh(small, seq, pools):
    """The same against JAX's own row-sharded step,
    ``make_train_step(mesh=make_mesh((1, 2), ('data', 'spatial')),
    spatial_axis='spatial')`` on ``shard_seq_batch(spatial_axis=)``. Slow:
    the mesh step's compile."""
    mesh = JP.make_mesh((1, 2), ("data", "spatial"))
    _hold_against_jax(small, pools[(1, 2), "eiflow phase2"], "phase2",
                      _jax_step(small, seq, "phase2", mesh=mesh, spatial_axis="spatial"))


# ------------------------------- the CLI ---------------------------------------

MESH = ["--mesh_shape", "1,2", "--mesh_axes", "data,spatial"]
# one sequence, one optimizer step an epoch: the CLI shuffles from its seed
# at every epoch, and a resume starts that stream anew
FLAGS = ["--flow_epoch", "1", "--rec_epoch", "1", "--batch_size", "1"]


def test_train_cli_on_the_spatial_mesh(tmp_path, capfd):
    """``train --mesh_shape 1,2 --mesh_axes data,spatial``: two ranks on the
    rows of every frame against one process, one epoch of phase 1 from
    ``_start`` (the printed loss, the full state's weights, BatchNorm
    statistics and Adam moments by ``check_step``); rank 0 alone writes.
    Then the exact resume on the mesh: from the first epoch's full state to
    the second (phase 2), bit for bit a straight two-epoch run on the mesh.
    One sequence of 3 steps: the loader's shuffle, which a resume restarts
    from its seed, has nothing to reorder."""
    import re
    data = tmp_path / "data"
    write_train_dataset(str(data), 1, 4, H, W, seed=1)
    start = tmp_path / "start.pth.tar"
    _start(start)
    name = "cista-eiflow_b5_d2_c16"
    first = ["--path_to_e2vflow", str(start)]
    losses, runs = {}, {}
    for run, extra in (("one", []), ("mesh", MESH + ["--epochs", "2"])):
        assert _train(data, tmp_path / run, *first, *FLAGS, *extra) == 0
        out = capfd.readouterr().out
        losses[run] = float(re.search(r"loss: (\S+)", out).group(1))
        runs[run] = torch.load(tmp_path / run / name / "full_state" / "1.pt", weights_only=True)
    assert sorted(os.listdir(tmp_path / "mesh" / name)) == [
        f"{name}_1.pth.tar", f"{name}_2.pth.tar", "full_state"]

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
        g = grads(runs["mesh"])[k]
        p.grad = None if g is None else torch.from_numpy(g)
    TS.optimizer_step(fed, TS.make_optimizer(fed, 1e-4))
    check_step("rec", losses["mesh"], losses["one"], grads(runs["mesh"]), grads(runs["one"]),
               {k: v.numpy() for k, v in runs["mesh"]["model"].items()},
               {k: v.numpy() for k, v in runs["one"]["model"].items()}, state_of(fed),
               state_of(load()))

    resumed = tmp_path / "resumed"
    shutil.copytree(tmp_path / "mesh", resumed)
    os.remove(resumed / name / f"{name}_2.pth.tar")
    os.remove(resumed / name / "full_state" / "2.pt")
    assert ckpt.steps(str(resumed / name / "full_state")) == [1]
    assert _train(data, resumed, *FLAGS, *MESH, "--epochs", "2",
                  "--load_epoch_for_train", "-1") == 0
    assert "Resumed exactly" in capfd.readouterr().out
    a = torch.load(resumed / name / "full_state" / "2.pt", weights_only=True)
    b = torch.load(tmp_path / "mesh" / name / "full_state" / "2.pt", weights_only=True)
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for i, st in b["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(a["optimizer"]["state"][i][k], v), (i, k)


@pytest.mark.parametrize("flags,message", [
    (["--mesh_axes", "spatial,data", "--mesh_shape", "2,2"], "data, spatial, or data,spatial"),
    (["--mesh_axes", "data,spatial", "--mesh_shape", "4"], "one rank count for each axis"),
    (["--mesh_axes", "spatial", "--mesh_shape", "8"], "at most 7 ranks for this frame")])
def test_train_cli_refuses_other_spatial_meshes(tmp_path, capsys, flags, message):
    """Axes in another order, a shape that does not name each axis's size,
    and more spatial ranks than the frame's bands allow (180x240 at depth
    5: 7) are refused with a message."""
    with pytest.raises(SystemExit):
        train.parse_args(["--path_to_train_data", str(tmp_path), *flags])
    assert message in capsys.readouterr().err
