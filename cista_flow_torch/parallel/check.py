"""Data-parallel training, row-sharded serving (the MVSEC eval too) and
row-sharded training held against one process:
the functions each rank of
``mesh.launch`` runs for the tests and ``chip_smoke.py`` (a spawned rank
imports its function by name, and spawn re-imports ``__main__``, so they
live in the package). Each rank writes what it computed to
``{out_dir}/rank{r}.pt``; ``run`` launches the ranks and reads the files
back in rank order.
"""
from __future__ import annotations

import contextlib
import hashlib
import os

import numpy as np
import torch

from . import mesh as data_mesh


def rank_slice(x: torch.Tensor, mesh: data_mesh.DataMesh, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of the global batch along ``dim``."""
    b = x.shape[dim] // mesh.world
    return x.narrow(dim, mesh.rank * b, b).contiguous()


def run(fn, world: int, device, jobs: list, out_dir: str, backend: str | None = None) -> list:
    """``fn(mesh, jobs, out_dir)`` on ``world`` ranks; each rank's results
    as it saved them, in rank order."""
    os.makedirs(out_dir, exist_ok=True)
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pt")
        if os.path.exists(path):
            os.remove(path)
    data_mesh.launch(fn, world, device, jobs, out_dir, backend=backend)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _save(mesh, out_dir: str, results: list) -> None:
    torch.save(results, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def batch_norm_rank(mesh: data_mesh.DataMesh, jobs: list, out_dir: str) -> None:
    """Per job (dict: ``x`` and ``grad`` the global (B, C, H, W) input and
    the gradient of the output, ``weight``, ``bias``, ``running_mean``,
    ``running_var``, ``frozen``): ``ops.conv.batch_norm`` in train mode on
    this rank's slice under ``global_bn_stats`` (inside
    ``frozen_bn_stats`` with ``frozen``), and the backward of
    sum(output * grad). Saves the output slice, the gradient of the input
    slice, this rank's share of the weight's and bias's gradients, and the
    module's buffers."""
    from ..ops.conv import batch_norm, frozen_bn_stats, global_bn_stats
    results = []
    for job in jobs:
        x = rank_slice(torch.as_tensor(job["x"]), mesh, 0).to(mesh.device).requires_grad_()
        g = rank_slice(torch.as_tensor(job["grad"]), mesh, 0).to(mesh.device)
        bn = torch.nn.BatchNorm2d(x.shape[1]).to(mesh.device).train()
        with torch.no_grad():
            for name in ("weight", "bias", "running_mean", "running_var"):
                getattr(bn, name).copy_(torch.as_tensor(job[name]))
        frozen = frozen_bn_stats() if job["frozen"] else contextlib.nullcontext()
        with global_bn_stats(data_mesh.all_reduce_sum), frozen:
            y = batch_norm(x, bn)
            (y * g).sum().backward()
        results.append({"y": y.detach().cpu(), "x_grad": x.grad.cpu(),
                        "weight_grad": bn.weight.grad.cpu(), "bias_grad": bn.bias.grad.cpu(),
                        "buffers": {k: v.cpu() for k, v in bn.named_buffers()}})
    _save(mesh, out_dir, results)


def _model(cfg, job, device):
    """The job's composite: from ``weights`` (None: the seeded init)."""
    from .. import weights
    from ..models import composite
    model = composite.init(cfg, device="cpu")
    state = job["weights"]
    if state is not None:
        model.load_reference_state(weights.load_state_dict(state) if isinstance(state, str)
                                   else state)
    return model.to(device)


def train_step_rank(mesh: data_mesh.DataMesh, jobs: list, out_dir: str) -> None:
    """Per job (dict: ``cfg``, ``weights`` (a reference-layout state dict,
    the path of one, or None for ``cfg``'s seeded init), ``seq`` (the global batch, a dict of (T, B, C, H,
    W) tensors, or the path of a ``torch.save`` of one), ``fix``,
    ``loss_mode``, ``use_gt_flow``, optional ``remat``, ``steps``
    (default 1), ``timed``): ``steps`` data-parallel train steps on this
    rank's slice of the batch. Saves per job the losses, a digest of the
    state dict after the first step (rank 0 also the state dict and the f32
    gradients), the launches of each step, and with ``timed`` (on the card)
    the device ms of each step but the first, the busy share of a traced
    step and the peak memory."""
    from ..ops.cuda_build import kernel_counters
    from .train_step import make_optimizer, make_train_step
    counters = kernel_counters()
    results = []
    for job in jobs:
        cfg = job["cfg"]
        seq = job["seq"]
        if isinstance(seq, str):
            seq = torch.load(seq, weights_only=True)
        seq = {k: rank_slice(v, mesh, 1).to(mesh.device) for k, v in seq.items()}
        model = _model(cfg, job, mesh.device)
        data_mesh.replicate_(model)
        opt = make_optimizer(model, 1e-4)
        step = make_train_step(cfg, opt, job["loss_mode"], job["fix"], job["use_gt_flow"],
                               remat=job.get("remat", False), mesh=mesh)
        out = _run_steps(mesh, step, model, seq, job.get("steps", 1), counters)
        if mesh.device.type == "cuda" and job.get("timed"):
            out["busy"] = _busy_share(step, model, seq, sum(out["ms"]) / len(out["ms"]))
        results.append(out)
    _save(mesh, out_dir, results)


def _run_steps(mesh, step, model, seq, steps: int, counters) -> dict:
    """``steps`` train steps: the losses and launches of each, a digest of
    the state dict after the first (rank 0 also the state dict and the f32
    gradients), and on the card the device ms of each step but the first
    and the peak memory of those."""
    out = {"losses": [], "launches": [], "ms": []}
    cuda = mesh.device.type == "cuda"
    for i in range(steps):
        if cuda:
            torch.cuda.synchronize(mesh.device)
            if i == 1:
                torch.cuda.reset_peak_memory_stats(mesh.device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
        for k in counters.values():
            k.launches = 0
        loss = step(model, seq)
        if cuda:
            stop.record()
            torch.cuda.synchronize(mesh.device)
            if i > 0:
                out["ms"].append(start.elapsed_time(stop))
        out["launches"].append({key: k.launches for key, k in counters.items()})
        out["losses"].append(float(loss))
        if i == 0:
            state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
            out["digest"] = _digest(state)
            if mesh.is_main:
                out["state"] = state
                out["grads"] = {n: p.grad.detach().float().cpu()
                                for n, p in model.named_parameters() if p.grad is not None}
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
    return out


def _timed_window(recon, vox, gts) -> dict:
    """Device ms per step of one more window (CUDA events, after the
    counted one), and the NCCL kernels' share of a traced window's device
    time."""
    dev = recon.device
    torch.cuda.synchronize(dev)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    recon.step_window(vox, gts, use_gt_flow=gts is not None, return_all=True)
    stop.record()
    torch.cuda.synchronize(dev)
    ms = start.elapsed_time(stop) / len(vox)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        recon.step_window(vox, gts, use_gt_flow=gts is not None, return_all=True)
        torch.cuda.synchronize(dev)
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.device_time_total for e in kernels)
    nccl = sum(e.device_time_total for e in kernels if "nccl" in e.key.lower())
    return {"ms": ms, "exchange_share": nccl / max(total, 1e-9)}


def _digest(state: dict) -> str:
    """A SHA-1 of every tensor's bytes, in the state dict's order."""
    h = hashlib.sha1()
    for v in state.values():
        h.update(v.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _busy_share(step, model, seq, ms: float) -> float:
    """The kernel time of a profiler trace of one step over ``ms``, the
    device time of an untraced step."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(model, seq)
        torch.cuda.synchronize()
    kernels = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return kernels / ms


# ----------------------------- row-sharded serving ---------------------------

def spatial_rank(mesh: data_mesh.DataMesh, jobs: list, out_dir: str) -> None:
    """Each job on this rank of a row-sharded run, by its ``kind``:

    * "exchange" (``x``, a whole frame (..., H, W); ``sizes``, the bands'
      rows; ``above``, ``below``): this rank's band of ``x``, its
      ``spatial.halo``, the frame back through ``spatial.gather_rows``, and
      the max over the ranks of a flag set on the last rank alone;
    * "serve" (``cfg``, ``voxels`` (T, bins, H, W), optional ``gt_flows``
      (T, 2, H, W), each an array or the path of a ``.npy``; ``window``: one
      ``step_window`` of the T, or T calls of ``step``; optional ``timed``,
      on the card; optional ``follow``: rank 0 resets, runs the window and
      closes while the others ``follow()`` it): a row-sharded
      ``Reconstructor`` on every rank, in lockstep unless ``follow``; rank 0
      keeps the frames and flows (T, H, W) and (T, 2, H, W), every rank
      its kernel launches, the bytes it sent, per kind, and whether its
      band's last frame carries an autograd graph.
      With ``timed`` the window runs twice more: once between CUDA events
      (``ms``, per step) and once under the profiler (``exchange_share``:
      the NCCL kernels' device time over the window's).
    Saves the results in job order."""
    from ..ops.cuda_build import kernel_counters
    from ..runner import Reconstructor
    from . import spatial
    rows = spatial.RowMesh.of(mesh)
    counters = kernel_counters()
    results = []
    for job in jobs:
        if job["kind"] == "exchange":
            x = torch.as_tensor(job["x"]).to(mesh.device)
            first = sum(job["sizes"][:mesh.rank])
            band = x[..., first:first + job["sizes"][mesh.rank], :].contiguous()
            top, bottom = spatial.halo(rows, band, job["above"], job["below"])
            flag = torch.tensor(int(mesh.rank == mesh.world - 1), device=mesh.device)
            results.append({
                "top": None if top is None else top.cpu(),
                "bottom": None if bottom is None else bottom.cpu(),
                "frame": spatial.gather_rows(rows, band, job["sizes"]).cpu(),
                "max": int(spatial.all_reduce(rows, flag, torch.distributed.ReduceOp.MAX))})
            continue
        recon = Reconstructor(job["cfg"], mesh=rows)
        vox, gts = (np.load(a) if isinstance(a, str) else a
                    for a in (job["voxels"], job.get("gt_flows")))
        use_gt = gts is not None
        for k in counters.values():
            k.launches = 0
        if job.get("follow"):
            out = None
            if mesh.is_main:
                recon.reset()
                out = recon.step_window(vox, gts, use_gt_flow=use_gt, return_all=True)
                recon.close()
            else:
                recon.follow()
        elif job["window"]:
            out = recon.step_window(vox, gts, use_gt_flow=use_gt, return_all=True)
        else:
            steps = [recon.step(v, None if gts is None else gts[t], use_gt_flow=use_gt)
                     for t, v in enumerate(vox)]
            out = None if steps[0] is None else tuple(np.stack(o) for o in zip(*steps))
        res = {"out": out, "launches": {k: c.launches for k, c in counters.items()},
               "sent": dict(recon.band.sent), "graph": recon.prev_image.requires_grad}
        if job.get("timed"):
            res.update(_timed_window(recon, vox, gts))
        if not job.get("follow"):
            recon.close()
        results.append(res)
    _save(mesh, out_dir, results)


def mvsec_rank(mesh: data_mesh.DataMesh, jobs: list, out_dir: str) -> None:
    """Per job (``cfg``): ``test_mvsec.evaluate`` as ``spatial.serve`` runs
    it for ``test_mvsec --mesh_shape N --mesh_axes spatial``: a row-sharded
    ``Reconstructor`` on every rank, rank 0 reading, scoring and writing,
    the others following it. Rank 0 keeps ``(rows, keys, mean)`` and the
    windows served, every rank its kernel launches and the bytes it sent,
    per kind. Saves the results in job order."""
    from .. import test_mvsec
    from ..ops.cuda_build import kernel_counters
    from ..runner import Reconstructor
    from ..timing import HostSplit
    from . import spatial
    counters = kernel_counters()
    results = []
    for job in jobs:
        recon = Reconstructor(job["cfg"], batch=1, mesh=spatial.RowMesh.of(mesh))
        for k in counters.values():
            k.launches = 0
        out, windows = None, None
        if mesh.is_main:
            split = HostSplit()
            try:
                out = test_mvsec.evaluate(job["cfg"], split=split, recon=recon)
            finally:
                recon.close()
            windows = split.windows
        else:
            recon.follow()
        results.append({"out": out, "windows": windows, "sent": dict(recon.band.sent),
                        "launches": {k: c.launches for k, c in counters.items()}})
    _save(mesh, out_dir, results)


# ----------------------------- row-sharded training --------------------------

def exchange_weights(rank: int, shapes: dict) -> dict:
    """The seeded weights of ``exchange_objective``'s terms on ``rank``."""
    g = torch.Generator().manual_seed(100 + rank)
    return {k: torch.randn(s, generator=g, dtype=torch.float64) for k, s in shapes.items()}


def exchange_objective(rank: int, band, top, bottom, frame, stats, normed) -> torch.Tensor:
    """Rank ``rank``'s share of a scalar that reads every output of its
    exchanges (the halos, the gathered frame, the stacked band sums, the
    band normalised by the combined statistics), each weighted by seeded
    noise: one process sums the shares over the ranks."""
    outs = {"top": top, "bottom": bottom, "frame": frame, "stats": stats, "normed": normed}
    outs = {k: v for k, v in outs.items() if v is not None}
    w = exchange_weights(rank, {k: v.shape for k, v in outs.items()})
    return sum((v * w[k].to(v.device)).sum() for k, v in outs.items())


def spatial_train_rank(mesh: data_mesh.DataMesh, jobs: list, out_dir: str) -> None:
    """Each job on this rank of a row-sharded training run, by its ``kind``:

    * "exchange_grad" (``x`` a whole f64 frame (B, C, H, W), ``sizes``,
      ``above``, ``below``): this rank's band of ``x`` through
      ``spatial.halo``, ``gather_rows``, ``all_gather`` of its row sums and
      the instance norm of its combined statistics, then the backward of
      ``exchange_objective``: the band's gradient;
    * "step" (``grid`` (D, S), and ``train_step_rank``'s keys): ``steps``
      (default 1) train steps of ``make_train_step(mesh=Grid,
      spatial_axis='spatial')`` on this rank's band of its data slice of
      the global batch; saves what ``train_step_rank`` saves and the bytes
      each kind of exchange sent per step.
    Saves the results in job order."""
    from ..ops import bands
    from ..ops.cuda_build import kernel_counters
    from ..ops.cuda_norm import band_instance_norm_stats
    from . import spatial
    from .train_step import make_optimizer, make_train_step
    counters = kernel_counters()
    results = []
    for job in jobs:
        if job["kind"] == "exchange_grad":
            rows = spatial.RowMesh.of(mesh)
            x = torch.as_tensor(job["x"]).to(mesh.device)
            first = sum(job["sizes"][:mesh.rank])
            band = x[..., first:first + job["sizes"][mesh.rank], :].clone().requires_grad_()
            top, bottom = spatial.halo(rows, band, job["above"], job["below"])
            frame = spatial.gather_rows(rows, band, job["sizes"])
            stats = spatial.all_gather(rows, band.square().sum(-2))
            st = bands.band_stats(*band_instance_norm_stats(band),
                                  band.shape[-2] * band.shape[-1], 1e-5)
            normed = bands.normalise(band, *bands.combine_stats(spatial.all_gather(rows, st),
                                                                1e-5), False)
            exchange_objective(mesh.rank, band, top, bottom, frame, stats, normed).backward()
            results.append({"grad": band.grad.cpu()})
            continue
        d, s = job["grid"]
        grid = data_mesh.make_grid(mesh, d, s)
        cfg = job["cfg"]
        seq = job["seq"]
        if isinstance(seq, str):
            seq = torch.load(seq, weights_only=True)
        b = next(iter(seq.values())).shape[1] // d
        seq = {k: v.narrow(1, grid.data_index * b, b).contiguous().to(mesh.device)
               for k, v in seq.items()}
        model = _model(cfg, job, mesh.device)
        data_mesh.replicate_(model)
        opt = make_optimizer(model, 1e-4)
        step = make_train_step(cfg, opt, job["loss_mode"], job["fix"], job["use_gt_flow"],
                               remat=job.get("remat", False), mesh=grid, spatial_axis="spatial")
        steps = job.get("steps", 1)
        out = _run_steps(mesh, step, model, seq, steps, counters)
        out["sent"] = {k: v / steps for k, v in step.band.sent.items()}
        results.append(out)
    _save(mesh, out_dir, results)
