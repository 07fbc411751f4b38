"""Data-parallel runs held against one process: the functions each rank of
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
        out = {"losses": [], "launches": [], "ms": []}
        cuda = mesh.device.type == "cuda"
        for i in range(job.get("steps", 1)):
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
        if cuda and job.get("timed"):
            out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
            out["busy"] = _busy_share(step, model, seq, sum(out["ms"]) / len(out["ms"]))
        results.append(out)
    _save(mesh, out_dir, results)


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
