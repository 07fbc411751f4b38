"""The BPTT train step and its optimizer, on one card or data-parallel.

Counterpart of cista_flow_tpu/parallel/train_step.py (ref: train.py:180-232):
* per sequence the state is reset and the first previous frame is zeros;
  each step's reconstruction feeds the next WITHOUT detach, so the gradient
  runs through the whole unroll;
* the loss is summed over the unroll, one optimizer step per sequence
  batch; the temporal-consistency term is on from step 2, and only for
  ``loss_mode == 'rec'``;
* the phase schedule freezes one subnet: its parameters get
  ``requires_grad_(False)``, so they, their Adam moments and step counts
  stay as they were (torch's semantics, which the JAX package rebuilds with
  per-subtree counts, ``_adam_per_subtree``);
* bf16 as the JAX package does it: f32 master parameters, cast to bf16 once
  per optimizer step for the forward and the backward of the whole unroll
  (``parameters_as``); losses and flows stay f32, and the BatchNorm running
  statistics stay f32 buffers. f32 runs with cuDNN's TF32
  off (``device.cudnn_fp32``);
* every mode trains: each gets its inputs at every step (``_step_inputs``);
  ``remat`` recomputes each step in the backward; ``lpips_params`` adds
  LPIPS to the reconstruction loss.

* with a ``mesh`` (``parallel/mesh.py``) each rank steps on its slice of
  the global batch: BatchNorm takes the global batch's statistics
  (``ops.conv.global_bn_stats``), the trained leaves' f32 gradients and
  the loss are averaged over the ranks in one bucket, and every rank takes
  the same Adam step, as the JAX package's step does over a mesh with the
  batch sharded on 'data'.

On the card every kernel of the step runs in forward (K1-K5), and each
kernel's gradient is autograd of its plain version (``ops/autograd.py``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ..device import DTYPES, cudnn_fp32
from ..losses.recon import flow_recon_loss
from ..models import composite
from ..ops.conv import frozen_bn_stats, global_bn_stats
from . import mesh as data_mesh

SUBNETS = {"rec": "cista_net", "flow": "event_flownet"}   # fix_net_name -> module


def make_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """torch.optim.Adam (the reference's; ref: train.py:92-95), one step
    count per parameter. ``foreach`` is asked for by name: the fused
    implementation updates the parameters without bumping their version
    counters, which the kernels' weight caches (``ops/conv_tile._cached``)
    watch."""
    return torch.optim.Adam(model.parameters(), lr=lr, foreach=True)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def step_lr(base_lr: float, epoch: int, step_size: int = 10, gamma: float = 0.9) -> float:
    """StepLR(10, 0.9) as a function of the epoch (ref: train.py:92-95)."""
    return base_lr * (gamma ** (epoch // step_size))


def freeze(model: torch.nn.Module, fix_net_name: str | None) -> None:
    """``requires_grad`` on for every parameter but the frozen subnet's
    (ref: e2v/e2v_model.py:116-133 ``fix_params``)."""
    for p in model.parameters():
        p.requires_grad_(True)
    if fix_net_name is not None:
        for p in getattr(model, SUBNETS[fix_net_name]).parameters():
            p.requires_grad_(False)


def fill_grads(model: torch.nn.Module) -> None:
    """A zero gradient for every trained parameter outside the loss: every
    parameter of the trained subnet then advances its moments and step
    count, as the JAX package's optimizer does; the frozen subnet (no
    ``requires_grad``, no gradient) is skipped."""
    for p in model.parameters():
        if p.requires_grad and p.grad is None:
            p.grad = torch.zeros_like(p)


def optimizer_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> None:
    """One optimizer step as the JAX package takes it (``fill_grads``)."""
    fill_grads(model)
    optimizer.step()


@contextlib.contextmanager
def parameters_as(model: torch.nn.Module, dtype: torch.dtype):
    """Inside the block every parameter of ``model`` reads as its cast to
    ``dtype``, made once (a tied parameter, such as the ISTA block
    registered ``depth`` times, once for all its names); the gradients flow
    back to the f32 masters through the casts. ``torch.func.functional_call``
    does not restore a module registered under several names."""
    if all(p.dtype == dtype for p in model.parameters()):
        yield
        return
    casts, swapped = {}, []
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None:
                if id(p) not in casts:
                    casts[id(p)] = p.to(dtype)
                swapped.append((mod, name, p))
    try:
        for mod, name, p in swapped:
            mod._parameters[name] = casts[id(p)]
        yield
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


def _step_inputs(cfg, seq: dict, s: int, dtype: torch.dtype, use_gt_flow: bool) -> dict:
    """The composite's keyword inputs at unroll step ``s``, as the JAX train
    step gives each mode its batch: the previous voxel for cista-eraft, the
    reversed voxel for cista-eiflow where the batch has one, the GT flow to
    the warps with ``use_gt_flow`` (cista-gtflow and cista-lstc train so),
    gt_img1 for DCEIFlow's pseudo-feature loss."""
    batch_gt = {"gt_img1": seq["gt_img1"][s]}
    if use_gt_flow:
        batch_gt["gt_flow"] = seq["gt_flow"][s]
    kw = {"batch_gt": batch_gt}
    if cfg.model_mode == "cista-eraft":
        kw["event_voxel_old"] = seq["event_voxel_old"][s].to(dtype)
    elif cfg.model_mode == "cista-eiflow":
        bw = seq.get("event_voxel_bw")
        kw["event_voxel_bw"] = None if bw is None else bw[s].to(dtype)
    return kw


def _remat_contexts():
    """The forward runs as it is; the recompute leaves BatchNorm's running
    statistics alone (they were updated once, in the forward)."""
    return contextlib.nullcontext(), frozen_bn_stats()


def unroll_loss(model, seq: dict, cfg, loss_mode: str, fix_net_name, use_gt_flow: bool,
                dtype: torch.dtype = torch.float32, lpips_params=None,
                remat: bool = False) -> torch.Tensor:
    """The summed loss of one (T, B, ...) sequence batch through the
    composite, stepped in ``dtype`` (the model's parameters read in it).
    With ``remat`` each unroll step runs under non-reentrant
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept (the JAX package's ``jax.checkpoint`` of the
    scan body), and the recompute does not update BatchNorm's statistics
    a second time. The backward must then run while the parameters read
    in ``dtype`` (inside ``parameters_as``)."""
    events = seq["event_voxel"]
    t_len, batch = events.shape[:2]
    state = composite.zero_state(batch, cfg, dtype, events.device)
    rec = torch.zeros((batch, 1, *events.shape[3:]), dtype=dtype, device=events.device)
    targets = [k for k in ("gt_img0", "gt_img1", "gt_flow", "gt_flow_bw") if k in seq]

    def step(s, rec, state):
        out, batch_flow, state = model(
            events[s].to(dtype), rec, state, collect_preds=True, fix_net_name=fix_net_name,
            **_step_inputs(cfg, seq, s, dtype, use_gt_flow))
        loss = flow_recon_loss(out, rec, batch_flow, {k: seq[k][s] for k in targets}, cfg,
                               loss_mode, lpips_params=lpips_params,
                               is_loss_consis=loss_mode == "rec" and s >= 2)
        return loss, out, state

    total = 0.0
    for s in range(t_len):
        if remat:
            loss, rec, state = checkpoint(step, s, rec, state, use_reentrant=False,
                                          context_fn=_remat_contexts)
        else:
            loss, rec, state = step(s, rec, state)
        total = total + loss
    return total


def make_train_step(cfg, optimizer: torch.optim.Optimizer, loss_mode: str,
                    fix_net_name: str | None, use_gt_flow: bool, lpips_params=None,
                    remat: bool = False, mesh=None):
    """The train step of one phase: ``step(model, seq) -> loss`` (a 0-dim f32
    tensor on the model's device). ``seq``: dict of (T, B, C, H, W) f32
    tensors on that device, event_voxel, gt_img0, gt_img1, gt_flow
    [+ event_voxel_old (cista-eraft) | event_voxel_bw, gt_flow_bw
    (cista-eiflow, bidirectional)]. The model is put in train mode, its
    frozen subnet's parameters stop requiring gradients, and the optimizer
    takes one step. ``lpips_params`` adds the perceptual term; ``remat``
    recomputes each unroll step in the backward (``unroll_loss``).

    ``mesh``: a ``DataMesh``; ``seq`` is then this rank's slice of the
    global batch (every rank's of one size), BatchNorm normalises with the
    global batch's statistics (in the forward and in remat's recompute),
    the trained leaves' gradients (the f32 masters', after the zero fill)
    are averaged over the ranks with the loss in one all-reduce, and the
    returned loss is the global batch's, still on the device."""
    dtype = DTYPES[cfg.dtype]

    def step(model: torch.nn.Module, seq: dict) -> torch.Tensor:
        model.train()
        freeze(model, fix_net_name)
        optimizer.zero_grad(set_to_none=True)
        device = next(model.parameters()).device
        precision = (cudnn_fp32() if dtype == torch.float32 and device.type == "cuda"
                     else contextlib.nullcontext())
        stats = (global_bn_stats(data_mesh.all_reduce_sum) if mesh is not None
                 else contextlib.nullcontext())
        with precision, stats:
            with parameters_as(model, dtype):            # one cast per optimizer step
                loss = unroll_loss(model, seq, cfg, loss_mode, fix_net_name, use_gt_flow,
                                   dtype, lpips_params, remat)
                loss.backward()
        loss = loss.detach()
        fill_grads(model)
        if mesh is not None:
            data_mesh.all_reduce_mean_([p.grad for p in model.parameters()
                                        if p.grad is not None] + [loss])
        optimizer.step()
        return loss

    return step
