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
  batch sharded on 'data';
* with a (data, spatial) ``Grid`` and ``spatial_axis='spatial'`` each rank
  of a data slice steps on its band of rows (``parallel/spatial.py``),
  as the JAX step constrains the activations to ``P('data', 'spatial')``:
  the model's exchanges are differentiable, BatchNorm's statistics are
  over every rank's rows and batch, and the loss is the whole frame's,
  computed on every band from the gathered outputs and whole targets
  (replicated: its backward is scaled by 1/S, else the gathers' summing
  backward would give each band its gradient S times). Each rank's
  parameter gradients are then its band's share; summed over every rank
  and divided by the data axis's size they are the global batch's.

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
from ..models.cista_lstc import zero_state as cista_zero_state
from ..ops import bands
from ..ops.conv import frozen_bn_stats, global_bn_stats
from . import mesh as data_mesh
from . import spatial

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


# the model's inputs a rank takes its band of; the loss's targets stay whole
BAND_INPUTS = ("event_voxel", "event_voxel_old", "event_voxel_bw", "gt_img1", "gt_flow")
# the flow outputs the sequence flow loss reads: flows at full resolution,
# DCEIFlow's feature maps at 1/cfg.ds, both of the padded frame
FLOW_PREDS = ("flow_preds", "flow_preds_bw")
FEATURES = ("fmap2_gt", "fmap2_pseudo", "fmap1_gt", "fmap1_pseudo")


def _gathered_flow(band, batch_flow: dict, cfg) -> dict:
    """The whole frame's flow outputs of a band's ``batch_flow``, those the
    flow loss reads."""
    out = {}
    for k in FLOW_PREDS + FEATURES:
        v = batch_flow.get(k)
        if v is None:
            continue
        scale = 1 if k in FLOW_PREDS else cfg.ds
        out[k] = ([band.gather_rows(t, scale, True) for t in v] if isinstance(v, list)
                  else band.gather_rows(v, scale, True))
    return out


def _remat_contexts():
    """The forward runs as it is; the recompute leaves BatchNorm's running
    statistics alone (they were updated once, in the forward)."""
    return contextlib.nullcontext(), frozen_bn_stats()


def unroll_loss(model, seq: dict, cfg, loss_mode: str, fix_net_name, use_gt_flow: bool,
                dtype: torch.dtype = torch.float32, lpips_params=None,
                remat: bool = False, band=None) -> torch.Tensor:
    """The summed loss of one (T, B, ...) sequence batch through the
    composite, stepped in ``dtype`` (the model's parameters read in it).
    With ``remat`` each unroll step runs under non-reentrant
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward instead of kept (the JAX package's ``jax.checkpoint`` of the
    scan body), and the recompute does not update BatchNorm's statistics
    a second time. The backward must then run while the parameters read
    in ``dtype`` (inside ``parameters_as``).

    ``band`` (a ``parallel.spatial.RowBand``, inside ``ops.bands.rows``):
    the model steps on the band's rows of the inputs of the whole-frame
    ``seq``, and the loss is the whole frame's, from the outputs gathered
    from the ranks."""
    inputs = seq if band is None else {k: band.take(v) if k in BAND_INPUTS else v
                                       for k, v in seq.items()}
    events = inputs["event_voxel"]
    t_len, batch = events.shape[:2]
    hw = events.shape[3:]
    state = cista_zero_state(batch, hw, cfg.base_channels, dtype, events.device)
    rec = torch.zeros((batch, 1, *hw), dtype=dtype, device=events.device)
    targets = [k for k in ("gt_img0", "gt_img1", "gt_flow", "gt_flow_bw") if k in seq]

    def step(s, rec, state):
        out, batch_flow, state = model(
            events[s].to(dtype), rec, state, collect_preds=True, fix_net_name=fix_net_name,
            **_step_inputs(cfg, inputs, s, dtype, use_gt_flow))
        frame, prev = out, rec
        if band is not None:
            if loss_mode != "flow":
                frame, prev = band.gather_rows(out), band.gather_rows(rec)
            if loss_mode != "rec":
                batch_flow = _gathered_flow(band, batch_flow, cfg)
        loss = flow_recon_loss(frame, prev, batch_flow, {k: seq[k][s] for k in targets}, cfg,
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
                    remat: bool = False, mesh=None, spatial_axis: str | None = None):
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
    returned loss is the global batch's, still on the device.

    ``mesh`` a ``parallel.mesh.Grid`` and ``spatial_axis='spatial'``: ``seq``
    is this rank's data slice, whole frames; the rank steps on its band of
    rows (``unroll_loss(band=)``), BatchNorm's statistics are over every
    rank, and the step's ``band`` attribute counts the bytes the rank's
    exchanges sent (``RowBand.sent``)."""
    dtype = DTYPES[cfg.dtype]
    band = None
    if spatial_axis is not None:
        if spatial_axis != "spatial" or not isinstance(mesh, data_mesh.Grid):
            raise ValueError(f"spatial_axis {spatial_axis!r}: a (data, spatial) Grid mesh and "
                             "the axis 'spatial'")
        if mesh.spatial > 1:
            band = spatial.RowBand(spatial.RowMesh.of_grid(mesh),
                                   spatial.partition_for(cfg, mesh.spatial))

    def step(model: torch.nn.Module, seq: dict) -> torch.Tensor:
        model.train()
        freeze(model, fix_net_name)
        optimizer.zero_grad(set_to_none=True)
        device = next(model.parameters()).device
        precision = (cudnn_fp32() if dtype == torch.float32 and device.type == "cuda"
                     else contextlib.nullcontext())
        stats = (global_bn_stats(data_mesh.all_reduce_sum) if mesh is not None
                 else contextlib.nullcontext())
        with precision, stats, _on(band):
            with parameters_as(model, dtype):            # one cast per optimizer step
                loss = unroll_loss(model, seq, cfg, loss_mode, fix_net_name, use_gt_flow,
                                   dtype, lpips_params, remat, band)
                (loss if band is None else loss / band.mesh.world).backward()
        loss = loss.detach()
        fill_grads(model)
        if mesh is not None:
            grid = isinstance(mesh, data_mesh.Grid)
            if grid:
                loss = loss / mesh.spatial       # every band holds its slice's loss
            data_mesh.all_reduce_mean_([p.grad for p in model.parameters()
                                        if p.grad is not None] + [loss],
                                       divisor=mesh.data if grid else None)
        optimizer.step()
        return loss

    step.band = band
    return step


@contextlib.contextmanager
def _on(band):
    """The step on ``band``'s rows (nothing without one). A remat recompute
    runs the whole unroll step again, its exchanges included: with the
    early stop of ``torch.utils.checkpoint`` a band could stop before an
    exchange that another band's recompute makes."""
    if band is None:
        yield
        return
    with bands.rows(band), torch.utils.checkpoint.set_checkpoint_early_stop(False):
        yield
