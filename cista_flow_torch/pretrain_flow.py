"""Flow-net pretraining on one card: DCEIFlow, E-RAFT or RAFT, on
FlyingChairs2 or on simulated pairs.

    python -m cista_flow_torch.pretrain_flow [--data_kind chairs2|sim] \
        --path_to_train_data DIR [--flow_arch dceiflow|raft|eraft] [--opt adam|raft]
        [--image_dim H W] [--epochs N] [--batch_size B] [--lr LR] [--dtype bfloat16]
        [--is_bi --is_reverse_events] [--device cpu]

Counterpart of the JAX package's root ``pretrain_flow.py`` (the first stage
of the reference's recipe, the DCEIFlow "GT I" stage): the gamma-weighted
sequence flow loss plus the x10 pseudo-feature loss (ref:
DCEIFlow/core/loss/L1Loss.py:6-114), the optional bidirectional branch,
BatchNorm in train mode; bf16 as the composite trainer does it (f32 master
parameters read in bf16, ``parameters_as``). ``--opt adam`` is the
composite trainer's Adam; ``--opt raft`` the upstream RAFT/DCEIFlow
pretraining recipe, AdamW with optax's linear one-cycle schedule and a
global-norm clip at 1.0 (``make_raft_optimizer``). After every epoch the
flow net is saved as ``{path_to_model}/{arch}_b{num_bins}/{arch}_{epoch}.pth.tar``,
``{'epoch', 'model'}`` in the reference's flow-net layout, which the
composite trainers of both packages load through ``--path_to_flownet``.

``--data_kind chairs2`` (the default, as in the JAX script) trains on the
FlyingChairs2 folder ``--path_to_train_data`` (``data.flying_chairs2``:
its train split, RGB pairs, HDF5 events through the port's own reader),
augmented as the JAX script augments it (crops of ``--image_dim``, flips,
the colour jitter; the augmentor's draws from ``--seed``, where the JAX
script leaves them unseeded). DCEIFlow reads the first channel of the
frames, RAFT all three in [0, 255]; RAFT needs a crop divisible by 32
(``make_train_step`` refuses others, as the JAX script asserts). ``--data_kind
sim`` trains on ``SimFlowPairs`` of the simulated training layout. E-RAFT
needs ``--data_kind sim`` (chairs2 has no event stream for its voxel pair),
as in the JAX script; RAFT refuses ``--data_kind sim``, whose frames are
grey.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from . import weights
from .config import add_args, from_args
from .device import DTYPES, cudnn_fp32, resolve_device
from .losses.flow import flow_sequence_loss
from .models.dceiflow import DCEIFlow
from .models.eraft import ERAFT
from .models.raft import RAFT
from .parallel.train_step import make_optimizer, optimizer_step, parameters_as
from .utils.profiling import StepTimer

# the batch keys the forward reads, cast to bf16 in a bf16 step (the JAX
# script's list); gt_flow and valid stay f32
NET_INPUTS = ("event_voxel", "event_voxel_bw", "event_voxel_old", "gt_img0", "gt_img1")
ONECYCLE_START, ONECYCLE_DIV, ONECYCLE_FINAL_DIV = 0.05, 25.0, 1e3


def flow_net(arch: str, cfg, device=None, seed: int | None = None) -> torch.nn.Module:
    """A flow net with random weights made from ``seed`` (default
    ``cfg.seed``), on ``device`` (default: the GPU; raises without one)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        model = {"dceiflow": lambda: DCEIFlow(cfg.num_bins, cfg.ds),
                 "eraft": lambda: ERAFT(cfg.num_bins), "raft": RAFT}[arch]()
    return model.to(dev)


def make_batches(ds, batch_size: int, shuffle: bool, rng: np.random.Generator):
    """Batches of ``batch_size`` items as dicts of C-contiguous NCHW float32
    arrays, in the order of ``rng.shuffle`` of the indices; the last
    partial batch is dropped (the JAX function's batches, for the same
    seed). An item may hold a transposed view (FlyingChairs2's CHW frames
    and flows), whose layout ``np.stack`` keeps: the kernels take dense
    tensors."""
    order = np.arange(len(ds))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        items = [ds[j] for j in order[i:i + batch_size]]
        yield {k: np.ascontiguousarray(np.stack([np.asarray(it[k], np.float32)
                                                 for it in items]))
               for k in items[0]}


def onecycle_lr(peak_lr: float, horizon: int):
    """optax's ``linear_onecycle_schedule(horizon, peak_lr, pct_start=0.05,
    pct_final=1.0, div_factor=25, final_div_factor=1e3)`` as a function of
    the update count. With pct_final = 1.0 its last two knots share the key
    ``horizon`` and the later one wins: linear from peak/25 at 0 to the peak
    at int(0.05 * horizon), linear down to peak/1000 at ``horizon``, then
    constant. (``torch.optim.lr_scheduler.OneCycleLR`` would end at
    peak/25/1000.)"""
    bounds = (0, int(ONECYCLE_START * horizon), horizon)
    values = np.cumprod((peak_lr / ONECYCLE_DIV, ONECYCLE_DIV, 1.0 / ONECYCLE_FINAL_DIV))

    def lr(count: int) -> float:
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                return float((values[i + 1] - values[i]) * pct + values[i])
        return float(values[-1])
    return lr


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: every gradient becomes
    ``g / norm * max_norm`` where the global L2 norm is at least
    ``max_norm``, and stays as it is below (``clip_grad_norm_`` would scale
    by max_norm / (norm + 1e-6) at every norm). Decided on the device, no
    host sync. Returns the norm."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    below = norm < max_norm
    torch._foreach_div_(grads, torch.where(below, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(below, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
    return norm


class OneCycleAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips the gradients by their global norm
    and sets the learning rate of the step's update count from
    ``schedule``: optax's ``chain(clip_by_global_norm(clip), adamw(schedule,
    weight_decay, eps=1e-8))`` (torch's decoupled decay, p -= lr * wd * p,
    is optax's ``add_decayed_weights`` before the learning rate). ``foreach``
    is asked for by name, as in ``parallel.make_optimizer``: the kernels'
    weight caches watch the parameters' version counters."""

    def __init__(self, params, schedule, clip: float, weight_decay: float):
        super().__init__(params, lr=schedule(0), weight_decay=weight_decay, eps=1e-8,
                         foreach=True)
        self.schedule = schedule
        self.clip = clip
        self.updates = 0

    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        clip_by_global_norm_(grads, self.clip)
        for group in self.param_groups:
            group["lr"] = self.schedule(self.updates)
        self.updates += 1
        return super().step(closure)


def make_raft_optimizer(model: torch.nn.Module, peak_lr: float, total_steps: int,
                        wdecay: float = 1e-4, clip: float = 1.0) -> OneCycleAdamW:
    """The upstream RAFT/DCEIFlow pretraining recipe (the JAX script's
    ``make_raft_optimizer``): AdamW, the one-cycle LR over ``total_steps``
    updates, the gradients clipped at a global norm of ``clip``. A horizon
    whose warm-up is shorter than one step (``int(0.05 * T) < 1``, where
    optax's schedule is NaN) is stretched to 100, as there."""
    horizon = total_steps
    if int(ONECYCLE_START * horizon) < 1:
        horizon = 100
        if total_steps > 1:
            print(f"pretrain_flow: total_steps={total_steps} degenerate for OneCycle "
                  "(warmup<1 step); stretching horizon to 100 — the run ends mid-schedule "
                  "(smoke-run regime)")
    return OneCycleAdamW(model.parameters(), onecycle_lr(peak_lr, horizon), clip, wdecay)


def flow_forward(model, batch: dict, arch: str, iters: int, train: bool = True) -> dict:
    """The flow net on a batch as the JAX script calls it: DCEIFlow on the
    voxel and the first frame, in training with the second frame (its
    pseudo-feature loss) and the reversed voxel where the batch has one;
    E-RAFT on (previous voxel, voxel); RAFT on the frames as RGB in
    [0, 255]; DCEIFlow reads the first channel of RGB frames.
    ``train``: every iteration's flow (the sequence loss), else the last
    only."""
    if arch == "raft":
        return model(255.0 * batch["gt_img0"], 255.0 * batch["gt_img1"], iters=iters,
                     collect_preds=train)
    if arch == "eraft":
        return model(batch["event_voxel_old"], batch["event_voxel"], iters=iters,
                     collect_preds=train)
    # an RGB batch's first channel, dense: elementwise ops on the strided
    # slice give it channels-last strides (its C is 1), which the convs keep
    # and the kernels refuse
    frame0, frame1 = (batch[k][:, :1].contiguous() for k in ("gt_img0", "gt_img1"))
    if not train:
        return model(batch["event_voxel"], frame0, iters=iters)
    return model(batch["event_voxel"], frame0, iters=iters, collect_preds=True, image2=frame1,
                 reversed_event_voxel=batch.get("event_voxel_bw"))


def make_train_step(cfg, optimizer: torch.optim.Optimizer, is_bi: bool,
                    flow_arch: str = "dceiflow"):
    """``step(model, batch) -> (loss, epe)``, 0-dim f32 tensors on the
    model's device. ``batch``: dict of NCHW f32 tensors on that device
    (``make_batches``' keys). The model is put in train mode; in bf16 its
    parameters and the ``NET_INPUTS`` read in bf16 and the loss's targets
    are built from the cast batch, as the JAX step builds them (so the
    frames reach the loss in bf16; the flows and ``valid`` stay f32). The
    optimizer takes one step; a parameter outside the loss gets a zero
    gradient, as in the JAX step."""
    if flow_arch == "raft" and any(d % 32 for d in cfg.image_dim):
        # RAFT pads to /8 and the sequence loss pads its targets to /32: the
        # two padders agree only on a /32 crop (the JAX script asserts it)
        raise ValueError(f"raft pretraining needs a /32-divisible crop, got {cfg.image_dim}")
    dtype = DTYPES[cfg.dtype]
    iters = cfg.default_flow_iters()

    def step(model: torch.nn.Module, batch: dict):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        device = next(model.parameters()).device
        precision = (cudnn_fp32() if dtype == torch.float32 and device.type == "cuda"
                     else contextlib.nullcontext())
        with precision, parameters_as(model, dtype):
            b = {k: v.to(dtype) if k in NET_INPUTS else v for k, v in batch.items()}
            out = flow_forward(model, b, flow_arch, iters)
            target = {"gt_img0": b["gt_img0"][:, :1].contiguous(),   # RAFT's are RGB
                      "gt_img1": b["gt_img1"][:, :1].contiguous(),
                      "gt_flow": b["gt_flow"], "valid": b["valid"]}
            if is_bi:
                target["gt_flow_bw"] = b["gt_flow_bw"]
                target["valid_bw"] = b["valid"]
            loss, metrics = flow_sequence_loss(out, target, cfg, is_bi=is_bi)
            loss.backward()
        optimizer_step(model, optimizer)
        return loss.detach(), metrics["epe"].detach()

    return step


def make_flow_optimizer(model, cfg, opt: str, steps_per_epoch: int):
    """``--opt raft``: the one-cycle AdamW over every epoch's steps;
    ``--opt adam``: the composite trainer's Adam."""
    if opt == "raft":
        return make_raft_optimizer(model, cfg.lr, cfg.epochs * steps_per_epoch)
    return make_optimizer(model, cfg.lr)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def training_set(cfgs, data_kind: str):
    """The pretraining set of ``cfgs.path_to_train_data``: FlyingChairs2's
    train split augmented as the JAX script augments it (crops of
    ``cfgs.image_dim``, flips, the draws from ``cfgs.seed``), or
    ``SimFlowPairs`` with flips."""
    if data_kind == "chairs2":
        from .data.flying_chairs2 import FlyingChairs2
        ds = FlyingChairs2(cfgs, cfgs.path_to_train_data, data_kind="train",
                           aug_params={"crop_size": tuple(cfgs.image_dim), "do_flip": True,
                                       "seed": cfgs.seed})
        print(f"FlyingChairs2: {len(ds)} training samples")
        return ds
    from .data.sim import SimFlowPairs
    ds = SimFlowPairs(cfgs, aug=True)
    print(f"SimFlowPairs: {len(ds)} training pairs")
    return ds


def run(cfgs, arch: str, opt: str, device=None, data_kind: str = "sim") -> list:
    """Pretrain ``arch`` on ``training_set(cfgs, data_kind)``; returns the
    checkpoints' paths."""
    dev = resolve_device(device)
    ds = training_set(cfgs, data_kind)
    model = flow_net(arch, cfgs, dev)
    optimizer = make_flow_optimizer(model, cfgs, opt, max(1, len(ds) // cfgs.batch_size))
    step = make_train_step(cfgs, optimizer, cfgs.is_bi and arch == "dceiflow", arch)
    rng = np.random.default_rng(cfgs.seed)
    out_dir = os.path.join(cfgs.path_to_model, f"{arch}_b{cfgs.num_bins}")
    os.makedirs(out_dir, exist_ok=True)
    saved = []
    for epoch in range(cfgs.epochs):
        timer = StepTimer(f"epoch{epoch + 1}")
        for i, batch in enumerate(make_batches(ds, cfgs.batch_size, cfgs.shuffle, rng)):
            tb = to_device(batch, dev)
            timer.start()
            loss, epe = step(model, tb)
            timer.stop(loss)
            if i % 50 == 0:
                print(f"Epoch {epoch + 1} [{i * cfgs.batch_size}/{len(ds)}] "
                      f"loss: {float(loss):.4f} epe: {float(epe):.3f}")
        print(timer)
        path = os.path.join(out_dir, f"{arch}_{epoch + 1}.pth.tar")
        weights.save_checkpoint(path, model, epoch, key="model")
        print(f"saved {path}")
        saved.append(path)
    return saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Flow-net pretraining")
    add_args(ap)
    ap.add_argument("--flow_arch", default="dceiflow", choices=["dceiflow", "raft", "eraft"])
    ap.add_argument("--opt", default="adam", choices=["adam", "raft"],
                    help="raft: AdamW + OneCycle + clip(1.0), the upstream RAFT/DCEIFlow "
                         "pretraining recipe")
    ap.add_argument("--data_kind", default="chairs2", choices=["chairs2", "sim"])
    args = ap.parse_args(argv)
    if args.flow_arch == "eraft" and args.data_kind != "sim":
        ap.error("--flow_arch eraft needs --data_kind sim "
                 "(chairs2 has no event stream for the voxel pair)")
    if args.flow_arch == "raft" and args.data_kind == "sim":
        ap.error("--flow_arch raft trains on RGB image pairs, which --data_kind sim (grey "
                 "frames) cannot give; use --data_kind chairs2")
    cfgs = from_args(args)
    # model_mode drives the pairs' keys (cista-eraft adds event_voxel_old) and
    # default_flow_iters (6 or 12)
    cfgs.model_mode = "cista-eraft" if args.flow_arch == "eraft" else "cista-eiflow"
    run(cfgs, args.flow_arch, args.opt, args.device, args.data_kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
