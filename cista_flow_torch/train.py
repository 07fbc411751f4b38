"""The CISTA-Flow trainer on one card or over cards (data-parallel, row
bands or both): three-phase schedule, BPTT over sequences, every model mode.

    python -m cista_flow_torch.train [--model_mode cista-eiflow] \
        --path_to_train_data DIR [--path_to_e2vflow CKPT] [--epochs N] ...
        [--remat] [--save_every_steps N] [--orbax_ckpt] [--is_SummaryWriter]
        [--load_epoch_for_train E | -1] [--device cpu] [--dtype bfloat16]
        [--distributed | --mesh_shape N [--mesh_axes data | spatial]
         | --mesh_shape D,S --mesh_axes data,spatial]
    torchrun --nproc_per_node N -m cista_flow_torch.train ...

Counterpart of the JAX package's ``train.py`` (ref: train.py:27-269), with
its command line: every flag of ``config.add_args`` (the JAX
``configs.add_args``) with its default (``--model_mode cista-lstc``), the
shuffle always on (``--no_shuffle`` parses and changes nothing, as there),
the TPU-only routings refused by name, plus ``--device`` and the mesh flags.
Flags only the JAX package's serving CLIs read parse and are unused here,
as there. What it does:
* phase schedule (ref: train.py:116-129): for cista-eiflow, cista-eraft
  and cista-idnet, epochs [0, flow_epoch) train the flow net with the
  reconstructor frozen and the GT flow driving the warps; [flow_epoch,
  +rec_epoch) train the reconstructor with the flow net frozen (predicted
  flow); after that lr := 3e-5 and the two alternate every two epochs.
  cista-lstc and cista-gtflow have no flow net: every epoch trains the
  reconstructor on the GT flow, loss 'rec';
* Adam + StepLR(10, 0.9); a resume from a ``.pth.tar`` epoch rescales the
  first lr by 0.9^floor(epoch/10) and restarts Adam, as the reference does;
* checkpoints ``{path_to_model}/{name}/{name}_{epoch}.pth.tar`` in the
  reference's ``{'epoch', 'state_dict'}`` layout at the reference's
  schedule (ref: train.py:137-140);
* the exact resume (``ckpt.py``, the port's counterpart of the JAX
  package's orbax saves): ``--orbax_ckpt`` also writes the full state
  (parameters, BatchNorm buffers, Adam's moments and step counts) at every
  epoch save into ``{name}/full_state``, ``--save_every_steps N`` every N
  optimizer steps into ``{name}/full_state_steps`` (the newest two kept),
  and ``--load_epoch_for_train -1`` resumes from the newest: a step save
  wins when its epoch is at least the last epoch save's, and that epoch
  restarts from its first batch;
* ``--remat`` recomputes each unroll step in the backward;
* LPIPS joins the reconstruction loss when ``CISTA_LPIPS`` (or
  ``CISTA_LPIPS_ALEX``, ``CISTA_LPIPS_VGG``) names a weights file;
* the data axis of the JAX trainer's mesh (train.py:133-161, 204-208):
  ``--distributed`` trains over every local card, ``--mesh_shape N`` over
  N ranks (``--device cpu``: N gloo processes), ``torchrun`` over the
  ranks it starts; one process per card (``parallel/mesh.py``), each on
  its slice of every host batch (``--batch_size`` is the batch of one
  host, split over its cards), with BatchNorm's statistics, the gradients
  and the loss those of the global batch; rank 0 alone writes the
  checkpoints and the log; batches reach the card through
  ``data/prefetch.py`` (two in flight); ``--mesh_axes spatial`` and
  ``data,spatial`` split every frame's rows over a rank's spatial group
  (``parallel/spatial.py``);
* ``--is_SummaryWriter`` logs the loss of every optimizer step to
  ``./summary/{model_name}`` through ``torch.utils.tensorboard`` (rank 0
  alone); without tensorboard it says so and trains on, as the JAX
  trainer does (train.py:172-179, 213-214).
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np
import torch

from . import ckpt, config, weights
from .config import Config
from .data.prefetch import device_prefetch
from .data.train_loader import StackedSequenceLoader, TrainSequenceDataset
from .device import resolve_device
from .losses import lpips
from .models import composite
from .ops import cuda_build
from .parallel import make_optimizer, make_train_step, mesh as data_mesh, set_lr, spatial, step_lr

FLOW_MODES = ("cista-eiflow", "cista-eraft", "cista-idnet")


def phase_for_epoch(cfgs, epoch: int):
    """(fix_net_name, loss_mode, use_gt_flow, lr_override) of ``epoch``
    (the JAX package's ``train.phase_for_epoch``). The phase-3 train-rec half
    runs loss 'rec' (consistency from step 2), its train-flow half 'both'
    without the consistency term (ref: train.py:123-129, 210-217).
    cista-lstc and cista-gtflow train the reconstructor alone on the GT
    flow."""
    if cfgs.model_mode not in FLOW_MODES + ("cista-lstc", "cista-gtflow"):
        raise ValueError(f"unknown model_mode {cfgs.model_mode!r}")
    if cfgs.model_mode not in FLOW_MODES:
        return None, "rec", True, None
    if epoch < cfgs.flow_epoch:
        return "rec", "flow", True, None
    if epoch < cfgs.flow_epoch + cfgs.rec_epoch:
        return "flow", "rec", False, None
    if (epoch - cfgs.flow_epoch - cfgs.rec_epoch) % 4 >= 2:
        return "flow", "rec", False, 3e-5
    return "rec", "both", False, 3e-5


def model_name_from_cfg(cfgs) -> str:
    base = f"{cfgs.model_mode}_b{cfgs.num_bins}_d{cfgs.depth}_c{cfgs.base_channels}"
    return f"{cfgs.model_name}_{base}" if cfgs.model_name else base


def is_save_epoch(cfgs, epoch: int) -> bool:
    """The reference's save schedule (ref: train.py:137-140): after the
    first epoch, at the end of the rec phase, every second epoch after it,
    and every tenth."""
    boundary = cfgs.flow_epoch + cfgs.rec_epoch
    return (epoch == 0 or (epoch + 1) == boundary
            or ((epoch + 1) >= boundary and (epoch + 1 - boundary) % 2 == 0)
            or (epoch + 1) % 10 == 0)


def _quiet(*args, **kwargs) -> None:
    pass


class Trainer:
    """Initialises the composite (from the newest full-state save with
    ``load_epoch_for_train -1``, from a saved epoch, from
    ``path_to_e2vflow``, from ``path_to_e2v`` + ``path_to_flownet``, or at
    random from ``seed``), the data and the optimizer; ``run`` trains.
    With a ``mesh`` (one ``DataMesh`` rank) the model is broadcast from
    rank 0, the loader yields this rank's slice of each host batch, the
    step is the data-parallel one, and rank 0 alone writes and logs, the
    others waiting at a barrier after each save. With a ``Grid`` (a rank of
    a (data, spatial) mesh) the loader yields its data index's slice and
    the step runs on the rank's band of its rows."""

    def __init__(self, cfgs: Config, device=None,
                 mesh: data_mesh.DataMesh | data_mesh.Grid | None = None):
        phase_for_epoch(cfgs, 0)              # refuses an unknown mode
        self.cfgs = cfgs
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.writes = mesh is None or mesh.is_main
        self.log = print if self.writes else _quiet
        self.model_name = model_name_from_cfg(cfgs)
        self.path_to_model = os.path.join(cfgs.path_to_model, self.model_name)
        if self.writes:
            os.makedirs(self.path_to_model, exist_ok=True)
        self.epoch_dir = os.path.join(self.path_to_model, "full_state")
        self.steps_dir = os.path.join(self.path_to_model, "full_state_steps")

        model = composite.init(cfgs, device="cpu")
        self.resume = None                    # (directory, step) of an exact resume
        self.resume_global_step = 0
        if cfgs.load_epoch_for_train == -1:
            self.resume = self._resume_point()
        elif cfgs.load_epoch_for_train:
            model.load_reference_state(weights.load_state_dict(os.path.join(
                self.path_to_model,
                f"{self.model_name}_{cfgs.load_epoch_for_train}.pth.tar")))
        elif cfgs.path_to_e2vflow:
            model.load_reference_state(weights.load_state_dict(cfgs.path_to_e2vflow))
            self.log(f"Load path_to_e2vflow: {cfgs.path_to_e2vflow}")
        else:
            if cfgs.path_to_e2v:
                sd = weights.tie_ista_blocks(weights.load_state_dict(cfgs.path_to_e2v),
                                             cfgs.depth)
                model.cista_net.load_state_dict(
                    {k: torch.tensor(v) for k, v in sd.items()}, strict=True)
                self.log(f"Load path_to_e2v: {cfgs.path_to_e2v}")
            if cfgs.path_to_flownet and cfgs.model_mode in FLOW_MODES:
                # the flow net's own checkpoint, in the reference's key layout
                # (fnet.*, cnet.*, update_block.*; IDNet fnet.*, update_net.*)
                sd = weights.load_state_dict(cfgs.path_to_flownet)
                model.event_flownet.load_state_dict(
                    {k: torch.tensor(v) for k, v in sd.items()}, strict=True)
                self.log(f"Load path_to_flownet: {cfgs.path_to_flownet}")
        if self.resume is not None:
            ckpt.restore_checkpoint(*self.resume, model=model)
        self.model = model.to(self.device)
        if mesh is not None:
            data_mesh.replicate_(self.model)

        ds = TrainSequenceDataset(
            os.path.join(cfgs.path_to_train_data, "train_e2v_estflow.txt"), cfgs)
        if isinstance(mesh, data_mesh.Grid):
            shard = mesh.loader_shard()
        else:
            shard = {} if mesh is None else dict(
                process_index=mesh.host, process_count=mesh.n_hosts,
                local_index=mesh.local_rank, local_count=mesh.local_world)
        self.loader = StackedSequenceLoader(ds, batch_size=cfgs.batch_size,
                                            len_sequence=max(cfgs.len_sequence, 1),
                                            shuffle=cfgs.shuffle, seed=cfgs.seed, **shard)
        self.base_lr = cfgs.lr
        lr = cfgs.lr * (0.9 ** np.floor(cfgs.load_epoch_for_train / 10.0))
        self.optimizer = make_optimizer(self.model, float(lr))
        if self.resume is not None:
            ckpt.restore_checkpoint(*self.resume, optimizer=self.optimizer)
            self.log(f"Resumed exactly from {os.path.basename(self.resume[0])} "
                     f"step {self.resume[1]}")

        # the reference's default LPIPS net is 'alex' (loss.py:307)
        self.lpips_params = lpips.params_from_env()
        if self.lpips_params is None:
            self.log("LPIPS weights not provided (set CISTA_LPIPS=<converted .npz>; see "
                     "convert_lpips.py); training without the perceptual term.")
        else:
            self.lpips_params = lpips.to(self.lpips_params, self.device)
        self._steps = {}
        self.writer = None
        if cfgs.is_SummaryWriter and self.writes:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(f"./summary/{self.model_name}")
            except ImportError:
                print("tensorboard unavailable; scalar logging disabled")

    def _resume_point(self) -> tuple:
        """(directory, step) of the newest full-state save, as the JAX
        trainer chooses it (train.py:64-87): a step save when its epoch is
        at least the last epoch save's (that epoch restarts from its first
        batch), else the last epoch save. Sets ``load_epoch_for_train`` to
        the epoch the run starts at."""
        cfgs = self.cfgs
        e_step = ckpt.latest_step(self.epoch_dir)
        s_step = ckpt.latest_step(self.steps_dir)
        if s_step is not None:
            meta = ckpt.read_meta(self.steps_dir, s_step)
            if e_step is None or meta.get("epoch", -1) >= e_step:
                self.resume_global_step = meta.get("global_step", 0)
                cfgs.load_epoch_for_train = meta.get("epoch", 0)
                return self.steps_dir, s_step
        if e_step is None:
            raise FileNotFoundError(f"no full-state checkpoint in {self.epoch_dir} or "
                                    f"{self.steps_dir}")
        cfgs.load_epoch_for_train = e_step
        return self.epoch_dir, e_step

    def step_fn(self, fix_net_name, loss_mode, use_gt_flow):
        key = (fix_net_name, loss_mode, use_gt_flow)
        if key not in self._steps:
            self._steps[key] = make_train_step(self.cfgs, self.optimizer, loss_mode,
                                               fix_net_name, use_gt_flow,
                                               lpips_params=self.lpips_params,
                                               remat=self.cfgs.remat, mesh=self.mesh,
                                               spatial_axis="spatial" if isinstance(
                                                   self.mesh, data_mesh.Grid) else None)
        return self._steps[key]

    def save(self, write) -> None:
        """``write()`` on the writing rank; with a mesh every rank then
        waits until it is done."""
        if self.writes:
            write()
        if self.mesh is not None:
            self.mesh.barrier()

    def run(self):
        cfgs = self.cfgs
        global_step = self.resume_global_step
        for epoch in range(cfgs.load_epoch_for_train, cfgs.epochs):
            fix, loss_mode, use_gt_flow, lr_override = phase_for_epoch(cfgs, epoch)
            lr = lr_override if lr_override is not None else step_lr(self.base_lr, epoch)
            set_lr(self.optimizer, lr)
            self.log(f"lr: {lr}")
            self.log(f"train_rec: {fix == 'flow'}")
            step = self.step_fn(fix, loss_mode, use_gt_flow)
            n = len(self.loader)
            t0 = time.perf_counter()
            for batch_idx, seq in enumerate(device_prefetch(self.loader, size=2,
                                                            device=self.device)):
                loss = step(self.model, seq)
                if self.writer is not None:
                    self.writer.add_scalar("loss", float(loss), global_step)
                global_step += 1
                if cfgs.save_every_steps > 0 and global_step % cfgs.save_every_steps == 0:
                    # a mid-epoch save: a resume restarts this epoch from it
                    self.save(lambda: ckpt.save_checkpoint(
                        self.steps_dir, global_step, self.model, self.optimizer,
                        max_to_keep=2, meta={"epoch": epoch, "global_step": global_step}))
                if batch_idx % 50 == 0 and self.writes:
                    print(f"Train Epoch: {epoch + 1} [{batch_idx * cfgs.batch_size}/"
                          f"{n * cfgs.batch_size} ({100.0 * batch_idx / max(n, 1):.0f}%)]"
                          f"\tloss: {float(loss):.6f}")
            if is_save_epoch(cfgs, epoch):
                self.save(lambda: self.save_epoch(epoch))
            self.log(f"epoch{epoch + 1}: {n} batches in {time.perf_counter() - t0:.2f} s "
                     "(host clock)")
        if self.writer is not None:
            self.writer.close()

    def save_epoch(self, epoch: int) -> None:
        """The reference-layout checkpoint of ``epoch`` (and with
        ``orbax_ckpt`` the full state)."""
        path = os.path.join(self.path_to_model, f"{self.model_name}_{epoch + 1}.pth.tar")
        weights.save_checkpoint(path, self.model, epoch)
        print(f"saved {path}")
        if self.cfgs.orbax_ckpt:
            ckpt.save_checkpoint(self.epoch_dir, epoch + 1, self.model, self.optimizer)


def parse_args(argv=None) -> tuple[Config, str]:
    """The JAX trainer's command line (train.py:253-257: ``configs.add_args``,
    then ``shuffle = True``), with ``--device`` and the trainer's mesh flags;
    ``--path_to_train_data`` is required."""
    ap = argparse.ArgumentParser(description="train the PyTorch port")
    config.add_args(ap)
    ap.add_argument("--mesh_shape", default="1",
                    help="N > 1: N ranks on the one axis of --mesh_axes (with --device cpu, "
                         "N processes); D,S: a data x spatial mesh")
    ap.add_argument("--mesh_axes", default="data",
                    help="data (the batch split), spatial (every frame's rows split) or "
                         "data,spatial")
    args = ap.parse_args(argv)
    if args.path_to_train_data is None:
        ap.error("--path_to_train_data: the training set's folder is required")
    if args.distributed and args.mesh_shape == "1" and args.device == "cpu" \
            and not data_mesh.under_torchrun():
        ap.error("--distributed --device cpu: 'every local card' means nothing on the CPU; "
                 "give the rank count with --mesh_shape N")
    cfgs = config.from_args(args)
    cfgs.shuffle = True              # the reference trainer always shuffles
    try:
        _, rows = mesh_dims(cfgs)
        if rows > 1:
            spatial.partition_for(cfgs, rows)
    except ValueError as e:
        ap.error(str(e))
    return cfgs, args.device


def mesh_dims(cfgs: Config) -> tuple[int, int]:
    """(data, spatial): the sizes of the mesh's two axes the flags ask for;
    ValueError for a mesh the trainer does not take."""
    shape, axes = str(cfgs.mesh_shape), str(cfgs.mesh_axes)
    sizes = shape.split(",")
    if not all(n.isdigit() and int(n) >= 1 for n in sizes):
        raise ValueError(f"--mesh_shape {shape}: positive rank counts")
    names = axes.split(",")
    if names not in (["data"], ["spatial"], ["data", "spatial"]):
        raise ValueError(f"--mesh_axes {axes}: data, spatial, or data,spatial")
    if len(sizes) != len(names):
        raise ValueError(f"--mesh_shape {shape} --mesh_axes {axes}: one rank count "
                         "for each axis")
    dims = dict(zip(names, map(int, sizes)))
    return dims.get("data", 1), dims.get("spatial", 1)


def mesh_world(cfgs: Config) -> int | None:
    """The ranks the flags ask for (train.py:134-139 of the JAX package):
    ``--mesh_shape`` the product of its counts, else ``--distributed``
    every local card on the data axis; under ``torchrun`` the ranks it
    started, flags or not. None: one process and no mesh."""
    data, rows = mesh_dims(cfgs)
    n = data * rows
    if data_mesh.under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if n != world and (n != 1 or rows > 1):
            raise SystemExit(f"--mesh_shape {cfgs.mesh_shape} but torchrun started {world} "
                             "ranks")
        return world
    if n > 1:
        return n
    return torch.cuda.device_count() if cfgs.distributed else None


def train_rank(mesh: data_mesh.DataMesh, cfgs: Config) -> None:
    """One rank of a data-parallel or row-sharded run: the kernels built
    once per host (by its rank 0, the others waiting), then the ``Trainer``
    on this rank's card, with the (data, spatial) ``Grid`` where the mesh
    has a spatial axis."""
    if mesh.device.type == "cuda":
        if mesh.local_rank == 0:
            cuda_build.build_all(cuda_build.kernel_counters().values())
        mesh.barrier()
    _, rows = mesh_dims(cfgs)
    if rows > 1:
        mesh = data_mesh.make_grid(mesh, mesh.world // rows, rows)
    Trainer(cfgs, mesh=mesh).run()


def main(argv=None) -> int:
    cfgs, device = parse_args(argv)
    world = mesh_world(cfgs)
    if world is None:
        Trainer(cfgs, device).run()
        return 0
    if device != "cpu" and not data_mesh.under_torchrun():
        resolve_device(device)
        if world > torch.cuda.device_count():
            raise SystemExit(f"{world} ranks but {torch.cuda.device_count()} cards: NCCL "
                             "needs a card per rank")
    # by its package name: run as ``python -m``, this module is __main__, which
    # the spawned ranks import under another name
    rank_fn = importlib.import_module("cista_flow_torch.train").train_rank
    data_mesh.launch(rank_fn, world, device, cfgs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
