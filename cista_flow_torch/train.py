"""The CISTA-Flow trainer on one card: three-phase schedule, BPTT over
sequences.

    python -m cista_flow_torch.train --model_mode cista-eiflow \
        --path_to_train_data DIR [--path_to_e2vflow CKPT] [--epochs N] ...
        [--device cpu] [--dtype bfloat16]

Counterpart of the JAX package's ``train.py`` (ref: train.py:27-269):
* phase schedule (ref: train.py:116-129): epochs [0, flow_epoch) train the
  flow net with the reconstructor frozen and the GT flow driving the warps;
  [flow_epoch, +rec_epoch) train the reconstructor with the flow net frozen
  (predicted flow); after that lr := 3e-5 and the two alternate every two
  epochs;
* Adam + StepLR(10, 0.9); a resume rescales the first lr by
  0.9^floor(epoch/10) (the optimizer moments are not checkpointed, as in the
  reference);
* checkpoints ``{path_to_model}/{name}/{name}_{epoch}.pth.tar`` in the
  reference's ``{'epoch', 'state_dict'}`` layout at the reference's
  schedule (ref: train.py:137-140).
Only ``cista-eiflow`` is ported. Not ported: LPIPS (no weights exist), the
orbax exact resume (``--load_epoch_for_train -1``), step-level saves,
``remat`` and the data-parallel mesh.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from . import weights
from .config import Config
from .data.train_loader import StackedSequenceLoader, TrainSequenceDataset
from .device import resolve_device
from .models import composite
from .parallel import make_optimizer, make_train_step, set_lr, step_lr


def phase_for_epoch(cfgs, epoch: int):
    """(fix_net_name, loss_mode, use_gt_flow, lr_override) of ``epoch``
    (the JAX package's ``train.phase_for_epoch``). The phase-3 train-rec half
    runs loss 'rec' (consistency from step 2), its train-flow half 'both'
    without the consistency term (ref: train.py:123-129, 210-217)."""
    if cfgs.model_mode != "cista-eiflow":
        raise ValueError(f"training {cfgs.model_mode!r} is not ported; only "
                         "cista-eiflow is")
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


class Trainer:
    """Initialises the composite (from ``path_to_e2vflow``, from
    ``path_to_e2v`` + ``path_to_flownet``, from a saved epoch, or at random
    from ``seed``), the data and the optimizer; ``run`` trains."""

    def __init__(self, cfgs: Config, device=None):
        phase_for_epoch(cfgs, 0)              # refuses the modes not ported
        if cfgs.load_epoch_for_train < 0:
            raise NotImplementedError("the exact resume (load_epoch_for_train -1) "
                                      "is not ported")
        self.cfgs = cfgs
        self.device = resolve_device(device)
        self.model_name = model_name_from_cfg(cfgs)
        self.path_to_model = os.path.join(cfgs.path_to_model, self.model_name)
        os.makedirs(self.path_to_model, exist_ok=True)

        model = composite.init(cfgs, device="cpu")
        if cfgs.load_epoch_for_train:
            model.load_reference_state(weights.load_state_dict(os.path.join(
                self.path_to_model,
                f"{self.model_name}_{cfgs.load_epoch_for_train}.pth.tar")))
        elif cfgs.path_to_e2vflow:
            model.load_reference_state(weights.load_state_dict(cfgs.path_to_e2vflow))
            print(f"Load path_to_e2vflow: {cfgs.path_to_e2vflow}")
        else:
            if cfgs.path_to_e2v:
                sd = weights.tie_ista_blocks(weights.load_state_dict(cfgs.path_to_e2v),
                                             cfgs.depth)
                model.cista_net.load_state_dict(
                    {k: torch.tensor(v) for k, v in sd.items()}, strict=True)
                print(f"Load path_to_e2v: {cfgs.path_to_e2v}")
            if cfgs.path_to_flownet:
                sd = weights.load_state_dict(cfgs.path_to_flownet)
                model.event_flownet.load_state_dict(
                    {k: torch.tensor(v) for k, v in sd.items()}, strict=True)
                print(f"Load path_to_flownet: {cfgs.path_to_flownet}")
        self.model = model.to(self.device)

        ds = TrainSequenceDataset(
            os.path.join(cfgs.path_to_train_data, "train_e2v_estflow.txt"), cfgs)
        self.loader = StackedSequenceLoader(ds, batch_size=cfgs.batch_size,
                                            len_sequence=max(cfgs.len_sequence, 1),
                                            shuffle=cfgs.shuffle, seed=cfgs.seed)
        self.base_lr = cfgs.lr
        lr = cfgs.lr * (0.9 ** np.floor(cfgs.load_epoch_for_train / 10.0))
        self.optimizer = make_optimizer(self.model, float(lr))
        print("LPIPS is not ported; training without the perceptual term.")
        self._steps = {}

    def step_fn(self, fix_net_name, loss_mode, use_gt_flow):
        key = (fix_net_name, loss_mode, use_gt_flow)
        if key not in self._steps:
            self._steps[key] = make_train_step(self.cfgs, self.optimizer, loss_mode,
                                               fix_net_name, use_gt_flow)
        return self._steps[key]

    def to_device(self, batch: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device, torch.float32) for k, v in batch.items()}

    def run(self):
        cfgs = self.cfgs
        for epoch in range(cfgs.load_epoch_for_train, cfgs.epochs):
            fix, loss_mode, use_gt_flow, lr_override = phase_for_epoch(cfgs, epoch)
            lr = lr_override if lr_override is not None else step_lr(self.base_lr, epoch)
            set_lr(self.optimizer, lr)
            print(f"lr: {lr}")
            print(f"train_rec: {fix == 'flow'}")
            step = self.step_fn(fix, loss_mode, use_gt_flow)
            n = len(self.loader)
            t0 = time.perf_counter()
            for batch_idx, seq in enumerate(self.loader):
                loss = step(self.model, self.to_device(seq))
                if batch_idx % 50 == 0:
                    print(f"Train Epoch: {epoch + 1} [{batch_idx * cfgs.batch_size}/"
                          f"{n * cfgs.batch_size} ({100.0 * batch_idx / max(n, 1):.0f}%)]"
                          f"\tloss: {float(loss):.6f}")
            if is_save_epoch(cfgs, epoch):
                path = os.path.join(self.path_to_model,
                                    f"{self.model_name}_{epoch + 1}.pth.tar")
                weights.save_checkpoint(path, self.model, epoch)
                print(f"saved {path}")
            print(f"epoch{epoch + 1}: {n} batches in {time.perf_counter() - t0:.2f} s "
                  "(host clock)")


def parse_args(argv=None) -> tuple[Config, str]:
    ap = argparse.ArgumentParser(description="train the PyTorch port (cista-eiflow)")
    ap.add_argument("--image_dim", nargs=2, default=[180, 240], type=int)
    ap.add_argument("--path_to_model", default="models")
    ap.add_argument("--model_name", default="")
    ap.add_argument("--model_mode", default="cista-eiflow")
    ap.add_argument("-b", "--num_bins", default=5, type=int)
    ap.add_argument("-d", "--depth", default=5, type=int)
    ap.add_argument("-c", "--base_channels", default=64, type=int)
    ap.add_argument("--path_to_e2v")
    ap.add_argument("--path_to_e2vflow")
    ap.add_argument("--path_to_flownet")
    ap.add_argument("--path_to_train_data", required=True)
    ap.add_argument("-s", "--len_sequence", default=10, type=int)
    ap.add_argument("--epochs", default=1, type=int)
    ap.add_argument("--flow_epoch", default=20, type=int)
    ap.add_argument("--rec_epoch", default=5, type=int)
    ap.add_argument("--lr", default=1e-4, type=float)
    ap.add_argument("--batch_size", default=1, type=int)
    ap.add_argument("--load_epoch_for_train", default=0, type=int)
    ap.add_argument("--is_forward_flow", action="store_true")
    ap.add_argument("--warp_mode", default="forward")
    ap.add_argument("--is_reverse_events", action="store_true")
    ap.add_argument("--is_bi", action="store_true")
    ap.add_argument("--num_events", default=15000, type=int)
    ap.add_argument("--flow_iters", default=None, type=int)
    ap.add_argument("--seed", default=1234, type=int)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = vars(ap.parse_args(argv))
    device = args.pop("device")
    args["image_dim"] = tuple(args["image_dim"])
    # the reference trainer always shuffles, as the JAX package's train.py does
    return Config(**args, shuffle=True), device


def main(argv=None) -> int:
    cfgs, device = parse_args(argv)
    Trainer(cfgs, device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
