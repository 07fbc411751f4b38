"""The flow-net quality loop on simulated data: generate -> pretrain ->
held-out EPE against the zero-flow baseline and the untrained net.

    python -m cista_flow_torch.sim_flow_quality [--workdir build/sim_flow_quality]
        [--flow_arch dceiflow|eraft] [--opt adam|raft] [--epochs 8] [--dtype bfloat16]
        [--device cpu]

Counterpart of the JAX package's root ``sim_flow_quality.py``, with its
flags and defaults (180x240, 48 training videos and 6 held-out ones of 11
frames, 8 epochs, batch 8, lr 2e-4, bf16, ``--aug 0``, seed 0; the held-out
videos from ``seed + 777_000``) and ``--device``; the work directory
defaults to ``build/sim_flow_quality`` under the current directory. The
pairs are ``data.sim.SimFlowPairs``, the training is
``pretrain_flow.make_train_step``; the EPE is the mean over every held-out
pair of its per-pixel endpoint error, the net in eval mode. The trained
flow net is saved as ``{workdir}/models/{flow_arch}_sim_{epochs}.pth.tar``
(``{'epoch', 'model'}``: ``--path_to_flownet`` of the composite trainers).
Prints one JSON line with the JAX script's keys: ``epe_zero``,
``epe_init``, ``epe_trained``, ``beats_zero_flow``, ``epochs``, ``ckpt``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

from . import pretrain_flow as pf
from . import weights
from .config import Config
from .data import sim
from .device import DTYPES, cudnn_fp32, resolve_device
from .parallel.train_step import parameters_as
from .utils.profiling import StepTimer

SPEED_RANGE, OMEGA_RANGE = (15.0, 110.0), (0.05, 0.5)


def mean_epe(ds, cfg, model, batch_size: int, device, zero_flow: bool = False) -> float:
    """Mean endpoint error over the whole held-out pair set, the net in
    eval mode and in ``cfg.dtype`` (its parameters and inputs cast), the
    last iteration only. The final partial batch is filled up with item 0
    (one shape for every call) and the fill left out of the mean."""
    dtype = DTYPES[cfg.dtype]
    arch = "eraft" if cfg.model_mode == "cista-eraft" else "dceiflow"
    tot, n = 0.0, 0
    for i in range(0, len(ds), batch_size):
        idx = list(range(i, min(i + batch_size, len(ds))))
        real = len(idx)
        items = [ds[j] for j in idx + [0] * (batch_size - real)]
        batch = pf.to_device({k: np.stack([it[k] for it in items]) for k in items[0]},
                             device)
        gt = batch["gt_flow"]
        if zero_flow:
            flow = torch.zeros_like(gt)
        else:
            model.eval()
            precision = (cudnn_fp32() if dtype == torch.float32 and gt.is_cuda
                         else contextlib.nullcontext())
            with torch.no_grad(), precision, parameters_as(model, dtype):
                inputs = {k: v.to(dtype) for k, v in batch.items() if k in pf.NET_INPUTS}
                flow = pf.flow_forward(model, inputs, arch, cfg.default_flow_iters(),
                                       train=False)["flow_final"].float()
        epe = torch.sqrt(torch.sum((flow - gt) ** 2, dim=1))
        tot += float(torch.sum(torch.mean(epe, dim=(1, 2))[:real]))
        n += real
    return tot / n


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="generate -> pretrain -> held-out EPE")
    ap.add_argument("--workdir", default=os.path.join("build", "sim_flow_quality"))
    ap.add_argument("--image_dim", nargs=2, type=int, default=(180, 240))
    # many short videos: flow generalisation needs motion diversity (one
    # affine motion per video), not temporal length
    ap.add_argument("--n_videos", type=int, default=48)
    ap.add_argument("--n_frames", type=int, default=11)
    ap.add_argument("--eval_videos", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--opt", default="adam", choices=["adam", "raft"],
                    help="raft: AdamW + OneCycle + clip(1.0), the upstream RAFT/DCEIFlow "
                         "pretraining recipe (pretrain_flow.make_raft_optimizer)")
    ap.add_argument("--aug", type=int, default=0,
                    help="random h/v flip augmentation (1 = on); off by default, as in "
                         "the JAX script")
    ap.add_argument("--flow_arch", default="dceiflow", choices=["dceiflow", "eraft"],
                    help="eraft: events-only flow over consecutive voxel pairs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Generate, score the zero flow and the untrained net, pretrain,
    score after every epoch, save; returns the JSON line's dict."""
    device = resolve_device(args.device)
    mm = "cista-eraft" if args.flow_arch == "eraft" else "cista-eiflow"
    h, w = args.image_dim
    train_dir = os.path.join(args.workdir, "train")
    eval_dir = os.path.join(args.workdir, "eval")
    if not os.path.exists(os.path.join(train_dir, "train_e2v_estflow.txt")):
        print(f"generating {args.n_videos} training videos at {h}x{w}...")
        sim.write_train_dataset(train_dir, args.n_videos, args.n_frames, h, w, seed=args.seed,
                                speed_range=SPEED_RANGE, omega_range=OMEGA_RANGE)
    if not os.path.exists(os.path.join(eval_dir, "train_e2v_estflow.txt")):
        # held-out seeds: write_train_dataset uses seed + 1000 * video + 1
        sim.write_train_dataset(eval_dir, args.eval_videos, args.n_frames, h, w,
                                seed=args.seed + 777_000, speed_range=SPEED_RANGE,
                                omega_range=OMEGA_RANGE)

    cfg = Config(model_mode=mm, image_dim=(h, w), path_to_train_data=train_dir,
                 path_to_model=os.path.join(args.workdir, "models"), epochs=args.epochs,
                 batch_size=args.batch_size, lr=args.lr, dtype=args.dtype, shuffle=True,
                 seed=args.seed, len_sequence=1)      # independent pairs: no sequences
    eval_ds = sim.SimFlowPairs(Config(model_mode=mm, image_dim=(h, w),
                                      path_to_train_data=eval_dir, dtype=args.dtype,
                                      len_sequence=1))
    # f32 master weights; cfg.dtype sets the compute precision
    model = pf.flow_net(args.flow_arch, cfg, device)

    epe_zero = mean_epe(eval_ds, cfg, model, args.batch_size, device, zero_flow=True)
    epe_init = mean_epe(eval_ds, cfg, model, args.batch_size, device)
    print(f"EPE zero-flow baseline: {epe_zero:.3f}   untrained: {epe_init:.3f}")

    train_ds = sim.SimFlowPairs(cfg, aug=bool(args.aug))
    print(f"SimFlowPairs: {len(train_ds)} training pairs")
    optimizer = pf.make_flow_optimizer(model, cfg, args.opt,
                                       max(1, len(train_ds) // cfg.batch_size))
    step = pf.make_train_step(cfg, optimizer, is_bi=False, flow_arch=args.flow_arch)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(args.epochs):
        timer = StepTimer(f"epoch{epoch + 1}")
        for i, batch in enumerate(pf.make_batches(train_ds, cfg.batch_size, True, rng)):
            tb = pf.to_device(batch, device)
            timer.start()
            loss, epe = step(model, tb)
            timer.stop(loss)
            if i % 20 == 0:
                print(f"Epoch {epoch + 1} [{i * cfg.batch_size}/{len(train_ds)}] "
                      f"loss: {float(loss):.4f} epe: {float(epe):.3f}")
        print(timer)
        epe_val = mean_epe(eval_ds, cfg, model, args.batch_size, device)
        print(f"held-out EPE after epoch {epoch + 1}: {epe_val:.3f}")

    epe_trained = mean_epe(eval_ds, cfg, model, args.batch_size, device)
    out_dir = os.path.join(args.workdir, "models")
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.join(out_dir, f"{args.flow_arch}_sim_{args.epochs}.pth.tar")
    weights.save_checkpoint(ckpt, model, args.epochs - 1, key="model")
    return {"epe_zero": round(epe_zero, 3), "epe_init": round(epe_init, 3),
            "epe_trained": round(epe_trained, 3),
            "beats_zero_flow": bool(epe_trained < epe_zero), "epochs": args.epochs,
            "ckpt": ckpt}


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
