"""The quality loop on simulated event data: generate -> train -> eval.

    python -m cista_flow_torch.sim_quality [--workdir build/sim_quality]
        [--model_mode cista-gtflow] [--epochs 40] [--dtype bfloat16] [--device cpu]

Counterpart of the root ``sim_quality.py`` of the JAX package (ref of its
protocol: test_with_flow.py:24-233 for the metrics, train.py:27-269 for the
schedule), with its flags and defaults (cista-gtflow, 180x240, 16 videos of
61 frames, 30 eval frames, 40 epochs, batch 8, T = 10, bf16) and
``--device``; the work directory defaults to ``build/sim_quality`` under the
current directory. The training videos come from the port's simulator
(``data.sim.write_train_dataset``), the two held-out sequences from
``data.sim.ensure_eval_data`` (the quality gate's); the network trains from
scratch through ``train.Trainer`` (the phase schedule, BPTT, ``.pth.tar``
saves), and is scored before and after through the with-flow eval
(``test_with_flow.evaluate_sequences``). Prints one JSON line with the JAX
script's keys: psnr, ssim, mse and epe, each ``_init`` and ``_trained``,
``epochs`` and ``ckpt``. An untrained net emits a flat grey frame, so
psnr_trained should be far above psnr_init.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .config import Config
from .data import sim
from .runner import model_name_from_cfg


def ensure_data(workdir, h, w, n_videos, n_frames, eval_frames, seed):
    """(training folder, eval folder), written once under ``workdir``."""
    train_dir = os.path.join(workdir, "train")
    if not os.path.exists(os.path.join(train_dir, "train_e2v_estflow.txt")):
        print(f"generating training data ({n_videos} videos x {n_frames} frames at {h}x{w})...")
        sim.write_train_dataset(train_dir, n_videos, n_frames, h, w, seed=seed)
    return train_dir, sim.ensure_eval_data(workdir, h, w, eval_frames, seed)


def run_eval(workdir, eval_dir, h, w, dtype, device, ckpt=None, tag="init",
             model_mode="cista-gtflow", depth=5) -> dict:
    """The with-flow eval's mean row as {metric: value}."""
    from .test_with_flow import evaluate_sequences

    cfg = Config(model_mode=model_mode, image_dim=(h, w),
                 is_gt_flow=model_mode == "cista-gtflow", path_to_test_data=eval_dir,
                 test_data_mode="upsampled", output_folder=os.path.join(workdir, f"out_{tag}"),
                 path_to_test_model=ckpt or "", dtype=dtype, depth=depth, is_write_image=True)
    return evaluate_sequences(cfg, device=device)[2]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="generate -> train -> eval on simulated data")
    ap.add_argument("--workdir", default=os.path.join("build", "sim_quality"))
    ap.add_argument("--image_dim", nargs=2, type=int, default=(180, 240))
    ap.add_argument("--n_videos", type=int, default=16)
    ap.add_argument("--n_frames", type=int, default=61)
    ap.add_argument("--eval_frames", type=int, default=30)
    ap.add_argument("--model_mode", default="cista-gtflow",
                    help="cista-gtflow (rec-only, GT flow) or a full composite, e.g. "
                         "cista-eraft (3-phase schedule, flow net trained from scratch, "
                         "eval on the estimated flow)")
    ap.add_argument("--path_to_flownet", default="",
                    help="flow-net checkpoint to start the composite from")
    ap.add_argument("--flow_epoch", type=int, default=0)
    ap.add_argument("--rec_epoch", type=int, default=None,
                    help="default: epochs - flow_epoch (no phase 3)")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--len_sequence", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_train", action="store_true",
                    help="evaluate an existing checkpoint only")
    ap.add_argument("--load_epoch_for_train", type=int, default=0,
                    help="resume training from this saved epoch (-1: the newest "
                         "full-state save)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Generate, evaluate the untrained net, train, evaluate the trained
    one; returns the JSON line's dict."""
    h, w = args.image_dim
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.perf_counter()
    train_dir, eval_dir = ensure_data(args.workdir, h, w, args.n_videos, args.n_frames,
                                      args.eval_frames, args.seed)
    t_data = time.perf_counter()
    # flow_epoch 0 and rec_epoch = epochs put the last save at the run's end
    rec_epoch = args.epochs - args.flow_epoch if args.rec_epoch is None else args.rec_epoch
    tcfg = Config(model_mode=args.model_mode, image_dim=(h, w), path_to_train_data=train_dir,
                  path_to_model=os.path.join(args.workdir, "models"), epochs=args.epochs,
                  flow_epoch=args.flow_epoch, rec_epoch=rec_epoch,
                  batch_size=args.batch_size, len_sequence=args.len_sequence, lr=args.lr,
                  depth=args.depth, dtype=args.dtype, remat=args.remat, shuffle=True,
                  seed=args.seed, path_to_flownet=args.path_to_flownet,
                  load_epoch_for_train=args.load_epoch_for_train)
    name = model_name_from_cfg(tcfg)
    ckpt = os.path.join(args.workdir, "models", name, f"{name}_{args.epochs}.pth.tar")

    metrics_init = run_eval(args.workdir, eval_dir, h, w, args.dtype, args.device, None,
                            "init", args.model_mode, args.depth)
    t_eval = time.perf_counter()
    if not args.skip_train and not os.path.exists(ckpt):
        from .train import Trainer
        Trainer(tcfg, args.device).run()
    if not os.path.exists(ckpt):
        raise FileNotFoundError(f"training did not produce {ckpt}")
    t_train = time.perf_counter()
    metrics_trained = run_eval(args.workdir, eval_dir, h, w, args.dtype, args.device, ckpt,
                               "trained", args.model_mode, args.depth)
    t_end = time.perf_counter()
    print(f"sim_quality seconds (host clock): data {t_data - t0:.1f}, eval {t_eval - t_data:.1f}, "
          f"train {t_train - t_eval:.1f}, eval {t_end - t_train:.1f}, total {t_end - t0:.1f}")

    out = {"psnr_init": round(metrics_init["psnr"], 3),
           "psnr_trained": round(metrics_trained["psnr"], 3),
           "ssim_init": round(metrics_init["ssim"], 4),
           "ssim_trained": round(metrics_trained["ssim"], 4),
           "mse_init": round(metrics_init["mse"], 6),
           "mse_trained": round(metrics_trained["mse"], 6),
           "epochs": args.epochs, "ckpt": ckpt}
    if "epe" in metrics_trained:
        out["epe_init"] = round(metrics_init["epe"], 3)
        out["epe_trained"] = round(metrics_trained["epe"], 3)
    return out


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
