"""Where the time of the closed-loop serving window goes, on the card.

    python -m cista_flow_torch.profile_step --iters 1 --depth 1 \\
        --weights gate/flagship_ft1_f16.npz [--batch 8] [--steps 8] [--dtype bfloat16]
    python -m cista_flow_torch.profile_step --model cista-eraft --iters 12 --depth 5 \\
        --weights gate/eraft_sim40_f16.npz
    python -m cista_flow_torch.profile_step --model cista-idnet --iters 1 --depth 2 \\
        --weights gate/idnet_ft2_f16.npz
    python -m cista_flow_torch.profile_step --train --iters 6 --depth 5 \\
        --weights gate/flagship_sim40_f16.npz --batch 4 --steps 10

``--train`` profiles one cista-eiflow train step instead (``profile_train``).

Runs ``Reconstructor.step_window`` (every step's frames and flows returned)
at 180x240 on seeded voxels, after one warm-up window, and prints:
 * host ms per step of an untraced window, host voxels in to host frames
   out, and frames/s;
 * the program's spans (``utils.profiling.annotate``) in a window traced by
   ``utils.profiling.trace`` (written under ``build/profile_step``), per
   step: host ms inside each, device ms of the kernels, copies and fills
   launched inside, launches, and the operation with most host time inside
   (``trace_tools.span_summary``): ``runner.call`` holds
   ``runner.upload``, ``runner.issue`` (``flownet`` with its
   ``flownet.encode`` and ``flownet.update``; ``reconstruct``, the warps
   and CISTA-LSTC), ``runner.wait`` and ``runner.download``; cista-idnet's
   flow net has the ``flownet`` span alone. Then the counters;
 * the device-busy share (the sum of kernel times per step in the traced
   window over the untraced host ms per step) and the kernels by device
   time.
Needs a CUDA card; prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .config import Config
from .runner import Reconstructor
from .utils import profiling, trace_tools

MODES = ("cista-eiflow", "cista-eraft", "cista-idnet")
DEFAULT_WEIGHTS = {"cista-eiflow": "gate/flagship_ft1_f16.npz",
                   "cista-eraft": "gate/eraft_ft1_f16.npz",
                   "cista-idnet": "gate/idnet_ft2_f16.npz"}
LOGDIR = "build/profile_step"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="cista-eiflow", choices=MODES)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--weights", default=None,
                    help="default: the (1,1) gate anchor of the model")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--train", action="store_true",
                    help="one cista-eiflow train step (--steps is its unroll length)")
    args = ap.parse_args(argv)
    if args.train:
        from .profile_train import run
        return run(args.iters, args.depth, args.weights or DEFAULT_WEIGHTS["cista-eiflow"],
                   args.batch, args.steps, args.dtype)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg = Config(image_dim=(180, 240), model_mode=args.model, depth=args.depth,
                 flow_iters=args.iters, dtype=args.dtype,
                 path_to_test_model=args.weights or DEFAULT_WEIGHTS[args.model])
    rec = Reconstructor(cfg, device="cuda", batch=args.batch)
    rng = np.random.default_rng(0)
    shape = (args.steps, args.batch, cfg.num_bins, 180, 240)
    vox = rng.standard_normal(shape).astype(np.float32) * (rng.random(shape) < 0.05)
    rec.step_window(vox, return_all=True)          # warm-up: builds and loads

    t0 = time.perf_counter()
    rec.step_window(vox, return_all=True)
    wall = (time.perf_counter() - t0) * 1e3 / args.steps

    with profiling.trace(LOGDIR) as prof:
        rec.step_window(vox, return_all=True)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith(profiling.PREFIX)]
    kern.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in kern) / 1e3

    print(f"{args.model} ({args.iters},{args.depth}) {args.dtype} batch {args.batch}, "
          f"{args.steps}-step window, {smi}")
    print(f"  host {wall:.3f} ms/step = {args.batch * 1e3 / wall:.1f} frames/s "
          "(host voxels in, host frames and flows out)")
    trace_tools.print_spans(LOGDIR, runs=args.steps)
    per_step = busy / args.steps
    print(f"  device busy {per_step:.3f} ms/step of {wall:.3f} ms host wall "
          f"({100 * per_step / wall:.1f}%; kernel sum of the traced window); "
          "kernels by device time per step:")
    for e in kern[:15]:
        print(f"    {e.device_time_total / 1e3 / args.steps:8.3f} ms  x{e.count / args.steps:<6.1f} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
