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

Runs ``Reconstructor.run_window`` at 180x240 on seeded voxels, after one
warm-up window, and prints:
 * host ms per step around a synchronized window, and frames/s;
 * device ms per step of each stage, from CUDA events around the stage
   modules (forward hooks) and the stage functions (the correlation pyramid
   and, for cista-eraft, the convex upsampling). cista-eiflow: the three
   encoders, the fusion, the update block; "flow net, other" is the pyramid,
   the K1 lookups and the upsampling. cista-eraft (the time-parallel
   window): fnet over the window's T+1 voxels, cnet over T, then the
   pyramid, the update block x iters, the K1 lookups and the upsampling of
   the one flow call. Both: "warps" are the two K2 warps and the half-res
   flow, then CISTA-LSTC;
 * the device-busy share (the sum of kernel times per step in a
   torch.profiler trace over the untraced host ms per step) and the
   kernels by device time.
Needs a CUDA card; prints the card's name and power limit beside the numbers.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from .config import Config
from .models import dceiflow, eraft, idnet
from .runner import Reconstructor

MODULES = {"cista-eiflow": ("event_flownet.enet", "event_flownet.fnet", "event_flownet.cnet",
                            "event_flownet.fusion", "event_flownet.update_block",
                            "event_flownet", "cista_net"),
           "cista-eraft": ("event_flownet.fnet", "event_flownet.cnet",
                           "event_flownet.update_block", "event_flownet", "cista_net"),
           "cista-idnet": ("event_flownet.fnet", "event_flownet.update_net.gru",
                           "event_flownet.update_net.flow_head", "event_flownet.update_net.mask",
                           "event_flownet.update_net.flow_head2",
                           "event_flownet.update_net.mask2", "event_flownet", "cista_net")}
DEFAULT_WEIGHTS = {"cista-eiflow": "gate/flagship_ft1_f16.npz",
                   "cista-eraft": "gate/eraft_ft1_f16.npz",
                   "cista-idnet": "gate/idnet_ft2_f16.npz"}


class StageTimer:
    """CUDA events around each call of the named submodules and of the
    named module-level functions (patched while the timer is open);
    ``ms()`` sums each stage's device time."""

    def __init__(self, model, names, functions=()):
        self.spans = {n: [] for n in names}
        self.handles = []
        self.patched = []
        for n in names:
            mod = model.get_submodule(n)
            self.handles.append(mod.register_forward_pre_hook(
                lambda mod, args, n=n: self._start(n)))
            self.handles.append(mod.register_forward_hook(
                lambda mod, args, out, n=n: self._stop(n)))
        for name, owner, attr in functions:
            self.spans[name] = []
            fn = getattr(owner, attr)
            self.patched.append((owner, attr, fn))
            setattr(owner, attr, self._timed(name, fn))

    def _start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.spans[name].append([ev, None])

    def _stop(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.spans[name][-1][1] = ev

    def _timed(self, name, fn):
        def wrapper(*args, **kwargs):
            self._start(name)
            out = fn(*args, **kwargs)
            self._stop(name)
            return out
        return wrapper

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in s) for n, s in self.spans.items()}

    def close(self):
        for h in self.handles:
            h.remove()
        for owner, attr, fn in self.patched:
            setattr(owner, attr, fn)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="cista-eiflow", choices=sorted(MODULES))
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
    ev = rec.device_events(vox)
    rec.run_window(ev)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.run_window(ev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / args.steps

    if args.model == "cista-idnet":
        functions = [("deblur", idnet, "deblur")]
    else:
        flow_mod = eraft if args.model == "cista-eraft" else dceiflow
        functions = [("pyramid", flow_mod.CORR, "build_corr_pyramid")]
    if args.model == "cista-eraft":
        functions.append(("upsample", eraft, "convex_upsample"))
    timer = StageTimer(rec.model, MODULES[args.model], functions)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    rec.run_window(ev)
    b.record()
    st = {k: v / args.steps for k, v in timer.ms().items()}
    st["window"] = a.elapsed_time(b) / args.steps
    timer.close()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.run_window(ev)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kern.sort(key=lambda e: -e.device_time_total)
    busy = sum(e.device_time_total for e in kern) / 1e3

    net = "event_flownet."
    if args.model == "cista-idnet":
        gru_heads = sum(st[net + "update_net." + n]
                        for n in ("gru", "flow_head", "mask", "flow_head2", "mask2"))
        rows = [("deblur", st["deblur"]), ("lite encoder", st[net + "fnet"]),
                ("GRU + heads", gru_heads),
                ("flow net, other", st["event_flownet"] - st["deblur"] - st[net + "fnet"]
                 - gru_heads),
                ("warps", st["window"] - st["event_flownet"] - st["cista_net"])]
    elif args.model == "cista-eraft":
        # fnet and cnet run outside the flow call in the time-parallel window
        rows = [("fnet", st[net + "fnet"]), ("cnet", st[net + "cnet"]),
                ("pyramid", st["pyramid"]),
                ("update block x iters", st[net + "update_block"]),
                ("K1 lookups", st["event_flownet"] - st["pyramid"]
                 - st[net + "update_block"] - st["upsample"]),
                ("upsample", st["upsample"]),
                ("warps", st["window"] - st[net + "fnet"] - st[net + "cnet"]
                 - st["event_flownet"] - st["cista_net"])]
    else:
        enc = sum(st[net + n] for n in ("enet", "fnet", "cnet", "fusion"))
        rows = [(n, st[net + n]) for n in ("enet", "fnet", "cnet", "fusion")]
        rows += [("pyramid", st["pyramid"]),
                 ("update block x iters", st[net + "update_block"]),
                 ("flow net, other", st["event_flownet"] - enc - st["pyramid"]
                  - st[net + "update_block"]),
                 ("warps", st["window"] - st["event_flownet"] - st["cista_net"])]
    rows.append(("cista_lstc", st["cista_net"]))
    print(f"{args.model} ({args.iters},{args.depth}) {args.dtype} batch {args.batch}, "
          f"{args.steps}-step window, {smi}")
    print(f"  host {wall:.3f} ms/step = {args.batch * 1e3 / wall:.1f} frames/s")
    print(f"  device ms/step by stage (CUDA events): window {st['window']:.3f}")
    for name, v in rows:
        print(f"    {name:<22s} {v:8.3f}  {100 * v / st['window']:5.1f}%")
    per_step = busy / args.steps
    print(f"  device busy {per_step:.3f} ms/step of {wall:.3f} ms host wall "
          f"({100 * per_step / wall:.1f}%; kernel sum of a torch.profiler trace, "
          f"whose own window the profiler stretched to {traced / args.steps:.3f} "
          f"ms/step); kernels by device time per step:")
    for e in kern[:15]:
        print(f"    {e.device_time_total / 1e3 / args.steps:8.3f} ms  x{e.count / args.steps:<6.1f} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
