"""Where the time of the closed-loop serving step goes, on the card.

    python -m cista_flow_torch.profile_step --iters 1 --depth 1 \\
        --weights gate/flagship_ft1_f16.npz [--batch 8] [--steps 8] [--dtype bfloat16]

Runs ``Reconstructor.run_window`` at 180x240 on seeded voxels, after one
warm-up window, and prints:
 * host ms per step around a synchronized window, and frames/s;
 * device ms per step of each stage, from CUDA events recorded by forward
   hooks on the stage modules (the encoders, the fusion, the update block,
   CISTA-LSTC); "flow net, other" is the pyramid, the K1 lookups and the
   upsampling, "warps" the two K2 warps and the half-res flow;
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
from .runner import Reconstructor

STAGES = ("event_flownet.enet", "event_flownet.fnet", "event_flownet.cnet",
          "event_flownet.fusion", "event_flownet.update_block", "cista_net",
          "event_flownet", "")


class StageTimer:
    """CUDA events around each call of the named submodules ("" = the whole
    composite step); ``ms()`` sums each stage's device time."""

    def __init__(self, model, names):
        self.spans = {n: [] for n in names}
        self.handles = []
        for n in names:
            mod = model.get_submodule(n) if n else model
            self.handles.append(mod.register_forward_pre_hook(self._pre(n)))
            self.handles.append(mod.register_forward_hook(self._post(n)))

    def _pre(self, name):
        def hook(mod, args):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[name].append([ev, None])
        return hook

    def _post(self, name):
        def hook(mod, args, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans[name][-1][1] = ev
        return hook

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(a.elapsed_time(b) for a, b in s) for n, s in self.spans.items()}

    def close(self):
        for h in self.handles:
            h.remove()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--weights", default="gate/flagship_ft1_f16.npz")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg = Config(image_dim=(180, 240), depth=args.depth, flow_iters=args.iters,
                 dtype=args.dtype, path_to_test_model=args.weights)
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

    timer = StageTimer(rec.model, STAGES)
    rec.run_window(ev)
    st = {k: v / args.steps for k, v in timer.ms().items()}
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

    flow = st["event_flownet"]
    enc = sum(st[f"event_flownet.{n}"] for n in ("enet", "fnet", "cnet", "fusion"))
    print(f"({args.iters},{args.depth}) {args.dtype} batch {args.batch}, {smi}")
    print(f"  host {wall:.3f} ms/step = {args.batch * 1e3 / wall:.1f} frames/s")
    print(f"  device ms/step by stage (CUDA events): step {st['']:.3f}")
    for name, v in (("enet", st["event_flownet.enet"]), ("fnet", st["event_flownet.fnet"]),
                    ("cnet", st["event_flownet.cnet"]),
                    ("fusion", st["event_flownet.fusion"]),
                    ("update block x iters", st["event_flownet.update_block"]),
                    ("flow net, other", flow - enc - st["event_flownet.update_block"]),
                    ("warps", st[""] - flow - st["cista_net"]),
                    ("cista_lstc", st["cista_net"])):
        print(f"    {name:<22s} {v:8.3f}  {100 * v / st['']:5.1f}%")
    per_step = busy / args.steps
    print(f"  device busy {per_step:.3f} ms/step of {wall:.3f} ms host wall "
          f"({100 * per_step / wall:.1f}%; kernel sum of a torch.profiler trace, "
          f"whose own window the profiler stretched to {traced / args.steps:.3f} "
          f"ms/step); kernels by device time per step:")
    for e in kern[:15]:
        print(f"    {e.device_time_total / 1e3 / args.steps:8.3f} ms  x{e.count // args.steps:<4d} "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
