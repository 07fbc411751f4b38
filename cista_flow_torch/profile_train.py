"""Where the time of one BPTT train step goes, on the card.

    python -m cista_flow_torch.profile_step --train --iters 6 --depth 5 \\
        --weights gate/flagship_sim40_f16.npz [--batch 4] [--steps 10] [--dtype bfloat16]

One optimizer step of cista-eiflow at 180x240 over ``--steps`` unroll steps
of seeded data (voxels, frames in [0, 1], flows), in phase 3's flow half
(the flow net trains and its gradient runs through the reconstructor) and
in phase 2 (the reconstructor trains), after one warm-up step of each.
Prints, per phase:
 * device ms of the forward (the unroll and its losses), the backward and
   the optimizer step, from CUDA events around each in a step the profiler
   does not trace;
 * the forward by the program's spans (``utils.profiling.annotate``: the
   flow net, its encoders and its GRU iterations, the warps and
   CISTA-LSTC), the device ms of the work launched inside each in a traced
   forward (``trace_tools.span_summary``);
 * K1-K5: each kernel's device ms in the forward (its kernels' time in a
   torch.profiler trace) and in the backward (the work launched inside the
   spans ``backward.K<n>`` of ``KernelFunction.backward``: the plain
   version's recompute and its adjoint);
 * the ten largest device operations of the backward (a profiler trace
   over ``loss.backward()``);
 * the device-busy share: the kernel sum of a traced step over the host
   time of an untraced synchronised one; and the peak memory.
Needs a CUDA card; prints its name and power limit beside the numbers.
"""
from __future__ import annotations

import contextlib
import subprocess
import time

import torch

from . import weights
from .config import Config
from .device import DTYPES, cudnn_fp32
from .models import composite
from .parallel import train_step as TS
from .utils import profiling, trace_tools

H, W = 180, 240
# kernel -> the names of its CUDA kernels (csrc/*.cu), K3's first: its
# direct tile is also a "conv3x3" kernel
KERNEL_NAMES = {"K3": ("ista_conv_mma_kernel", "regroup_kernel", "conv3x3_reflect_kernel"),
                "K1": ("corr_mma_kernel", "corr_core_kernel"),
                "K2": ("warp_reflect_kernel",),
                "K4": ("instance_norm_",),
                "K5": ("conv3x3_mma_kernel", "conv3x3_kernel")}
PHASES = (("rec", "both", "phase 3, flow half"), ("flow", "rec", "phase 2"))
LOGDIR = "build/profile_train"


def kernel_of(name: str):
    for key, names in KERNEL_NAMES.items():
        if any(n in name for n in names):
            return key
    return None


def seeded_sequence(t_len: int, batch: int, bins: int, seed: int = 0) -> dict:
    """(T, B, C, H, W) f32 tensors on the card: sparse voxels, smooth frames,
    flows of a few pixels."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=g, device="cuda")
    vox = torch.randn(t_len, batch, bins, H, W, generator=g, device="cuda")
    vox = vox * (rand(t_len, batch, bins, H, W) < 0.05)
    low = rand(t_len + 1, batch, 1, H // 8, W // 8)
    frames = torch.nn.functional.interpolate(low.flatten(0, 1), size=(H, W), mode="bilinear",
                                             align_corners=False).view(t_len + 1, batch, 1, H, W)
    flow = 3.0 * torch.randn(t_len, batch, 2, 1, 1, generator=g, device="cuda").expand(
        t_len, batch, 2, H, W).contiguous()
    return {"event_voxel": vox, "gt_img0": frames[:-1].contiguous(),
            "gt_img1": frames[1:].contiguous(), "gt_flow": flow}


def run_phase(model, cfg, seq, fix, mode, tag, smi):
    dtype = DTYPES[cfg.dtype]
    opt = TS.make_optimizer(model, 1e-4)
    step = TS.make_train_step(cfg, opt, mode, fix, False)
    step(model, seq)                                       # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(model, seq)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = sorted(walls)[1]

    precision = cudnn_fp32 if dtype == torch.float32 else contextlib.nullcontext
    model.train()
    TS.freeze(model, fix)

    def forward():
        with TS.parameters_as(model, dtype):
            return TS.unroll_loss(model, seq, cfg, mode, fix, False, dtype)

    # an untraced step: CUDA events around its parts
    opt.zero_grad(set_to_none=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with precision():
        ev[0].record()
        loss = forward()
        ev[1].record()
        loss.backward()
        ev[2].record()
    TS.optimizer_step(model, opt)
    ev[3].record()
    torch.cuda.synchronize()
    fwd, bwd, upd = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))

    # a traced step: the kernels and the program's spans of the forward and
    # of the backward
    opt.zero_grad(set_to_none=True)
    fdir, bdir = f"{LOGDIR}/{fix}_{mode}_forward", f"{LOGDIR}/{fix}_{mode}_backward"
    with precision():
        with profiling.trace(fdir) as fprof:
            traced = forward()
            torch.cuda.synchronize()
        with profiling.trace(bdir) as bprof:
            traced.backward()
            torch.cuda.synchronize()
    opt.zero_grad(set_to_none=True)
    stages = {r[0]: r[3] for r in trace_tools.span_summary(fdir)}
    kernel_bw = {r[0].split(".")[-1]: (r[3], int(r[1])) for r in trace_tools.span_summary(bdir)}

    def kernels(prof):
        """The device's kernels and copies; not the spans' own copies on the
        device timeline (user annotations), which a trace lists beside them."""
        return [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.key.startswith(profiling.PREFIX)]
    fk, bk = kernels(fprof), kernels(bprof)
    kernel_fw = {}
    for e in fk:
        key = kernel_of(e.key)
        if key:
            ms, n = kernel_fw.get(key, (0.0, 0))
            kernel_fw[key] = (ms + e.device_time_total / 1e3, n + e.count)
    busy = (sum(e.device_time_total for e in fk) + sum(e.device_time_total for e in bk)) / 1e3

    t_len, batch = seq["event_voxel"].shape[:2]
    print(f"{tag}: cista-eiflow ({cfg.default_flow_iters()},{cfg.depth}) {cfg.dtype}, T={t_len}, "
          f"batch {batch}, {H}x{W}, {smi}")
    print(f"  loss {float(loss.detach()):.5f}; device ms (CUDA events, gaps included): "
          f"forward {fwd:.2f}, backward {bwd:.2f}, optimizer {upd:.2f}; host wall of an "
          "untraced step, median of 3: " + f"{wall:.2f} ms ("
          + ", ".join(f"{w:.2f}" for w in walls) + ")")
    print(f"  device busy {busy:.2f} ms of kernels in the traced forward + backward, "
          f"{100 * busy / wall:.1f}% of the untraced step's host wall")
    f_busy = sum(e.device_time_total for e in fk) / 1e3
    rows = [("flownet", stages.get("flownet", 0.0)),
            ("  flownet.encode", stages.get("flownet.encode", 0.0)),
            ("  flownet.update", stages.get("flownet.update", 0.0)),
            ("reconstruct", stages.get("reconstruct", 0.0)),
            ("losses and the rest", f_busy - stages.get("flownet", 0.0)
             - stages.get("reconstruct", 0.0))]
    print(f"  forward by span, device ms launched inside (traced forward, {f_busy:.2f} ms of "
          "device work):")
    for name, v in rows:
        print(f"    {name:<22s} {v:9.2f}  {100 * v / f_busy:5.1f}%")
    print("  kernels: forward, kernel ms (profiler); backward (plain recompute + adjoint), "
          "device ms launched inside its spans backward.K<n> (profiler):")
    for key in ("K1", "K2", "K3", "K4", "K5"):
        f_ms, f_n = kernel_fw.get(key, (0.0, 0))
        b_ms, b_n = kernel_bw.get(key, (0.0, 0))
        print(f"    {key}: forward {f_ms:8.2f} ms ({f_n} CUDA kernels); backward "
              f"{b_ms:8.2f} ms ({b_n} calls, {100 * b_ms / bwd:5.1f}% of the backward's "
              "CUDA-event span)")
    bk.sort(key=lambda e: -e.device_time_total)
    print("  the backward's ten largest device operations:")
    for e in bk[:10]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms  x{e.count:<5d} {e.key[:100]}")


def run(iters: int, depth: int, weights_path: str, batch: int, steps: int, dtype: str):
    if not torch.cuda.is_available():
        raise SystemExit("profile_step --train needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg = Config(image_dim=(H, W), model_mode="cista-eiflow", depth=depth, flow_iters=iters,
                 dtype=dtype)
    seq = seeded_sequence(steps, batch, cfg.num_bins)
    for fix, mode, tag in PHASES:
        model = composite.init(cfg, device="cpu")
        model.load_reference_state(weights.load_state_dict(weights_path))
        model.to("cuda")
        torch.cuda.reset_peak_memory_stats()
        run_phase(model, cfg, seq, fix, mode, tag, smi)
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del model
        torch.cuda.empty_cache()
