#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (cista_flow_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is non-zero):
 1. the card: ``nvidia-smi`` name and power limit, torch's device name;
 2. build the four CUDA kernels from ``cista_flow_torch/csrc`` (one nvcc
    each, in parallel) into the ignored ``build/kernels``;
 3. each kernel against its plain PyTorch version on the card, at the
    flagship shapes (180x240 frames, batch 8), in bf16 and f32 with TF32
    off: max abs error against a stated tolerance, and the median time of
    the kernel, of the plain version and, where one PyTorch call computes
    the same function, of that call (``library_ms``; the port never calls
    it);
 4. the main path: ``Reconstructor.step_window`` on the committed gate
    weights at 180x240, at (iters, depth) = (1, 1) and (6, 5), 16 steps of
    seeded voxels in f32 and bf16, with every kernel's launch count checked
    and bf16 held above 30 dB PSNR against f32 at every step; the CUDA path
    held against the same port on the CPU (plain versions) over 3 steps;
    closed-loop frames/s at batch 8 in bf16 (3 reps).
The last lines are the ``kernels`` JSON, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, W = 180, 240
BATCH = 8
STEPS = 16
PSNR_MIN = 30.0          # the JAX package's bf16 drift rule (tests/test_bf16_drift.py)
POINTS = ((1, 1, "gate/flagship_ft1_f16.npz"), (6, 5, "gate/flagship_sim40_f16.npz"))
HBM_BYTES_PER_S = 3.35e12                                    # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}            # tensor-core bf16; f32 non-tensor


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "cista_flow_torch" / "csrc").is_dir():
        print("chip_smoke: cista_flow_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 1. the card ------------------------------------------------------
    smi = nvidia_smi()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    from cista_flow_torch.ops import cuda_aug, cuda_build, cuda_corr, cuda_ista2, cuda_norm
    kernels = {"K1": cuda_corr.KERNEL, "K2": cuda_aug.KERNEL,
               "K3": cuda_ista2.KERNEL, "K4": cuda_norm.KERNEL}
    secs = cuda_build.build_all(list(kernels.values()))
    print(f"build: {secs:.1f} s for {len(kernels)} kernels")
    for k in kernels.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.name}: {line.strip()}")

    # ---- 3. kernels against their plain versions --------------------------
    checks = kernel_checks(torch, cuda_aug, cuda_corr, cuda_ista2, cuda_norm)
    torch.cuda.synchronize()

    # ---- 4. the main path -------------------------------------------------
    launches = main_path(torch, repo, kernels)

    rows = []
    meta = {
        "K1": ("corr_lookup_convc1", "cista_flow_torch/csrc/corr.cu",
               "cista_flow_tpu/ops/pallas_corr.py:332"),
        "K2": ("warp_reflect", "cista_flow_torch/csrc/warp.cu",
               "cista_flow_tpu/ops/pallas_aug.py:61"),
        "K3": ("ista_loop_dg", "cista_flow_torch/csrc/ista.cu",
               "cista_flow_tpu/ops/pallas_ista2.py:302"),
        "K4": ("instance_norm", "cista_flow_torch/csrc/norm.cu",
               "cista_flow_tpu/ops/pallas_norm.py:91"),
    }
    for key, (name, source, replaces) in meta.items():
        c = checks[key]
        rows.append({"name": f"{key} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------------
def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` launches, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return float(statistics.median(ts))


def bound(nbytes: float, ops: float, dtype: str):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def compare(torch, name, dtype, out, ref, tol):
    """Max abs error of a kernel output against its plain version's f32
    result; raises beyond ``tol``."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))
    ok = err <= tol and all(bool(torch.isfinite(o).all()) for o in outs)
    print(f"  {name:<34s} {dtype:<9s} max_abs_err {err:.3e}  tol {tol:.3e}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {dtype}: max abs error {err} > {tol}")
    return err


def f32_tol(ref) -> float:
    """1e-5 relative to the output's largest magnitude: f32 sums of a few
    hundred to a thousand products taken in another order than the plain
    version's (cuDNN, TF32 off), compounded over chained convs."""
    refs = ref if isinstance(ref, tuple) else (ref,)
    return 1e-5 * max(max(float(r.abs().max()) for r in refs), 1.0)


def bf16_tol(ref, ulps: float) -> float:
    """``ulps`` bf16 rounding steps (2^-8 relative) at the output's largest
    magnitude: the kernel and its plain version each round once to bf16."""
    refs = ref if isinstance(ref, tuple) else (ref,)
    top = max(float(r.float().abs().max()) for r in refs)
    return ulps * 2.0 ** -8 * max(top, 1.0)


def window_entries(coords, sizes, radius: int = 4) -> int:
    """Pyramid entries K1 must read for these coords: per sample and level,
    the in-range part of the (2r+2)^2 block of bilinear corners around
    coords/2^l (the lookup reads no entry outside it)."""
    total = 0
    for lvl, (hl, wl) in enumerate(sizes):
        c = (coords / 2.0 ** lvl).floor()
        lo, hi = c - radius, c + radius + 1
        nx = (hi[:, 0].clamp(max=wl - 1) - lo[:, 0].clamp(min=0) + 1).clamp(min=0)
        ny = (hi[:, 1].clamp(max=hl - 1) - lo[:, 1].clamp(min=0) + 1).clamp(min=0)
        total += int((nx * ny).sum())
    return total


def kernel_checks(torch, cuda_aug, cuda_corr, cuda_ista2, cuda_norm):
    """Phase 3. Each kernel on seeded inputs at the flagship shapes; the
    plain version runs on the same inputs (upcast to f32 for bf16, so that
    the reference carries no bf16 rounding of its own)."""
    import torch.nn.functional as F
    from cista_flow_torch.ops.corr import CorrPyramid, coords_grid
    from cista_flow_torch.ops.warp import frame_warp_coords

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    results = {}
    print("kernels vs plain versions (batch 8, flagship shapes):")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()

        # K1: 4 pyramid levels at 1/8 res of the padded 192x256 frame
        b, h1, w1 = BATCH, 24, 32
        n = b * h1 * w1
        sizes = ((24, 32), (12, 16), (6, 8), (3, 4))
        levels = tuple(randn(n, hl, wl).to(dt) for hl, wl in sizes)
        pyr = CorrPyramid(levels, b, h1, w1)
        coords = coords_grid(b, h1, w1, dev) + randn(b, 2, h1, w1, scale=4.0)
        coords[0, :, 0, :4] = torch.tensor([[-1e4, 5e3, 40.5, -9.0],
                                            [3e4, -2e4, -4.5, 30.0]], device=dev)
        wproj = randn(256, 324, 1, 1, scale=324 ** -0.5).to(dt)
        bproj = randn(256, scale=0.1).to(dt)
        pyr32 = CorrPyramid(tuple(lv.float() for lv in levels), b, h1, w1)
        ref = cuda_corr.lookup_plain(pyr32, coords)
        out = cuda_corr.lookup(pyr, coords)
        compare(torch, "K1 lookup (324 ch)", dtype, out, ref,
                1e-5 if dtype == "float32" else bf16_tol(ref, 2))
        ref = cuda_corr.lookup_plain(pyr32, coords, wproj.float(), bproj.float())
        out = cuda_corr.lookup(pyr, coords, wproj, bproj)
        err = compare(torch, "K1 lookup + convc1 (256 ch)", dtype, out, ref,
                      f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 4))
        ms = time_ms(torch, lambda: cuda_corr.lookup(pyr, coords, wproj, bproj))
        plain = time_ms(torch, lambda: cuda_corr.lookup_plain(pyr, coords, wproj, bproj))
        nbytes = (window_entries(coords, sizes) * es + coords.numel() * 4
                  + (wproj.numel() + bproj.numel()) * es + n * 256 * es)
        ops = n * (2 * 324 * 256 + 324 * 12)
        bms, by = bound(nbytes, ops, dtype)
        results[("K1", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bms, bound_by=by, library_ms=None)

        # K2: sparse-code warp (C=128, half res) and frame warp (C=1, full res)
        for tag, c, hh, ww in (("C=128 90x120", 128, H // 2, W // 2),
                               ("C=1 180x240", 1, H, W)):
            img = randn(BATCH, c, hh, ww).to(dt)
            flow = randn(BATCH, 2, hh, ww, scale=3.0)
            ref = cuda_aug.warp_reflect_plain(img.float(), flow, -1.0)
            out = cuda_aug.warp_reflect(img, flow, -1.0)
            # f32: the plain version on the card divides by W as a multiply
            # by 1/W (PyTorch's scalar division), so sample coordinates may
            # differ by ~2 ulps of the frame width; on a noise image that
            # moves a sample by up to the largest step between neighbours
            step = max(float((img[..., 1:] - img[..., :-1]).abs().max()),
                       float((img[..., 1:, :] - img[..., :-1, :]).abs().max()))
            tol32 = max(1e-5, 4 * 2.0 ** -23 * max(hh, ww) * step)
            err = compare(torch, f"K2 warp {tag}", dtype, out, ref,
                          tol32 if dtype == "float32" else bf16_tol(ref, 2))
            gx, gy = frame_warp_coords(flow, -1.0)
            grid = torch.stack([gx / (ww - 1) * 2 - 1, gy / (hh - 1) * 2 - 1], -1).to(dt)
            lib = time_ms(torch, lambda: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="reflection", align_corners=True))
            ms = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow, -1.0))
            plain = time_ms(torch, lambda: cuda_aug.warp_reflect_plain(img, flow, -1.0))
            nbytes = 2 * img.numel() * es + flow.numel() * 4
            bms, by = bound(nbytes, BATCH * hh * ww * (40 + 8 * c), "float32")
            print(f"  K2 warp {tag} {dtype}: {ms:.4f} ms (plain {plain:.4f}, "
                  f"grid_sample {lib:.4f}, bound {bms:.4f})")
            if c == 128:
                results[("K2", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by, library_ms=lib)

        # K3: ISTA loop + Dg at 90x120, C=64
        c, hh, ww = 64, H // 2, W // 2
        x1 = randn(BATCH, c, hh, ww).to(dt)
        z = randn(BATCH, 2 * c, hh, ww, scale=0.1).to(dt)
        wts = (randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5).to(dt),
               randn(c, scale=0.05).to(dt),
               randn(2 * c, c, 3, 3, scale=(9 * c) ** -0.5).to(dt),
               randn(2 * c, scale=0.05).to(dt),
               (torch.rand(2 * c, generator=g, device=dev) * 0.01).to(dt))
        gw = randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5).to(dt)
        gb = randn(c, scale=0.05).to(dt)
        w32 = tuple(t.float() for t in wts)
        for depth in (1, 5):
            ref = cuda_ista2.fused_ista_dg_plain(w32, gw.float(), gb.float(),
                                                 x1.float(), z.float(), depth)
            out = cuda_ista2.fused_ista_dg(wts, gw, gb, x1, z, depth)
            err = compare(torch, f"K3 ista+Dg depth {depth}", dtype, out, ref,
                          f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 8))
            ms = time_ms(torch, lambda: cuda_ista2.fused_ista_dg(wts, gw, gb, x1, z, depth))
            plain = time_ms(torch, lambda: cuda_ista2.fused_ista_dg_plain(
                wts, gw, gb, x1, z, depth))
            nbytes = (x1.numel() * 2 + z.numel() * 2 + sum(t.numel() for t in wts)
                      + gw.numel() + gb.numel()) * es
            ops = (2 * depth + 1) * 2 * 9 * (2 * c) * c * BATCH * hh * ww
            bms, by = bound(nbytes, ops, dtype)
            print(f"  K3 depth {depth} {dtype}: {ms:.4f} ms (plain {plain:.4f}, "
                  f"bound {bms:.4f} by {by})")
            if depth == 5:
                results[("K3", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by, library_ms=None)

        # K4: the encoders' three instance-norm shapes (+ the stats phase)
        for shape in ((BATCH, 64, 96, 128), (BATCH, 96, 48, 64), (BATCH, 128, 24, 32)):
            x = (randn(*shape) * 2.0 + 0.5).to(dt)
            for relu in (False, True):
                ref = cuda_norm.instance_norm_plain(x.float(), relu=relu)
                out = cuda_norm.instance_norm_fused(x, relu=relu)
                err = compare(torch, f"K4 norm {shape[1:]} relu={relu}", dtype, out, ref,
                              2e-5 if dtype == "float32" else bf16_tol(ref, 2))
            ref = cuda_norm.instance_norm_stats_plain(x.float())
            out = cuda_norm.instance_norm_stats(x)
            compare(torch, f"K4s stats {shape[1:]}", dtype, out, ref,
                    1e-4 if dtype == "float32" else 1e-3)
            ms = time_ms(torch, lambda: cuda_norm.instance_norm_fused(x))
            plain = time_ms(torch, lambda: cuda_norm.instance_norm_plain(x))
            lib = time_ms(torch, lambda: F.instance_norm(x))
            ms_s = time_ms(torch, lambda: cuda_norm.instance_norm_stats(x))
            bms, by = bound(2 * x.numel() * es, 6 * x.numel(), "float32")
            print(f"  K4 {shape} {dtype}: {ms:.4f} ms (stats only {ms_s:.4f}, plain "
                  f"{plain:.4f}, F.instance_norm {lib:.4f}, bound {bms:.4f})")
            if shape[1] == 64:
                results[("K4", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by, library_ms=lib)
        for key in ("K1", "K2", "K3", "K4"):
            r = results[(key, dtype)]
            print(f"  {key} {dtype}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
                  f"{r['library_ms']}")
    # the serving dtype's numbers go into the kernels line
    return {key: results[(key, "bfloat16")] for key in ("K1", "K2", "K3", "K4")}


def voxels(seed: int, steps: int, batch: int = 1) -> np.ndarray:
    """Sparse event-like voxels: ~5% of the bins hold signed counts."""
    rng = np.random.default_rng(seed)
    shape = (steps, batch, 5, H, W)
    v = rng.standard_normal(shape).astype(np.float32) * 2.0
    v *= rng.random(shape) < 0.05
    return v[:, 0] if batch == 1 else v


def main_path(torch, repo: Path, kernels: dict) -> dict:
    """Phase 4. Returns each kernel's launches over the main-path runs."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.runner import Reconstructor

    total = {k: 0 for k in kernels}
    print(f"main path: Reconstructor.step_window, {H}x{W}, {STEPS} steps")
    for iters, depth, path in POINTS:
        recs = {}
        for dtype in ("float32", "bfloat16"):
            cfg = Config(image_dim=(H, W), depth=depth, flow_iters=iters,
                         dtype=dtype, path_to_test_model=str(repo / path))
            rec = Reconstructor(cfg, device="cuda")
            ev = voxels(1, STEPS)
            for k in kernels.values():
                k.launches = 0
            out, flows = rec.step_window(ev, return_all=True)
            got = {key: k.launches for key, k in kernels.items()}
            want = {"K1": iters * STEPS, "K2": 2 * STEPS, "K3": STEPS, "K4": 30 * STEPS}
            print(f"  ({iters},{depth}) {dtype}: launches {got}")
            if got != want:
                raise AssertionError(f"launch counts {got}, expected {want}")
            for key in total:
                total[key] += got[key]
            if out.shape != (STEPS, H, W) or flows.shape != (STEPS, 2, H, W):
                raise AssertionError(f"output shapes {out.shape} {flows.shape}")
            if not (np.isfinite(out).all() and np.isfinite(flows).all()):
                raise AssertionError("non-finite output")
            if out.min() < 0.0 or out.max() > 1.0:
                raise AssertionError("frames leave the sigmoid's [0, 1]")
            recs[dtype] = out
        psnr = [10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))
                for a, b in zip(recs["float32"], recs["bfloat16"])]
        print(f"  ({iters},{depth}) bf16 vs f32 PSNR per step (dB): min "
              f"{min(psnr):.2f}, " + " ".join(f"{p:.1f}" for p in psnr))
        if min(psnr) <= PSNR_MIN:
            raise AssertionError(f"bf16 drift: PSNR {min(psnr):.2f} <= {PSNR_MIN}")

        # the kernels' path against the plain versions, end to end (f32)
        cfg = Config(image_dim=(H, W), depth=depth, flow_iters=iters,
                     path_to_test_model=str(repo / path))
        ev = voxels(2, 3)
        gpu = Reconstructor(cfg, device="cuda").step_window(ev, return_all=True)
        cpu = Reconstructor(cfg, device="cpu").step_window(ev, return_all=True)
        err = max(float(np.abs(a - b).max()) for a, b in zip(gpu, cpu))
        print(f"  ({iters},{depth}) f32 cuda vs cpu plain, 3 steps: max abs err "
              f"{err:.3e} (tol 1e-3)")
        if err > 1e-3:
            raise AssertionError(f"cuda path differs from the plain path by {err}")

        # closed-loop frames/s, batch 8, bf16
        cfg = Config(image_dim=(H, W), depth=depth, flow_iters=iters,
                     dtype="bfloat16", path_to_test_model=str(repo / path))
        rec = Reconstructor(cfg, device="cuda", batch=BATCH)
        ev = rec.device_events(voxels(3, STEPS, BATCH))
        rec.run_window(ev)
        fps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec.run_window(ev)
            torch.cuda.synchronize()
            fps.append(STEPS * BATCH / (time.perf_counter() - t0))
        med = statistics.median(fps)
        print(f"  ({iters},{depth}) closed loop bf16 batch {BATCH}: {med:.1f} frames/s "
              f"median of 3 (spread {min(fps):.1f}..{max(fps):.1f}) on {nvidia_smi()}")
    return total


if __name__ == "__main__":
    sys.exit(main())
