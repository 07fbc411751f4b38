#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (cista_flow_torch) on one CUDA card.

    python3 chip_smoke.py [--kernels-only]

Phases (any failure raises and the exit code is non-zero):
 1. the card: ``nvidia-smi`` name and power limit, torch's device name;
 2. build the CUDA kernels from ``cista_flow_torch/csrc`` (one nvcc for each
    source, in parallel) into the ignored ``build/kernels``;
 3. each of the eight kernels (K1, K2, K3, K3a, K4, K4s, K5, K6) against its
    plain PyTorch version on the card, at the shapes the serving paths give
    it (180x240 frames, batch 8), in bf16 and f32 with TF32 off: max abs
    error against a stated tolerance, and the device time per call of the
    kernel, of the plain version and, where one PyTorch call computes the
    same function, of that call (``library_ms``; the port never calls it),
    from the kernel time of a profiler trace, so that the host's time to
    issue a call is not counted (``profile_kernels.device_ms``).
    K1 at batch 8, at the cista-eraft window's 98,304 samples and at a
    ragged 48x48 frame (batch 3, an empty level), with far coordinates and
    ones whose per-offset floor moves on; in bf16 also against the plain
    version on the same bf16 pyramid, where only the summation order
    differs (one bf16 step); and after an in-place update of convc1's
    weight (the packed weight's cache must notice it).
    K3, K3a, K6 and K5 also at ragged small shapes on the tensor-core tile
    and at 32 channels on the direct tile, K3 and K5 after an in-place
    weight update (the repack cache must notice it), K3 per launch kind (one
    D and one P conv beside ``F.pad`` + ``F.conv2d``), K6 beside K3a (the
    same loop on the same tile, one launch against 2*depth + 3). K2 also at
    ragged shapes and past
    65535 samples, with flows several periods of the fold out and the
    zero-flow gate true and false;
    K4 and K4s also at plane sizes that take each launch route (1 to 40000
    elements, a misaligned view, constant planes) and at the cista-eraft
    window's 136 samples. ``--kernels-only`` stops here;
 4. the flagship path: ``Reconstructor.step_window`` in ``cista-eiflow``
    mode on the committed gate weights at 180x240, at (iters, depth) =
    (1, 1) and (6, 5), 16 steps of seeded voxels in f32 and bf16, with every
    kernel's launch count checked and bf16 held above 30 dB PSNR against
    f32 at every step; the CUDA path held against the same port on the CPU
    (plain versions) over 3 steps; closed-loop frames/s at batch 8 in bf16
    (3 reps);
 4b. the ``cista-eraft`` path, the same checks at (1, 1) and (12, 5):
    ``step_window`` is the time-parallel window there, and 16 calls of
    ``step`` on the same voxels must agree with it;
 4c. variant windows (4 steps, f32, depth 5): the ISTA loop through K3a and
    through K6, the encoders' norms through K4s, each held against the
    default route.
The last lines are the ``kernels`` JSON (K1, K2, K4 and K4s with a row for
each timed shape under ``shapes``), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
ERAFT_POINTS = ((1, 1, "gate/eraft_ft1_f16.npz"), (12, 5, "gate/eraft_sim40_f16.npz"))
NORMS = 15               # instance norms in one BasicEncoder call
SQUARE_CONVS = 7         # its 64->64 and 128->128 3x3 convs (kernel K5)
HBM_BYTES_PER_S = 3.35e12                                    # H100 SXM
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}            # tensor-core bf16; f32 non-tensor


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# key -> (name, source, the pl.pallas_call site it replaces)
KERNELS = {
    "K1": ("corr_lookup_convc1", "cista_flow_torch/csrc/corr.cu",
           "cista_flow_tpu/ops/pallas_corr.py:332"),
    "K2": ("warp_reflect", "cista_flow_torch/csrc/warp.cu",
           "cista_flow_tpu/ops/pallas_aug.py:61"),
    "K3": ("ista_loop_dg", "cista_flow_torch/csrc/ista.cu",
           "cista_flow_tpu/ops/pallas_ista2.py:302"),
    "K3a": ("ista_loop_v2", "cista_flow_torch/csrc/ista.cu",
            "cista_flow_tpu/ops/pallas_ista2.py:267"),
    "K4": ("instance_norm", "cista_flow_torch/csrc/norm.cu",
           "cista_flow_tpu/ops/pallas_norm.py:91"),
    "K4s": ("instance_norm_stats", "cista_flow_torch/csrc/norm.cu",
            "cista_flow_tpu/ops/pallas_norm.py:193"),
    "K5": ("conv3x3", "cista_flow_torch/csrc/conv3x3.cu",
           "cista_flow_tpu/ops/pallas_conv.py:136"),
    "K6": ("ista_loop_one_launch", "cista_flow_torch/csrc/ista_loop.cu",
           "cista_flow_tpu/ops/pallas_ista.py:110"),
}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "cista_flow_torch" / "csrc").is_dir():
        print("chip_smoke: cista_flow_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    if argv not in ([], ["--kernels-only"]):
        print("usage: chip_smoke.py [--kernels-only]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- 1. the card ------------------------------------------------------
    smi = nvidia_smi()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    from cista_flow_torch.ops import (cuda_aug, cuda_build, cuda_conv, cuda_corr, cuda_ista,
                                      cuda_ista2, cuda_norm)
    # each wrapper's launch counter; K3a and K4s share K3's and K4's library
    counters = {"K1": cuda_corr.KERNEL, "K2": cuda_aug.KERNEL, "K3": cuda_ista2.KERNEL,
                "K3a": cuda_ista2.KERNEL_V2, "K4": cuda_norm.KERNEL,
                "K4s": cuda_norm.KERNEL_STATS, "K5": cuda_conv.KERNEL,
                "K6": cuda_ista.KERNEL}
    sources = [k for k in counters.values() if isinstance(k, cuda_build.Kernel)]
    secs = cuda_build.build_all(sources)
    print(f"build: {secs:.1f} s for {len(sources)} sources, {len(counters)} kernels")
    for k in sources:
        print(f"  ptxas {k.name}: {ptxas_summary(k.build_log)}")

    # ---- 3. kernels against their plain versions --------------------------
    checks = kernel_checks(torch)
    torch.cuda.synchronize()
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    if argv:
        return 0

    # ---- 4. the main paths ------------------------------------------------
    launches = {k: 0 for k in counters}
    for phase in (flagship_path, eraft_path, variant_windows):
        for key, n in phase(torch, repo, counters).items():
            launches[key] += n
        print(f"{phase.__name__} done at {time.perf_counter() - t_start:.1f} s")
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")

    rows = []
    for key, (name, source, replaces) in KERNELS.items():
        c = checks[key]
        rows.append({"name": f"{key} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                     **({"shapes": c["shapes"]} if "shapes" in c else {})})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# ------------------------------------------------------------------------
def ptxas_summary(log: str) -> str:
    """``nvcc -Xptxas -v`` in one line: kernels, registers, spills; the
    tensor-core tile's kernels one by one (their registers set how many
    blocks an SM holds)."""
    import re
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    if not regs:
        return "built earlier (no compiler output)"
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", log))
    tiles = []
    for name, used in re.findall(r"Compiling entry function '(\S+)'[^\n]*\n(?:[^\n]*\n){0,3}?"
                                 r"[^\n]*Used (\d+) registers", log):
        m = re.search(r"((?:ista_conv|conv3x3)_mma_kernel)I\w*?TileI((?:Li\d+E)+)EEL[ib](\d)E",
                      name)
        if m:
            tile = ",".join(re.findall(r"\d+", m.group(2)))
            tiles.append(f"{m.group(1)}<Tile<{tile}>,{m.group(3)}> {used}")
    out = (f"{len(regs)} kernels, {min(regs)}..{max(regs)} registers, "
           f"{spills} bytes of spills")
    return out + ("; " + "; ".join(tiles) if tiles else "")


def time_ms(torch, fn) -> float:
    """Device ms per call of ``fn`` (``profile_kernels.device_ms``): the
    kernel time of 20 back-to-back calls in a profiler trace, over 20; the
    host's time to issue a call is not counted."""
    from cista_flow_torch.profile_kernels import device_ms
    return device_ms(fn)


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


def warp_tol(img, ref, reach: float, dtype: str) -> float:
    """K2's tolerance. f32: the plain version on the card divides by W as a
    multiply by 1/W (PyTorch's scalar division), so sample coordinates may
    differ by ~2 ulps of the largest coordinate (``reach`` pixels); on a
    noise image that moves a sample by up to the largest step between
    neighbours. bf16: 2 rounding steps."""
    if dtype != "float32":
        return bf16_tol(ref, 2)
    step = max(float((img[..., 1:] - img[..., :-1]).abs().max()),
               float((img[..., 1:, :] - img[..., :-1, :]).abs().max()))
    return max(1e-5, 4 * 2.0 ** -23 * reach * step)


def k2_extra_checks(torch, randn, dtype):
    """K2 beyond the serving shapes: ragged shapes (W not a multiple of the
    32-pixel tile, C not of the 8-channel chunk), batches of more than
    65535 samples (two launches), both signs, flows that
    reach 1.4, 3, 5.2 and 8000 half periods of the fold out (its direct,
    subtraction and fmodf branches), and the zero-flow gate both true (bit
    for bit the ungated warp) and false (bit for bit the input). The plain
    version runs on the CPU here, where it divides by W as the kernel does
    (no reciprocal), so the far coordinates add nothing to the tolerance."""
    from cista_flow_torch.ops import cuda_aug

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    for (b, c, hh, ww), sign in (((2, 128, 9, 13), 1.0), ((3, 1, 17, 23), -1.0),
                                 ((2, 21, 45, 61), -1.0), ((BATCH, 128, H // 2, W // 2), 1.0),
                                 ((70000, 3, 2, 5), 1.0), ((70000, 1, 2, 5), -1.0)):
        img = randn(b, c, hh, ww).to(dt)
        flow = randn(b, 2, hh, ww, scale=3.0)
        periods = torch.tensor([0.7, 1.5, -2.6, 4e3], device=dev)
        flow[0, 0, 0, :4] = periods * 2 * ww
        flow[-1, 1, -1, -4:] = -periods * 2 * hh
        ungated = cuda_aug.warp_reflect(img, flow, sign)
        for gate in (None, True, False):
            g = None if gate is None else torch.tensor(gate, device=dev)
            out = ungated if gate is None else cuda_aug.warp_reflect(img, flow, sign, g)
            ref = cuda_aug.warp_reflect_plain(img.float().cpu(), flow.cpu(), sign,
                                              None if g is None else g.cpu())
            compare(torch, f"K2 warp {(b, c, hh, ww)} sign {sign:+.0f} far, gate={gate}",
                    dtype, out.cpu(), ref,
                    0.0 if gate is False else warp_tol(img, ref, max(hh, ww), dtype))
            if gate is not None and not torch.equal(out, ungated if gate else img):
                raise AssertionError(f"K2 gate={gate} at {(b, c, hh, ww)}: not the "
                                     f"{'ungated warp' if gate else 'input'} bit for bit")


def k4_extra_checks(torch, randn, dtype):
    """K4 and K4s at plane sizes off the serving path: each template of
    ``launch_rule`` with a masked tail, the generic route (ragged, large),
    plane counts that leave warps of a block idle, a misaligned input, and
    constant planes on the warp route."""
    from cista_flow_torch.ops import cuda_norm

    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
    for hw in (1, 7, 8, 100, 769, 1000, 2000, 3071, 5000, 12000, 12289, 20000, 40000):
        x = (randn(2, 3, 1, hw) * 2.0 + 0.5).to(dt)
        route = cuda_norm.launch_rule(hw, es)
        for relu in (False, True):
            ref = cuda_norm.instance_norm_plain(x.float(), relu=relu)
            compare(torch, f"K4 norm hw={hw} {route} relu={relu}", dtype,
                    cuda_norm.instance_norm_fused(x, relu=relu), ref,
                    2e-5 if dtype == "float32" else bf16_tol(ref, 2))
        compare(torch, f"K4s stats hw={hw} {route}", dtype, cuda_norm.instance_norm_stats(x),
                cuda_norm.instance_norm_stats_plain(x.float()),
                1e-4 if dtype == "float32" else 1e-3)
    # a contiguous view that starts one element in: not 16-byte aligned
    base = (randn(2 * 5 * 768 + 1) * 2.0).to(dt)
    x = base[1:].view(2, 5, 24, 32)
    ref = cuda_norm.instance_norm_plain(x.float())
    compare(torch, "K4 norm of a misaligned view", dtype, cuda_norm.instance_norm_fused(x),
            ref, 2e-5 if dtype == "float32" else bf16_tol(ref, 2))
    for shape in ((3, 5, 24, 32), (3, 5, 48, 64)):
        const = torch.full(shape, 0.3, dtype=dt, device=x.device)
        compare(torch, f"K4 norm of constant planes {shape}", dtype,
                cuda_norm.instance_norm_fused(const),
                cuda_norm.instance_norm_plain(const.float()), 1e-4)


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


def k1_checks(torch, randn, dtype) -> dict:
    """K1 at ``CORR_SHAPES`` (batch 8, the cista-eraft window's 98,304
    samples, a 48x48 frame at batch 3 whose last level is empty), with
    coordinates far outside the levels and ones whose per-offset floor
    moves on (c/2^l + d rounds up to an integer). Without convc1 against
    the plain version on the f32 pyramid; with convc1 in f32 at 1e-5
    relative, in bf16 twice: against the plain version on the f32 pyramid
    (4 rounding steps: the window's rounding to bf16 is the kernel's and
    not that reference's) and on the same bf16 pyramid, where the two round
    at the same points and differ by summation order alone: one bf16
    rounding step of the output (2 half-steps at its largest magnitude).
    Then once more after an in-place update of convc1's weight. Times:
    with and without convc1 at the first two shapes."""
    from cista_flow_torch.ops import cuda_corr
    from cista_flow_torch.ops.corr import CorrPyramid, coords_grid
    from cista_flow_torch.profile_kernels import CORR_SHAPES

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    es = torch.tensor([], dtype=dt).element_size()
    rows = []
    for b, h1, w1 in CORR_SHAPES:
        n = b * h1 * w1
        sizes = tuple((h1 >> lvl, w1 >> lvl) for lvl in range(4))
        levels = tuple(randn(n, hl, wl).to(dt) for hl, wl in sizes)
        pyr = CorrPyramid(levels, b, h1, w1)
        pyr32 = CorrPyramid(tuple(lv.float() for lv in levels), b, h1, w1)
        coords = coords_grid(b, h1, w1, dev) + randn(b, 2, h1, w1, scale=4.0)
        coords[0, :, 0, :4] = torch.tensor([[-1e4, 5e3, 40.5, -9.0],
                                            [3e4, -2e4, -4.5, 30.0]], device=dev)
        below4 = float(np.nextafter(np.float32(4.0), np.float32(0.0)))
        coords[-1, :, -1, -2:] = torch.tensor([[below4, -1e-8], [-1e-8, 2.0 - 1e-7]], device=dev)
        wproj = randn(256, 324, 1, 1, scale=324 ** -0.5).to(dt)
        bproj = randn(256, scale=0.1).to(dt)
        tag = f"K1 ({b},{h1},{w1})"
        ref = cuda_corr.lookup_plain(pyr32, coords)
        compare(torch, f"{tag} lookup (324 ch)", dtype, cuda_corr.lookup(pyr, coords), ref,
                1e-5 if dtype == "float32" else bf16_tol(ref, 2))
        ref = cuda_corr.lookup_plain(pyr32, coords, wproj.float(), bproj.float())
        out = cuda_corr.lookup(pyr, coords, wproj, bproj)
        err = compare(torch, f"{tag} + convc1", dtype, out, ref,
                      f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 4))
        if dtype == "bfloat16":
            same = cuda_corr.lookup_plain(pyr, coords, wproj, bproj)
            err = compare(torch, f"{tag} + convc1, same bf16 pyramid", dtype, out, same,
                          bf16_tol(same, 2))
        if (b, h1, w1) == CORR_SHAPES[-1]:
            wproj.mul_(-0.5)
            bproj.add_(0.05)
            ref = cuda_corr.lookup_plain(pyr, coords, wproj, bproj)
            compare(torch, f"{tag} after an in-place weight update", dtype,
                    cuda_corr.lookup(pyr, coords, wproj, bproj), ref,
                    f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 2))
            continue
        ms = time_ms(torch, lambda: cuda_corr.lookup(pyr, coords, wproj, bproj))
        ms_gather = time_ms(torch, lambda: cuda_corr.lookup(pyr, coords))
        plain = time_ms(torch, lambda: cuda_corr.lookup_plain(pyr, coords, wproj, bproj))
        touched = window_entries(coords, sizes) * es + coords.numel() * 4
        nbytes = touched + wproj.numel() * es + bproj.numel() * 4 + n * 256 * es
        ops = n * (2 * 324 * 256 + 324 * 12)
        bms, by = bound(nbytes, ops, dtype)
        gather_bms, _ = bound(touched + n * 324 * es, n * 324 * 12, "float32")
        rate = (f"{ops / ms * 1e-9:.1f} TFLOP/s" if by == "operations"
                else f"{nbytes / ms * 1e-9:.2f} TB/s")
        print(f"  {tag} {dtype}: {ms:.4f} ms (plain {plain:.4f}, bound {bms:.4f} by {by}; "
              f"{rate}); gather alone (324 ch out) {ms_gather:.4f} ms (bound "
              f"{gather_bms:.4f} by bytes)")
        rows.append(dict(shape=[b, h1, w1], max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bms, bound_by=by, library_ms=None, gather_ms=ms_gather))
    return {**{k: v for k, v in rows[0].items() if k not in ("shape", "gather_ms")},
            "shapes": rows}


def kernel_checks(torch):
    """Phase 3. Each kernel on seeded inputs at the serving shapes; the
    plain version runs on the same inputs (upcast to f32 for bf16, so that
    the reference carries no bf16 rounding of its own)."""
    import torch.nn.functional as F
    from cista_flow_torch.ops import (cuda_aug, cuda_conv, cuda_corr, cuda_ista, cuda_ista2,
                                      cuda_norm)
    from cista_flow_torch.profile_kernels import (NORM_SHAPES, WARP_SHAPES,
                                                  batch_norm_stats_call, grid_sample_call)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    results = {}
    print("kernels vs plain versions (batch 8, serving shapes):")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()

        # K1: 4 pyramid levels at 1/8 res of the padded 192x256 frame, at
        # batch 8, at the cista-eraft window's T*8 samples and at a ragged
        # shape with an empty level
        results[("K1", dtype)] = k1_checks(torch, randn, dtype)

        # K2: sparse-code warp (C=128, half res) and frame warp (C=1, full res),
        # timed as the serving path calls it: with the zero-flow gate on the card
        k2 = []
        gate = torch.tensor(True, device=dev)
        for shape in WARP_SHAPES:
            bsz, c, hh, ww = shape
            img = randn(*shape).to(dt)
            flow = randn(bsz, 2, hh, ww, scale=3.0)
            ref = cuda_aug.warp_reflect_plain(img.float(), flow, -1.0)
            out = cuda_aug.warp_reflect(img, flow, -1.0, gate)
            err = compare(torch, f"K2 warp {shape}", dtype, out, ref,
                          warp_tol(img, ref, max(hh, ww), dtype))
            lib = time_ms(torch, grid_sample_call(img, flow, -1.0))
            ms = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow, -1.0, gate))
            ms_ungated = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow, -1.0))
            plain = time_ms(torch, lambda: cuda_aug.warp_reflect_plain(img, flow, -1.0, gate))
            nbytes = 2 * img.numel() * es + flow.numel() * 4
            bms, by = bound(nbytes, bsz * hh * ww * (40 + 8 * c), "float32")
            print(f"  K2 warp {shape} {dtype}: {ms:.4f} ms (ungated {ms_ungated:.4f}, plain "
                  f"{plain:.4f}, grid_sample {lib:.4f}, bound {bms:.4f}; "
                  f"{nbytes / ms * 1e-9:.2f} TB/s, {ms / lib:.2f}x the library)")
            k2.append(dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib))
            if c == 128:
                # the same warp at one flow for every pixel: a warp's 32 samples
                # then share two rows, where the noise flow above scatters them
                flow1 = torch.zeros_like(flow)
                flow1[:, 0], flow1[:, 1] = 2.3, -1.6
                ms1 = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow1, -1.0, gate))
                lib1 = time_ms(torch, grid_sample_call(img, flow1, -1.0))
                print(f"  K2 warp {shape} {dtype} at a uniform flow: {ms1:.4f} ms "
                      f"(grid_sample {lib1:.4f}; {nbytes / ms1 * 1e-9:.2f} TB/s)")
        results[("K2", dtype)] = {**{k: v for k, v in k2[0].items() if k != "shape"},
                                  "shapes": k2}
        k2_extra_checks(torch, randn, dtype)

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
                  f"bound {bms:.4f} by {by}; {ms / plain:.2f}x the chain of library "
                  f"convs, {ops / ms * 1e-9:.1f} TFLOP/s)")
            if depth == 5:
                results[("K3", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                              bound_ms=bms, bound_by=by, library_ms=None)
            # K3a (2*depth launches) and K6 (one cooperative launch): the loop alone
            ref = cuda_ista2.ista_loop_plain(w32, x1.float(), z.float(), depth)
            nbytes = (x1.numel() + z.numel() * 2 + sum(t.numel() for t in wts)) * es
            ops = 2 * depth * 2 * 9 * (2 * c) * c * BATCH * hh * ww
            bms, by = bound(nbytes, ops, dtype)
            plain = time_ms(torch, lambda: cuda_ista2.ista_loop_plain(wts, x1, z, depth))
            loop_ms = {}
            for key, fn in (("K3a", cuda_ista2.fused_ista_v2), ("K6", cuda_ista.fused_ista)):
                z_before = z.clone()
                out = fn(wts, x1, z, depth)
                err = compare(torch, f"{key} ista loop depth {depth}", dtype, out, ref,
                              f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 8))
                if not torch.equal(z, z_before):
                    raise AssertionError(f"{key} modified its input z")
                ms = loop_ms[key] = time_ms(torch, lambda: fn(wts, x1, z, depth))
                print(f"  {key} depth {depth} {dtype}: {ms:.4f} ms (plain {plain:.4f}, "
                      f"bound {bms:.4f} by {by}; {ops / ms * 1e-9:.1f} TFLOP/s)")
                if key == "K6":
                    # the same loop on the same tile: one cooperative launch
                    # against 2*depth + 3 launches
                    print(f"  K6 / K3a depth {depth} {dtype}: {ms / loop_ms['K3a']:.3f}")
                if depth == 5:
                    results[(key, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                 bound_ms=bms, bound_by=by, library_ms=None)

        k3_extra_checks(torch, randn, g, dtype, x1, z, wts, gw, gb)

        # K4: the encoders' three instance-norm shapes (+ the stats phase), and
        # fnet's largest at the cista-eraft window's (T+1)*8 = 136 samples
        k4 = []
        for shape in NORM_SHAPES:
            x = (randn(*shape) * 2.0 + 0.5).to(dt)
            for relu in (False, True):
                ref = cuda_norm.instance_norm_plain(x.float(), relu=relu)
                out = cuda_norm.instance_norm_fused(x, relu=relu)
                err = compare(torch, f"K4 norm {shape} relu={relu}", dtype, out, ref,
                              2e-5 if dtype == "float32" else bf16_tol(ref, 2))
            ref = cuda_norm.instance_norm_stats_plain(x.float())
            out = cuda_norm.instance_norm_stats(x)
            err_s = compare(torch, f"K4s stats {shape}", dtype, out, ref,
                            1e-4 if dtype == "float32" else 1e-3)
            # the library call for K4s computes the same statistics
            compare(torch, f"torch.batch_norm_stats {shape}", dtype,
                    batch_norm_stats_call(x)(), tuple(r.flatten() for r in ref),
                    1e-4 if dtype == "float32" else 1e-3)
            ms = time_ms(torch, lambda: cuda_norm.instance_norm_fused(x))
            plain = time_ms(torch, lambda: cuda_norm.instance_norm_plain(x))
            lib = time_ms(torch, lambda: F.instance_norm(x))
            ms_s = time_ms(torch, lambda: cuda_norm.instance_norm_stats(x))
            plain_s = time_ms(torch, lambda: cuda_norm.instance_norm_stats_plain(x))
            lib_s = time_ms(torch, batch_norm_stats_call(x))
            nbytes = 2 * x.numel() * es
            bms, by = bound(nbytes, 6 * x.numel(), "float32")
            bms_s, by_s = bound(x.numel() * es + 8 * x.shape[0] * x.shape[1],
                                4 * x.numel(), "float32")
            print(f"  K4 {shape} {dtype}: {ms:.4f} ms (plain {plain:.4f}, F.instance_norm "
                  f"{lib:.4f}, bound {bms:.4f}; {nbytes / ms * 1e-9:.2f} TB/s, {ms / lib:.2f}x "
                  f"the library; rule {cuda_norm.launch_rule(shape[2] * shape[3], es)}); K4s "
                  f"{ms_s:.4f} ms (plain {plain_s:.4f}, torch.batch_norm_stats {lib_s:.4f}, "
                  f"bound {bms_s:.4f}; {ms_s / lib_s:.2f}x the library)")
            k4.append(dict(shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain,
                           bound_ms=bms, bound_by=by, library_ms=lib,
                           stats=dict(max_abs_err=err_s, ms=ms_s, plain_ms=plain_s,
                                      bound_ms=bms_s, bound_by=by_s, library_ms=lib_s)))
            del x, ref, out
        results[("K4", dtype)] = {**{k: v for k, v in k4[0].items()
                                     if k not in ("shape", "stats")},
                                  "shapes": [{k: v for k, v in r.items() if k != "stats"}
                                             for r in k4]}
        results[("K4s", dtype)] = {**k4[0]["stats"],
                                   "shapes": [{"shape": r["shape"], **r["stats"]} for r in k4]}
        k4_extra_checks(torch, randn, dtype)
        # a zero voxel's planes (a stream's first previous voxel) are constant:
        # variance 0, so a rounding error of the mean (a few 1e-8) is scaled by
        # 1/sqrt(eps) = 316; 1e-4 bounds it
        const = torch.full((2, 64, 96, 128), 0.3, dtype=dt, device=dev)
        compare(torch, "K4 norm of constant planes", dtype,
                cuda_norm.instance_norm_fused(const),
                cuda_norm.instance_norm_plain(const.float()), 1e-4)

        # K5: the encoders' square convs (zeros) and the CISTA upsamp conv (reflect)
        # (the 32-channel shape is on no path: it holds the direct inner product
        # in bf16, which the routed widths leave for the tensor cores)
        for shape, mode in (((BATCH, 64, 96, 128), "zeros"), ((BATCH, 128, 24, 32), "zeros"),
                            ((BATCH, 64, H, W), "reflect"), ((2, 32, 21, 45), "reflect")):
            c = shape[1]
            x = randn(*shape).to(dt)
            wk = randn(c, c, 3, 3, scale=(9 * c) ** -0.5).to(dt)
            bk = randn(c, scale=0.1).to(dt)
            for relu in (False, True):
                ref = cuda_conv.conv3x3_plain(x.float(), wk.float(), bk.float(), mode, relu)
                out = cuda_conv.conv3x3(x, wk, bk, mode, relu)
                err = compare(torch, f"K5 conv3x3 {shape[1:]} {mode} relu={relu}", dtype,
                              out, ref, f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 2))
            ms = time_ms(torch, lambda: cuda_conv.conv3x3(x, wk, bk, mode))
            # the plain version is the library call here: F.conv2d (+ F.pad)
            lib = time_ms(torch, lambda: cuda_conv.conv3x3_plain(x, wk, bk, mode))
            nbytes = (2 * x.numel() + wk.numel() + bk.numel()) * es
            bms, by = bound(nbytes, 2 * 9 * c * c * shape[0] * shape[2] * shape[3], dtype)
            ops = 2 * 9 * c * c * shape[0] * shape[2] * shape[3]
            print(f"  K5 {shape} {mode} {dtype}: {ms:.4f} ms (F.conv2d {lib:.4f}, "
                  f"bound {bms:.4f} by {by}; {ms / lib:.2f}x the library, "
                  f"{ops / ms * 1e-9:.1f} TFLOP/s)")
            if shape == (BATCH, 64, 96, 128):
                results[("K5", dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=lib,
                                              bound_ms=bms, bound_by=by, library_ms=lib)
        # the weights change in place: the wrapper's cached repack (bf16 at
        # C % 64 == 0) or cast must follow
        x = randn(2, 64, 21, 45).to(dt)
        wk = randn(64, 64, 3, 3, scale=1 / 24).to(dt)
        cuda_conv.conv3x3(x, wk, None, "reflect")
        wk.mul_(-2.0)
        ref = cuda_conv.conv3x3_plain(x.float(), wk.float(), None, "reflect")
        compare(torch, "K5 after an in-place weight update", dtype,
                cuda_conv.conv3x3(x, wk, None, "reflect"), ref,
                f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 2))
        for key in KERNELS:
            r = results[(key, dtype)]
            print(f"  {key} {dtype}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms by {r['bound_by']}, library "
                  f"{r['library_ms']}")
    # the serving dtype's numbers go into the kernels line
    return {key: results[(key, "bfloat16")] for key in KERNELS}


def k3_extra_checks(torch, randn, g, dtype, x1, z, wts, gw, gb):
    """K3, K3a and K6 beyond the serving shape: ragged small shapes (C = 64:
    the tensor-core tile in bf16; C = 32: the direct tile) at depth 1, 3
    and 5, an in-place weight update of K3's, and at the serving shape one D and one P launch beside the
    PyTorch calls for the same conv (``F.pad`` + ``F.conv2d``)."""
    import torch.nn.functional as F
    from cista_flow_torch.ops import conv_tile, cuda_ista, cuda_ista2

    dt = getattr(torch, dtype)

    def weights(c):
        return ((randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5).to(dt),
                 randn(c, scale=0.05).to(dt),
                 randn(2 * c, c, 3, 3, scale=(9 * c) ** -0.5).to(dt),
                 randn(2 * c, scale=0.05).to(dt),
                 (torch.rand(2 * c, generator=g, device=x1.device) * 0.01).to(dt)),
                randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5).to(dt),
                randn(c, scale=0.05).to(dt))

    def tol(ref):
        return f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 8)

    def f32(ws):
        return tuple(t.float() for t in ws)

    for bsz, c, hh, ww in ((2, 64, 21, 45), (1, 64, 2, 2), (2, 32, 21, 45)):
        xs = randn(bsz, c, hh, ww).to(dt)
        zs = randn(bsz, 2 * c, hh, ww, scale=0.1).to(dt)
        ws, gws, gbs = weights(c)
        for depth in (1, 3, 5):
            ref = cuda_ista2.fused_ista_dg_plain(f32(ws), gws.float(), gbs.float(),
                                                 xs.float(), zs.float(), depth)
            compare(torch, f"K3 ista+Dg ({bsz},{c},{hh},{ww}) depth {depth}", dtype,
                    cuda_ista2.fused_ista_dg(ws, gws, gbs, xs, zs, depth), ref, tol(ref))
            compare(torch, f"K3a ista loop ({bsz},{c},{hh},{ww}) depth {depth}", dtype,
                    cuda_ista2.fused_ista_v2(ws, xs, zs, depth), ref[0], tol(ref[0]))
            compare(torch, f"K6 ista loop ({bsz},{c},{hh},{ww}) depth {depth}", dtype,
                    cuda_ista.fused_ista(ws, xs, zs, depth), ref[0], tol(ref[0]))
        if c == 64 and hh > 2:
            ws[0].mul_(0.5)
            ws[2].add_(0.01)
            gws.mul_(-1.0)
            ref = cuda_ista2.fused_ista_dg_plain(f32(ws), gws.float(), gbs.float(),
                                                 xs.float(), zs.float(), 2)
            compare(torch, "K3 after in-place weight updates", dtype,
                    cuda_ista2.fused_ista_dg(ws, gws, gbs, xs, zs, 2), ref, tol(ref))

    # one launch of each kind at the serving shape, beside the library's conv
    dw, db, pw, pb, lam = wts
    c = x1.shape[1]
    ops = 2 * 9 * 2 * c * c * x1.shape[0] * x1.shape[2] * x1.shape[3]

    def lib_conv(src, w, b):
        return F.conv2d(F.pad(src, (1, 1, 1, 1), mode="reflect"), w, b)

    lib_d = time_ms(torch, lambda: lib_conv(z, dw, db))
    lib_p = time_ms(torch, lambda: lib_conv(x1, pw, pb))
    if cuda_ista2.uses_mma_tile(dt, c):
        x1g, zg = conv_tile.to_grouped(x1), conv_tile.to_grouped(z)
        # the layout kernels at the call's two ends move values, so: equal
        if not (torch.equal(cuda_ista2._to_grouped(cuda_ista2.KERNEL, z), zg)
                and torch.equal(cuda_ista2._from_grouped(cuda_ista2.KERNEL, zg), z)):
            raise AssertionError("K3 layout kernels differ from conv_tile.to_grouped")
        xd, zo = torch.empty_like(x1g), torch.empty_like(zg)
        dwp, pwp = conv_tile.packed_weights(dw, dt), conv_tile.packed_weights(pw, dt)
        ms_d = time_ms(torch, lambda: cuda_ista2._conv_mma(
            cuda_ista2.KERNEL, cuda_ista2.MODE_D, zg, dwp, db, x1g, lam, xd))
        ms_p = time_ms(torch, lambda: cuda_ista2._conv_mma(
            cuda_ista2.KERNEL, cuda_ista2.MODE_P, x1g, pwp, pb, zg, lam, zo))
        ms_in = time_ms(torch, lambda: (cuda_ista2._to_grouped(cuda_ista2.KERNEL, x1),
                                        cuda_ista2._to_grouped(cuda_ista2.KERNEL, z)))
        ms_out = time_ms(torch, lambda: cuda_ista2._from_grouped(cuda_ista2.KERNEL, zg))
        print(f"  K3 layout passes {dtype}: NCHW -> grouped (x1 and z) {ms_in:.4f} ms, "
              f"grouped -> NCHW (z) {ms_out:.4f} ms")
    else:
        xd, zo = torch.empty_like(x1), torch.empty_like(z)
        ms_d = time_ms(torch, lambda: cuda_ista2._conv(
            cuda_ista2.KERNEL, cuda_ista2.MODE_D, z, dw, db, x1, lam, xd))
        ms_p = time_ms(torch, lambda: cuda_ista2._conv(
            cuda_ista2.KERNEL, cuda_ista2.MODE_P, x1, pw, pb, z, lam, zo))
    for kind, ms, lib in (("D 128->64", ms_d, lib_d), ("P 64->128", ms_p, lib_p)):
        print(f"  K3 one launch {kind} {dtype}: {ms:.4f} ms, {ops / ms * 1e-9:.1f} TFLOP/s "
              f"(F.pad + F.conv2d {lib:.4f} ms: {ms / lib:.2f}x the library)")


def voxels(seed: int, steps: int, batch: int = 1) -> np.ndarray:
    """Sparse event-like voxels: ~5% of the bins hold signed counts."""
    rng = np.random.default_rng(seed)
    shape = (steps, batch, 5, H, W)
    v = rng.standard_normal(shape).astype(np.float32) * 2.0
    v *= rng.random(shape) < 0.05
    return v[:, 0] if batch == 1 else v


def psnr_per_step(a, b):
    return [10 * np.log10(1.0 / max(float(np.mean((x - y) ** 2)), 1e-12))
            for x, y in zip(a, b)]


def counted(counters: dict, fn):
    """Run ``fn`` with every launch counter set to 0 just before; returns
    (fn's result, {kernel: launches})."""
    for k in counters.values():
        k.launches = 0
    out = fn()
    return out, {key: k.launches for key, k in counters.items()}


def expect_launches(tag: str, got: dict, want: dict) -> None:
    want = {k: want.get(k, 0) for k in got}
    print(f"  {tag}: launches {got}")
    if got != want:
        raise AssertionError(f"{tag}: launch counts {got}, expected {want}")


def check_outputs(out, flows, steps: int) -> None:
    if out.shape != (steps, H, W) or flows.shape != (steps, 2, H, W):
        raise AssertionError(f"output shapes {out.shape} {flows.shape}")
    if not (np.isfinite(out).all() and np.isfinite(flows).all()):
        raise AssertionError("non-finite output")
    if out.min() < 0.0 or out.max() > 1.0:
        raise AssertionError("frames leave the sigmoid's [0, 1]")


def serving_point(torch, repo, counters, mode, iters, depth, path, want_window,
                  want_steps=None) -> dict:
    """One (iters, depth) point of one model: 16-step windows in f32 and
    bf16 at batch 1 with asserted launch counts and the PSNR rule; for
    ``want_steps`` also 16 calls of ``step`` held against the window; CUDA
    against the port on the CPU over 3 steps; frames/s at batch 8 in bf16.
    Returns the launches of the counted runs."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.runner import Reconstructor

    def config(dtype="float32"):
        return Config(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters,
                      dtype=dtype, path_to_test_model=str(repo / path))

    tag = f"{mode} ({iters},{depth})"
    total = {k: 0 for k in counters}
    recs = {}
    ev = voxels(1, STEPS)
    for dtype in ("float32", "bfloat16"):
        rec = Reconstructor(config(dtype), device="cuda")
        (out, flows), got = counted(
            counters, lambda: rec.step_window(ev, return_all=True))
        expect_launches(f"{tag} {dtype} window", got, want_window)
        for key in total:
            total[key] += got[key]
        check_outputs(out, flows, STEPS)
        recs[dtype] = (out, flows)
    psnr = psnr_per_step(recs["float32"][0], recs["bfloat16"][0])
    print(f"  {tag} bf16 vs f32 PSNR per step (dB): min {min(psnr):.2f}, "
          + " ".join(f"{p:.1f}" for p in psnr))
    if min(psnr) <= PSNR_MIN:
        raise AssertionError(f"bf16 drift: PSNR {min(psnr):.2f} <= {PSNR_MIN}")

    if want_steps is not None:
        # stepping encodes each voxel pair anew at batch B where the window
        # runs T*B samples at once: cuDNN and cuBLAS may pick other
        # algorithms for the two batch sizes, so f32 sums differ in order
        rec = Reconstructor(config(), device="cuda")
        seq, got = counted(counters, lambda: [rec.step(v) for v in ev])
        expect_launches(f"{tag} float32 {STEPS} x step", got, want_steps)
        for key in total:
            total[key] += got[key]
        err = max(max(float(np.abs(r - recs["float32"][0][t]).max()),
                      float(np.abs(f - recs["float32"][1][t]).max()))
                  for t, (r, f) in enumerate(seq))
        print(f"  {tag} f32 {STEPS} x step vs the window: max abs err {err:.3e} (tol 1e-3)")
        if err > 1e-3:
            raise AssertionError(f"stepping differs from the window by {err}")

    # the kernels' path against the plain versions, end to end (f32)
    ev3 = voxels(2, 3)
    gpu = Reconstructor(config(), device="cuda").step_window(ev3, return_all=True)
    cpu = Reconstructor(config(), device="cpu").step_window(ev3, return_all=True)
    err = max(float(np.abs(a - b).max()) for a, b in zip(gpu, cpu))
    print(f"  {tag} f32 cuda vs cpu plain, 3 steps: max abs err {err:.3e} (tol 1e-3)")
    if err > 1e-3:
        raise AssertionError(f"cuda path differs from the plain path by {err}")

    # closed-loop frames/s, batch 8, bf16
    rec = Reconstructor(config("bfloat16"), device="cuda", batch=BATCH)
    evb = rec.device_events(voxels(3, STEPS, BATCH))
    rec.run_window(evb)
    fps = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.run_window(evb)
        torch.cuda.synchronize()
        fps.append(STEPS * BATCH / (time.perf_counter() - t0))
    print(f"  {tag} closed loop bf16 batch {BATCH}: {statistics.median(fps):.1f} frames/s "
          f"median of 3 (spread {min(fps):.1f}..{max(fps):.1f}) on {nvidia_smi()}")
    return total


def flagship_path(torch, repo: Path, counters: dict) -> dict:
    """Phase 4: cista-eiflow. Per step: K1 per GRU iteration, the two warps,
    one ISTA call, fnet's and enet's norms, and K5 for the three encoders'
    square convs and the upsamp conv."""
    print(f"flagship path: Reconstructor.step_window, cista-eiflow, {H}x{W}, {STEPS} steps")
    total = {k: 0 for k in counters}
    for iters, depth, path in POINTS:
        want = {"K1": iters * STEPS, "K2": 2 * STEPS, "K3": STEPS,
                "K4": 2 * NORMS * STEPS, "K5": (3 * SQUARE_CONVS + 1) * STEPS}
        got = serving_point(torch, repo, counters, "cista-eiflow", iters, depth, path, want)
        for key in total:
            total[key] += got[key]
    return total


def eraft_path(torch, repo: Path, counters: dict) -> dict:
    """Phase 4b: cista-eraft. The window runs fnet once over its T+1 voxels
    and cnet once over T, then one flow call (K1 per GRU iteration), then T
    warps and reconstructions; stepping runs fnet (one 2B call) and cnet
    in every step."""
    print(f"cista-eraft path: time-parallel step_window and step, {H}x{W}, {STEPS} steps")
    total = {k: 0 for k in counters}
    for iters, depth, path in ERAFT_POINTS:
        window = {"K1": iters, "K2": 2 * STEPS, "K3": STEPS, "K4": NORMS,
                  "K5": 2 * SQUARE_CONVS + STEPS}
        steps = {"K1": iters * STEPS, "K2": 2 * STEPS, "K3": STEPS, "K4": NORMS * STEPS,
                 "K5": (2 * SQUARE_CONVS + 1) * STEPS}
        got = serving_point(torch, repo, counters, "cista-eraft", iters, depth, path,
                            window, steps)
        for key in total:
            total[key] += got[key]
    return total


def variant_windows(torch, repo: Path, counters: dict) -> dict:
    """Phase 4c: the routes that reach K3a, K6 and K4s, on cista-eraft at
    (12, 5), 4 steps, batch 1, f32. Each route computes the default route's
    function with other kernels (K3a and K6: the Dg conv goes to cuDNN
    instead of K3's last launch; K4s: the normalise is PyTorch elementwise
    ops), so frames and flows agree to f32 rounding carried through 4
    closed-loop steps: 1e-3, the CUDA-against-CPU tolerance."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.runner import Reconstructor

    iters, depth, path = ERAFT_POINTS[1]
    steps = 4
    cfg = Config(image_dim=(H, W), model_mode="cista-eraft", depth=depth, flow_iters=iters,
                 path_to_test_model=str(repo / path))
    ev = voxels(4, steps)
    print(f"variant windows: cista-eraft ({iters},{depth}), {steps} steps, f32")
    base = {"K1": iters, "K2": 2 * steps, "K3": steps, "K4": NORMS,
            "K5": 2 * SQUARE_CONVS + steps}
    ref = Reconstructor(cfg, device="cuda").step_window(ev, return_all=True)
    total = {k: 0 for k in counters}
    for tag, ista, norm, change in (
            ("ISTA loop through K3a", "v2", "fused", {"K3": 0, "K3a": steps}),
            ("ISTA loop through K6", "loop", "fused", {"K3": 0, "K6": steps}),
            ("fnet norms through K4s", "dg", "stats", {"K4": 0, "K4s": NORMS})):
        rec = Reconstructor(cfg, device="cuda")
        rec.model.cista_net.ista_route = ista
        rec.model.event_flownet.fnet.norm_route = norm
        out, got = counted(counters, lambda: rec.step_window(ev, return_all=True))
        expect_launches(tag, got, {**base, **change})
        check_outputs(*out, steps)
        err = max(float(np.abs(a - b).max()) for a, b in zip(out, ref))
        print(f"  {tag} vs the default route: max abs err {err:.3e} (tol 1e-3)")
        if err > 1e-3:
            raise AssertionError(f"{tag}: differs from the default route by {err}")
        for key in total:
            total[key] += got[key]
    return total


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
