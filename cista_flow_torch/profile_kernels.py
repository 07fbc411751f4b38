"""Device and host time of the correlation lookup (K1), the warp (K2), the
instance norm (K4, K4s) and the ISTA loop (K3a, K6), beside the one PyTorch
call for each function where there is one, on the package in the current
directory.

    python3 -m cista_flow_torch.profile_kernels
    cd build/parent && python3 ../../cista_flow_torch/profile_kernels.py

The second form times another tree (for example a parent commit unpacked
with ``git archive``) in the same call, with this file's timing: it imports
``cista_flow_torch`` from the current directory and uses only the wrappers'
common arguments. The shapes and the library calls are the ones
``chip_smoke.py`` times (it takes them from here): K1 at ``CORR_SHAPES``
(with and without convc1), K2 at ``WARP_SHAPES``, K4 at ``NORM_SHAPES``,
K3a and K6 at ``ISTA_SHAPE`` and depth 5. Prints, per kernel, the device
ms per call (``device_ms``), the host microseconds to issue one call while
the card is busy, and the library call's device ms, with the card's name
and power limit. K2 is timed with and without its zero-flow gate where the
tree's wrapper takes one (the serving path passes it). ``--only K1,K6``
times those kernels alone. Needs a CUDA card.
"""
from __future__ import annotations

import inspect
import os
import subprocess
import sys
import time

import torch

BATCH = 8
# K2: the sparse code at half resolution and the frame (180x240)
WARP_SHAPES = ((BATCH, 128, 90, 120), (BATCH, 1, 180, 240))
# K4: the encoders' planes at 1/2, 1/4 and 1/8 of the padded 192x256 frame,
# and fnet's largest at the cista-eraft window's (T + 1) * 8 samples, T = 16
NORM_SHAPES = ((BATCH, 64, 96, 128), (BATCH, 96, 48, 64), (BATCH, 128, 24, 32),
               (17 * BATCH, 64, 96, 128))
# K1 (B, H1, W1): the 1/8-res grid of the padded 192x256 frame at batch 8,
# the cista-eraft window's T * 8 samples (n = 98,304, T = 16), and a 48x48
# frame at batch 3 (levels 6x6 .. 0x0: ragged, the last one empty)
CORR_SHAPES = ((BATCH, 24, 32), (16 * BATCH, 24, 32), (3, 6, 6))
# K3a, K6: the CISTA code (B, C, H, W) at half of 180x240
ISTA_SHAPE = (BATCH, 64, 90, 120)


def grid_sample_call(img: torch.Tensor, flow: torch.Tensor, sign: float):
    """The ``F.grid_sample`` call that computes K2's warp on these inputs
    (reflection padding, align_corners=True, the grid built once outside);
    a yardstick the port never calls."""
    import torch.nn.functional as F
    from cista_flow_torch.ops.warp import frame_warp_coords

    h, w = img.shape[-2:]
    gx, gy = frame_warp_coords(flow, sign)
    grid = torch.stack([gx / (w - 1) * 2 - 1, gy / (h - 1) * 2 - 1], -1).to(img.dtype)
    return lambda: F.grid_sample(img, grid, mode="bilinear", padding_mode="reflection",
                                 align_corners=True)


def batch_norm_stats_call(x: torch.Tensor, eps: float = 1e-5):
    """The ``torch.batch_norm_stats`` call that computes K4s's function: over
    the (sample, channel) planes of ``x`` seen as the channels of one
    sample, the f32 mean and 1/sqrt(biased var + eps); a yardstick the port
    never calls."""
    b, c, h, w = x.shape
    planes = x.view(1, b * c, h, w)
    return lambda: torch.batch_norm_stats(planes, eps)


def device_ms(fn, calls: int = 20, tries: int = 5) -> float:
    """Device ms per call of ``fn``: the kernel time a ``torch.profiler``
    trace records over ``calls`` back-to-back calls. Only the card's busy
    time counts: neither the host's time to issue a call nor the gaps
    between launches.

    A trace can lose a few kernel records or hold a few strays of an
    earlier trace, so each kernel name is read on its own: it runs
    n = round(count / calls) times a call, at its mean time per record, and
    a call costs the sum of n times that mean. A trace in which some name's
    count is more than calls / 4 away from a multiple of ``calls``, or that
    holds no kernel, is taken again, up to ``tries`` times."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = per_call_us([(e.count, e.device_time_total) for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA], calls)
        if us is not None:
            return us / 1e3
    raise RuntimeError(f"device_ms: {tries} traces lost or mixed kernel records")


def per_call_us(records, calls: int):
    """``device_ms``'s reading of one trace: ``records`` holds (count, total
    µs) per kernel name over ``calls`` calls. Returns the µs per call, or
    None where the trace holds no kernel or a name's count is more than
    calls / 4 away from a multiple of ``calls``."""
    per_call = [(round(count / calls), count, us) for count, us in records if count > 0]
    if (sum(n for n, _, _ in per_call) == 0
            or any(abs(count - n * calls) > calls // 4 for n, count, _ in per_call)):
        return None
    return sum(n * us / count for n, count, us in per_call)


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds to issue one call of ``fn`` while the card is busy."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def corr_inputs(shape, dt, g):
    """Seeded K1 inputs at (B, H1, W1): the pyramid, coordinates around the
    grid, the convc1 weight and bias."""
    from cista_flow_torch.ops.corr import CorrPyramid, coords_grid

    b, h1, w1 = shape
    dev = torch.device("cuda")
    n = b * h1 * w1
    levels = tuple(torch.randn(n, h1 >> lvl, w1 >> lvl, generator=g, device=dev).to(dt)
                   for lvl in range(4))
    coords = coords_grid(b, h1, w1, dev) + 4.0 * torch.randn(b, 2, h1, w1, generator=g,
                                                             device=dev)
    wp = (torch.randn(256, 324, 1, 1, generator=g, device=dev) / 18).to(dt)
    bp = (0.1 * torch.randn(256, generator=g, device=dev)).to(dt)
    return CorrPyramid(levels, b, h1, w1), coords, wp, bp


def ista_inputs(dt, g):
    """Seeded K3a/K6 inputs at ``ISTA_SHAPE``: weights (dw, db, pw, pb, lam),
    x1 and z."""
    dev = torch.device("cuda")
    b, c, h, w = ISTA_SHAPE

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    wts = (rnd(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5), rnd(c, scale=0.05),
           rnd(2 * c, c, 3, 3, scale=(9 * c) ** -0.5), rnd(2 * c, scale=0.05),
           (torch.rand(2 * c, generator=g, device=dev) * 0.01).to(dt))
    return wts, rnd(b, c, h, w), rnd(b, 2 * c, h, w, scale=0.1)


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA card")
    only = set(argv[1].split(",")) if len(argv) == 2 and argv[0] == "--only" else None
    sys.path.insert(0, os.getcwd())
    import torch.nn.functional as F
    from cista_flow_torch.ops import cuda_aug, cuda_corr, cuda_ista, cuda_ista2, cuda_norm

    def want(key):
        return only is None or key in only

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"profile_kernels on {os.getcwd()}: {smi}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    gated = "gate" in inspect.signature(cuda_aug.warp_reflect).parameters
    gate = torch.tensor(True, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        for shape in CORR_SHAPES[:2] if want("K1") else ():
            pyr, coords, wp, bp = corr_inputs(shape, dt, g)
            kern = lambda: cuda_corr.lookup(pyr, coords, wp, bp)  # noqa: E731
            print(f"  K1 {shape} {dt}: {device_ms(kern):.4f} ms, host {host_us(kern):.1f} us; "
                  f"gather alone {device_ms(lambda: cuda_corr.lookup(pyr, coords)):.4f} ms")
            del pyr, coords
        if want("K6"):
            wts, x1, z = ista_inputs(dt, g)
            ms = {key: device_ms(lambda: fn(wts, x1, z, 5)) for key, fn in
                  (("K3a", cuda_ista2.fused_ista_v2), ("K6", cuda_ista.fused_ista))}
            print(f"  K3a {ISTA_SHAPE} depth 5 {dt}: {ms['K3a']:.4f} ms; K6 {ms['K6']:.4f} ms; "
                  f"K6 / K3a {ms['K6'] / ms['K3a']:.3f}")
        for shape in WARP_SHAPES if want("K2") else ():
            img = torch.randn(*shape, generator=g, device=dev).to(dt)
            flow = torch.randn(shape[0], 2, *shape[2:], generator=g, device=dev) * 3.0
            kern = lambda: cuda_aug.warp_reflect(img, flow, -1.0)  # noqa: E731
            line = (f"  K2 {shape} {dt}: {device_ms(kern):.4f} ms, host {host_us(kern):.1f} us; "
                    f"F.grid_sample {device_ms(grid_sample_call(img, flow, -1.0)):.4f} ms")
            if gated:
                line += (f"; gated {device_ms(lambda: cuda_aug.warp_reflect(img, flow, -1.0, gate)):.4f}"
                         " ms")
            print(line)
        for shape in NORM_SHAPES if want("K4") else ():
            x = torch.randn(*shape, generator=g, device=dev).to(dt)
            kern = lambda: cuda_norm.instance_norm_fused(x, relu=True)  # noqa: E731
            stats = lambda: cuda_norm.instance_norm_stats(x)  # noqa: E731
            print(f"  K4 {shape} {dt}: {device_ms(kern):.4f} ms, host {host_us(kern):.1f} us; "
                  f"F.instance_norm {device_ms(lambda: F.instance_norm(x)):.4f} ms; "
                  f"K4s {device_ms(stats):.4f} ms; torch.batch_norm_stats "
                  f"{device_ms(batch_norm_stats_call(x)):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
