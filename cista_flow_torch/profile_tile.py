"""What each phase of the tensor-core conv tile costs, on the card.

    python3 -m cista_flow_torch.profile_tile [--batch 8] [--channels 64]

The card's profilers that read a kernel's stalls are not always at hand, so
this builds ``csrc/ista.cu`` several times, each with one phase of
``csrc/conv3x3_mma.cuh`` cut out of a copy of the sources (the products, the
staging loads, the epilogue), and times one D launch (2C -> C) and one P
launch (C -> 2C) of each build at K3's serving shape, 90x120. A cut build
computes garbage; only its time is read. The difference to the whole kernel
says how much of a launch a phase accounts for when nothing else hides it.
The copies and their libraries go under the ignored ``build/tile_variants``.
Needs a CUDA card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess

import torch

from .ops import conv_tile
from .ops.cuda_build import BUILD_DIR, CSRC, NVCC_FLAGS, I, P, _nvcc

TILE, EPILOGUES = "conv3x3_mma.cuh", "ista_mma.cuh"
NO_X = (TILE, "if (p < PIX) {", "if (p < 0) {")
NO_W = (TILE, "for (int j = tid; j < TL::WS_CHUNKS; j += NT) {",
        "for (int j = tid; j < 0; j += NT) {")
NO_MMA = (TILE, "wgmma_m64k16(acc[mt], da, db);", "")
NO_EPILOGUE = (EPILOGUES,
               "        const int c0 = n0 + conv3x3_mma::pair_channel();\n        // every aux",
               "        if (H > 0) return;\n"
               "        const int c0 = n0 + conv3x3_mma::pair_channel();\n        // every aux")
# name -> (file, text, replacement) edits of a copy of csrc/
VARIANTS = {
    "whole kernel": (),
    "no products": (NO_MMA,),
    "no input loads": (NO_X,),
    "no weight loads": (NO_W,),
    "no loads": (NO_X, NO_W),
    "no loads, no products": (NO_X, NO_W, NO_MMA),
    "no epilogue": (NO_EPILOGUE,),
}


def build(name: str, edits):
    """Copy csrc/, apply the edits, start nvcc on the copy's ista.cu."""
    src = BUILD_DIR.parent / "tile_variants" / name.replace(" ", "_").replace(",", "")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    for fname, old, new in edits:
        text = (src / fname).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: {fname} no longer contains {old!r}")
        (src / fname).write_text(text.replace(old, new))
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(src / "ista.so"), str(src / "ista.cu")]
    return src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def time_us(fn, reps: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) * 1e3)
    return float(statistics.median(ts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--channels", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_tile: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    bsz, c, h, w = args.batch, args.channels, 90, 120
    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x1g = conv_tile.to_grouped(randn(bsz, c, h, w))
    zg = conv_tile.to_grouped(randn(bsz, 2 * c, h, w, scale=0.1))
    dwp = conv_tile.pack_weights(randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5))
    pwp = conv_tile.pack_weights(randn(2 * c, c, 3, 3, scale=(9 * c) ** -0.5))
    db, pb = randn(c, scale=0.05), randn(2 * c, scale=0.05)
    lam = torch.full((2 * c,), 0.01, device=dev, dtype=dt)
    xd, zo = torch.empty_like(x1g), torch.empty_like(zg)
    stream = torch.cuda.current_stream().cuda_stream

    jobs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    libs = {}
    for name, (src, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(src / "ista.so"))
        lib.cista_ista_conv_mma.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, P]
        libs[name] = lib

    def launch(lib, mode, src, wp, bias, aux, out, cin, cout):
        rc = lib.cista_ista_conv_mma(mode, src.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                                     aux.data_ptr(), lam.data_ptr(), out.data_ptr(),
                                     bsz, cin, cout, h, w, stream)
        if rc != 0:
            raise RuntimeError(f"cista_ista_conv_mma: CUDA error {rc}")

    flop = 2 * 9 * 2 * c * c * bsz * h * w
    print(f"one launch at ({bsz},{c},{h},{w}), bf16, {flop * 1e-9:.2f} GFLOP, on {smi}")
    for rnd in range(2):                       # twice, to show the spread
        for name, lib in libs.items():
            d = time_us(lambda: launch(lib, 0, zg, dwp, db, x1g, xd, 2 * c, c))
            p = time_us(lambda: launch(lib, 1, x1g, pwp, pb, zg, zo, c, 2 * c))
            print(f"  round {rnd + 1}  {name:<24s} D {2 * c}->{c} {d:7.1f} us   "
                  f"P {c}->{2 * c} {p:7.1f} us")
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
