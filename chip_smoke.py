#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (cista_flow_torch) on one CUDA card.

    python3 chip_smoke.py [--kernels-only | --train-only | --pretrain-only | --dp-only |
                           --spatial-only | --spatial-cards | --spatial-train-only |
                           --mvsec-only | --chairs2-only | --surface-only]

Phases (any failure raises and the exit code is non-zero):
 1. the card: ``nvidia-smi`` name and power limit, torch's device name;
 2. build the CUDA kernels from ``cista_flow_torch/csrc`` (one nvcc for each
    source, in parallel) into the ignored ``build/kernels``, and the host
    event library (``events/native.py``: g++ on ``csrc/host/cista_events.cpp``)
    into the ignored ``build/host``;
 3. each of the eight kernels (K1, K2, K3, K3a, K4, K4s, K5, K6) against its
    plain PyTorch version on the card, at the shapes the serving paths give
    it (180x240 frames, batch 8), in bf16 and f32 (cuDNN's TF32 off for the
    phase, through the port's ``device.cudnn_fp32``): max abs
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
    window's 136 samples. With them (``kernels_at_new_shapes``): K1, K2, K3,
    K4 and K5 at the shapes MVSEC's 260x346 frame gives them at batch 1
    (phase 15; the flow net's frame padded to 288x352), and K1, K4 and K5
    at the chairs2 crop's (352x480, batch 4; phase 11 (e)), in both dtypes,
    timed. ``--kernels-only`` stops here;
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
    default route;
 5. f32 at the process's TF32 defaults: one f32 ``Reconstructor`` (cista-eiflow
    (6, 5)) held against the CPU within 1e-4 with cuDNN's flags as PyTorch
    sets them (TF32 on): the runner turns TF32 off for its own calls and
    restores the flags. The same model stepped outside the runner shows what
    TF32 costs;
 6. the gate replay: the held-out sequences written by the port's simulator
    (``data.sim.ensure_eval_data``), every row of tests/test_quality_gate.py
    through ``evaluate.evaluate_sequences`` on the card, in f32 (each metric
    within 0.2% of gate/targets_*.json) and bf16 (each metric's deviation
    printed, psnr, ssim and epe held to the gate's absolute floors), with
    the launch counts of every row;
 6b. the serving CLIs (``serving_clis``), on streams written into the
    ignored ``build/cli_data`` from the gate data: ``test_noeval`` on a .txt
    stream under cista-eiflow (6, 5), ``test_wo_flow`` on an ECD-layout
    .zip stream under cista-eraft (12, 5), ``test_with_flow --is_gt_flow``
    under cista-gtflow with the flagship anchor (its flow net's keys
    dropped), each in f32 against the same CLI on the CPU and in bf16
    against the gate's floors, launches per window counted, frames/s and
    the host split per window printed; test_noeval's voxels under ``--dvs
    samsung`` at 480x640 and a ``flow_half`` window against the plain
    path; ``ops/voxel.py`` against the numpy golden at 15,000 and 500,000
    events;
 7. the ``cista-idnet`` path at (1, 2) and (1, 5), the checks of 4;
 8. one 160-step chunk (``bench.py``'s chunk) in bf16 against f32 at batch 1
    at eiflow (1,1) and (6,5), eraft (1,1) and (12,5) and idnet (1,2): above
    30 dB PSNR at every step;
 9. training (``training_path``): a simulated training set written by the
    port (``data.sim.write_train_dataset``) into the ignored
    ``build/train_data``; one f32 train step on the card against the same
    step on the CPU (plain versions) in phase 2 and in phase 3's flow half
    (``gate/flagship_ft1_f16.npz``, T = 2, batch 1): the loss, every
    gradient leaf, and a nonzero gradient on the card wherever the CPU has
    one; K1, K3 and K5 against their plain versions after a real
    ``optimizer.step()`` on weights whose packed copies were cached before
    it; then ``train.Trainer`` at full width from
    ``gate/flagship_sim40_f16.npz`` ((6,5)), T = 10, batch 4, every phase
    and both halves of phase 3, in f32 and then bf16, with the launches of
    every step (forward only: the gradients are autograd of the plain
    versions), the frozen subnet bit for bit over every step, device ms per
    step and its forward/backward split, and the peak memory; bf16 with f32
    master parameters and a loss that falls over 3 steps on one repeated
    batch, and the cosine of its first-step gradients with f32's; the
    saved checkpoint served by ``Reconstructor`` over one 16-step window;
10. training in every other mode (``train_modes``): one f32 train step on
    the card against the CPU, T = 2, batch 1, for cista-eraft (1,1) in
    phase 1 and phase 3's flow half, cista-idnet (1,2) and cista-gtflow at
    depth 5 (``MODE_STEPS``), with ``leaf_report`` and the launches of
    each step (``train_launches`` per mode); bf16 at each mode's reference
    default (eraft (12,5), idnet (1,5), gtflow depth 5), T = 10, batch 4:
    device ms per step, its forward/backward/optimizer split, the device-busy
    share and the peak memory; remat on and off at eraft (12,5) (loss,
    gradients, run-to-run, BN counts, both peaks); the exact resume through
    ``train.Trainer`` against an uninterrupted run; a reduced
    ``sim_quality`` (cista-gtflow) whose trained net must beat the untrained
    one on PSNR.
11. flow-net pretraining (``flow_pretraining``): (a) one f32
    ``pretrain_flow.make_train_step`` step on the card against the CPU at
    64x96, batch 2, for DCEIFlow (bidirectional), E-RAFT and RAFT (loss to
    1e-6 relative, ``leaf_report``, launches per ``pretrain_launches``), and
    one ``--opt raft`` step with the clip set below the gradient's norm (the
    clipped gradients against the CPU's, their norm the clip, the update
    AdamW's first from the clipped gradient at the schedule's rate);
    (b) bf16 steps at full width (``PRETRAIN_BF16``: DCEIFlow and E-RAFT
    at 180x240, batch 8, 6 and 12 iterations; RAFT at 384x512, batch 10,
    12 iterations, on seeded RGB-like data): device ms, the kernel time of
    a traced step split into forward, backward and optimizer, busy share,
    peak memory, launches; (c) run with the kernel checks of phase 3: K1,
    K2, K4 and K5 at the pretraining shapes against their plain versions
    and timed, and K3a and K4s with gradients on the card in f32 and bf16;
    (d) a reduced ``sim_flow_quality`` (``FLOW_SMOKE``) whose trained EPE
    must be below the untrained one's, its checkpoint then loaded through
    ``--path_to_flownet`` into a one-epoch ``sim_quality`` of cista-eiflow;
    (e) FlyingChairs2 (``chairs2_pretraining``): a chairs2-layout folder of
    12 simulated samples at 384x512 written by the port (RGB PNG pairs with
    Paeth-filtered rows, ``.flo`` both ways, HDF5 events) into the ignored ``build/chairs2_data``,
    then ``python -m cista_flow_torch.pretrain_flow --data_kind chairs2``'s
    ``main`` in bf16 at the /32 crop 352x480, batch 4, one epoch (3 steps),
    for DCEIFlow (``--is_bi``) and RAFT (``--opt raft``): finite losses,
    launches per step, device ms per step and busy share, host ms per batch
    by item (PNG decode, ``.flo``, HDF5, voxelization, augmentation), peak
    memory, the checkpoint loaded strictly.
12. data-parallel training (``data_parallel``): (a) two ranks on the one
    card over gloo (NCCL refuses two ranks on one card; a correctness
    check, not a speed figure): cista-eiflow (6,5) from the sim40 anchor at
    180x240, one f32 step, T = 2, global batch 2, in phase 2 and phase 3's
    flow half, against one process on the global batch on the card (loss,
    ``leaf_report``, BN running statistics, both ranks' states the same,
    launches per rank ``train_launches``); bf16, T = 10, global batch 4, 3
    steps: device ms per step per rank, busy share, peak memory, launches;
    (b) ``python -m cista_flow_torch.train --distributed`` (NCCL, a rank
    per card) for one epoch and its exact resume for a second, one writer,
    the resumed epoch traced: the prefetcher's copies on a side stream;
    (c) with two cards or more, K4 and K5 on cuda:1 from a thread whose
    current device is cuda:0 (the launches' device guard), then (a)'s
    checks with two ranks on two cards over NCCL; on one card a line says
    so.
13. row-sharded serving (``spatial``, ``--mesh_shape 2 --mesh_axes
    spatial``): with the kernel checks of phase 3, K2 with an output row
    offset (``K2b``) at the bands of 2 ranks at 180x240 and 480x640 against
    its plain version, timed at the code's band, and K3 on a band widened
    by its halo beside the bare band; (a) two ranks sharing the card over
    gloo (a correctness check, not a speed figure), batch 1,
    ``SPATIAL_STEPS`` = 8 steps (16 until the MVSEC phase was added), at
    180x240 and 480x640: cista-eiflow (6,5) and cista-eraft (12,5) from the
    sim40 anchors (eraft's window, and 8 x ``step`` at 180x240),
    cista-gtflow (depth 5, GT flows), cista-idnet (1,5) from its sim40
    anchor (``next_flow`` chained) and cista-eiflow ``flow_half`` (6,5) (the
    flow net on the bands of the half frame), f32 against one process on the card
    within 1e-3, bf16 above 30 dB per step against it, each rank's
    launches of K1, K2, K3, K4s and K5
    (``rank_launches``), the bytes each rank sends per step; (b)
    ``python -m cista_flow_torch.test_noeval --mesh_shape 2 --mesh_axes
    spatial`` as a command, the same files as one process; (c) with two
    cards or more, (a)'s bf16 windows on two NCCL ranks, a card each:
    device ms per step and the exchanges' share beside one card's.
14. row-sharded training (``spatial_training``, ``train --mesh_shape 1,2
    --mesh_axes data,spatial``'s step): (a) a ``1,2`` mesh of two gloo
    ranks sharing the card, cista-eiflow (6,5) from the sim40 anchor at
    180x240: one f32 step, T = 2, batch 1, in phase 2 and phase 3's flow
    half against one process on the card (loss, ``leaf_report``, BN
    running statistics, both ranks' states the same, launches per rank
    ``spatial_train_launches``: K1, K2, K3, K4s and K5 on each rank); bf16,
    phase 3's flow half, T = 10, 3 steps: device ms per step per rank,
    launches, peak memory per rank, MB each rank's exchanges send per
    step; (c) with two cards or more, (a) over NCCL, a card a rank.
15. MVSEC (``mvsec_eval``): (a) ``data.sim.write_mvsec_hdf5`` writes
    indoor_flying4 at DAVIS346's 260x346 into the ignored
    ``build/mvsec_data`` through the port's HDF5 writer, and its reader
    gives back a pair's events and a frame bit for bit; (b) ``python -m
    cista_flow_torch.test_mvsec`` as a command under cista-eiflow (6,5)
    (sim40 anchor), windows of 20000 events (1 or 2 a frame pair), f32 on
    the card against ``--device cpu`` over 6 items (``all.csv`` within one
    step of its 4-decimal rounding), then in this process over 10 items
    with the launches of every window, both commands started at once; (c)
    bf16: mean PSNR within 0.05 dB and SSIM within 0.002 of f32's, and
    above the gate's floors; (d) windows/s and the
    host split per window; (e) ``evaluate --harness_mode mvsec``: targets
    saved, then held at 1%.
16. The library surface (``library_surface``): (a) the host event library:
    its voxels bit for bit numpy's at 20000 events (260x346) and 15000
    (180x240), ``preprocess_std`` and the triangular voxel within rtol 1e-5
    / atol 1e-6 of numpy's, host ms per window against numpy, and phase 15
    (d)'s host split on the library and on numpy in the same call; (b)
    ``test_mvsec --mesh_shape 2 --mesh_axes spatial``'s body on two gloo
    ranks sharing the card over phase 15's recording (f32 ``all.csv``
    within 1e-4 of one process's, bf16 above the floors and within
    ``MVSEC_BF16_DEV`` of f32, each rank's launches); (c) ``SmallEncoder``,
    ``SmallUpdateBlock``, ``lookup_efficient_corr`` (also against K1's
    lookup of the materialised pyramid) and the cell variants on the card
    in f32 and bf16 against the CPU; (d) ``BasicEncoder`` and
    ``SmallEncoder`` with group norm at 180x240, batch 8, f32 and bf16
    against the CPU, K5's launches, event ms a call; (e) the trainer's
    command line with no ``--model_mode`` (``cista-lstc``),
    ``--is_SummaryWriter`` and ``--no_shuffle`` for one epoch of a tiny
    simulated set: its checkpoint, its TensorBoard log directory (or, where
    tensorboard is missing, the message saying so), K3 and K5.
    ``--train-only`` runs the build, the kernel checks and phases 9 to 12;
    ``--dp-only`` the build and phase 12; ``--spatial-only`` the build,
    phase 13's kernel checks and phase 13, ``--spatial-cards`` the build
    and its (c); ``--spatial-train-only`` the build and phase 14;
    ``--pretrain-only`` the build, (c) and phase 11; ``--mvsec-only`` the
    build, the checks at the new shapes and phase 15; ``--chairs2-only`` the
    build and phase 11 (e); ``--surface-only`` the build and phase 16.
    ``--grad-sources``
    (not part of the smoke) builds and then compares the card's f32
    pretraining gradients and the CPU's with an f64 evaluation under
    settings that each take one suspect out (``grad_sources``).
Each phase prints its time. The last lines are the ``kernels`` JSON (K1,
K2, K4 and K4s with a row for each timed shape under ``shapes``, K1, K2,
K4 and K5 also at the pretraining shapes, K1-K5 at MVSEC's (``path``
'mvsec') and K1, K4, K5 at the chairs2 crop's ('chairs2'); ``K2b``, K2 on the row bands of
phases 13 and 14, its launches the ranks' K2 launches, the training
loss's whole-frame warps among them), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
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
IDNET_POINTS = ((1, 2, "gate/idnet_ft2_f16.npz"), (1, 5, "gate/idnet_sim40_f16.npz"))
NORMS = 15               # instance norms in one BasicEncoder call
SQUARE_CONVS = 7         # its 64->64 and 128->128 3x3 convs (kernel K5)
IDNET_SQUARE_CONVS = 3   # the LiteEncoder's 64->64 3x3 convs (K5), one call a step
CHUNK = 160              # bench.py's chunk: steps of one bf16-vs-f32 drift run
# tests/test_quality_gate.py:53-70: row -> (model_mode, anchor, targets, depth, iters)
GATE_ROWS = {
    "cista-eiflow": ("cista-eiflow", "flagship_sim40_f16", "targets_sim_eiflow.json", 5, None),
    "cista-eraft": ("cista-eraft", "eraft_sim40_f16", "targets_sim_eraft.json", 5, None),
    "cista-idnet": ("cista-idnet", "idnet_sim40_f16", "targets_sim_idnet.json", 5, None),
    "serve-eiflow-d1i1": ("cista-eiflow", "flagship_ft1_f16", "targets_sim_flagship_ft1.json",
                          1, 1),
    "serve-idnet-d2": ("cista-idnet", "idnet_ft2_f16", "targets_sim_idnet_ft2.json", 2, None),
    "serve-eraft-d1i1": ("cista-eraft", "eraft_ft1_f16", "targets_sim_eraft_ft1.json", 1, 1),
}
# tests/test_quality_gate.py:32-44: the absolute floors of a trained anchor
GATE_FLOORS = {"cista-eiflow": {"psnr": 22.5, "ssim": 0.75, "epe": 1.0},
               "cista-eraft": {"psnr": 22.0, "ssim": 0.72, "epe": 1.6},
               "cista-idnet": {"psnr": 22.0, "ssim": 0.72, "epe": 3.0}}
GATE_FRAMES = 30         # frames per held-out sequence; 2 sequences
GATE_TOLERANCE = 0.002
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
    modes = ("--kernels-only", "--train-only", "--pretrain-only", "--grad-sources",
             "--dp-only", "--spatial-only", "--spatial-cards", "--spatial-train-only",
             "--mvsec-only", "--chairs2-only", "--surface-only")
    if argv not in ([], *([m] for m in modes)):
        print(f"usage: chip_smoke.py [{' | '.join(modes)}]", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from cista_flow_torch.device import cudnn_fp32
    t_start = time.perf_counter()

    # ---- 1. the card ------------------------------------------------------
    smi = nvidia_smi()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, count {torch.cuda.device_count()}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    from cista_flow_torch.ops import cuda_build
    # each wrapper's launch counter; K3a and K4s share K3's and K4's library
    counters = cuda_build.kernel_counters()
    sources = [k for k in counters.values() if isinstance(k, cuda_build.Kernel)]
    secs = cuda_build.build_all(sources)
    print(f"build: {secs:.1f} s for {len(sources)} sources, {len(counters)} kernels")
    from cista_flow_torch.events import native
    t_host = time.perf_counter()
    built = not native.so_path().exists()
    native.get_lib()
    HOST_LIB_BUILD.update(seconds=round(time.perf_counter() - t_host, 3), built_now=built,
                          command=" ".join([native.COMPILER, *native.CXX_FLAGS]))
    print(f"host event library: {HOST_LIB_BUILD}")
    for k in sources:
        print(f"  ptxas {k.name}: {ptxas_summary(k.build_log)}")
    if argv == ["--grad-sources"]:
        grad_sources(torch, repo)
        return 0

    # ---- 3. kernels against their plain versions --------------------------
    # (the f32 plain versions are cuDNN convs: held in full f32 for the phase)
    checks = {}
    alone = (["--dp-only"], ["--spatial-only"], ["--spatial-cards"], ["--spatial-train-only"],
             ["--mvsec-only"], ["--chairs2-only"], ["--surface-only"])
    if argv not in (["--pretrain-only"], *alone):
        with cudnn_fp32():
            checks = kernel_checks(torch)
    # phase 11 (c): the kernels at the pretraining shapes, K3a and K4s with gradients
    if argv not in alone:
        for key, rows in kernels_at_pretrain_shapes(torch).items():
            checks.setdefault(key, {}).setdefault("shapes", []).extend(rows)
    # the shapes of phases 15 (MVSEC) and 11 (e) (chairs2)
    if argv in ([], ["--kernels-only"], ["--mvsec-only"]):
        for key, rows in kernels_at_new_shapes(torch).items():
            checks.setdefault(key, {}).setdefault("shapes", []).extend(rows)
    # phase 13's kernels: K2 on row bands (K2b), K3 on a widened band (timed
    # here: after phase 12 the profiler's traces lose kernel records)
    if argv in ([], ["--kernels-only"], ["--spatial-only"]):
        banded_k2(torch)
        widened_k3(torch)
    torch.cuda.synchronize()
    print(f"phase 3 done at {time.perf_counter() - t_start:.1f} s")
    if argv == ["--kernels-only"]:
        return 0

    # ---- 4.-14. the main paths, at the process's own TF32 flags ----------
    # (K2b: K2's launches on the ranks of phases 13 and 14)
    launches = {k: 0 for k in (*counters, "K2b")}
    phases = (flagship_path, eraft_path, variant_windows, f32_at_default_flags,
              gate_replay, serving_clis, idnet_path, long_chunks, training_path, train_modes,
              flow_pretraining, data_parallel, spatial, spatial_training, mvsec_eval,
              library_surface)
    if argv:
        phases = {"--train-only": phases[8:12], "--pretrain-only": (flow_pretraining,),
                  "--dp-only": (data_parallel,), "--spatial-only": (spatial,),
                  "--spatial-cards": (spatial_across_cards,),
                  "--spatial-train-only": (spatial_training,),
                  "--mvsec-only": (mvsec_eval,),
                  "--chairs2-only": (chairs2_pretraining,),
                  "--surface-only": (library_surface,)}[argv[0]]
    for phase in phases:
        t_phase = time.perf_counter()
        for key, n in phase(torch, repo, counters).items():
            launches[key] += n
        now = time.perf_counter()
        print(f"{phase.__name__}: {now - t_phase:.1f} s, done at {now - t_start:.1f} s")
    idle = [k for k, n in launches.items() if n == 0]
    if argv:
        pretraining = argv in (["--pretrain-only"], ["--chairs2-only"])
        path = ("K1", "K2", "K4", "K5") + (() if pretraining else ("K3",))
        path += ("K4s", "K2b") if argv in (*alone[1:4], ["--surface-only"]) else ()
        idle = [k for k in path if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    if argv in (["--pretrain-only"], *alone):
        return 0

    rows = []
    for key, (name, source, replaces) in KERNELS.items():
        c = checks[key]
        rows.append({"name": f"{key} {name}", "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": c["max_abs_err"], "ms": c["ms"],
                     "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
                     "bound_by": c["bound_by"], "library_ms": c["library_ms"],
                     **({"shapes": c["shapes"]} if "shapes" in c else {})})
    name, source, replaces = KERNELS["K2"]
    rows.append({"name": f"K2b {name} (row band)", "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches["K2b"], **SPATIAL_K2})
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


def k1_checks(torch, randn, dtype, shapes=None) -> dict:
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
    with and without convc1 at the first two shapes. ``shapes`` replaces
    ``CORR_SHAPES`` (each then timed)."""
    from cista_flow_torch.ops import cuda_corr
    from cista_flow_torch.ops.corr import CorrPyramid, coords_grid
    from cista_flow_torch.profile_kernels import CORR_SHAPES

    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    es = torch.tensor([], dtype=dt).element_size()
    rows = []
    for b, h1, w1 in shapes or CORR_SHAPES:
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


def window_launches(mode: str, iters: int, steps: int) -> dict:
    """Launches of one ``step_window`` of ``steps`` steps at batch 1 or B.
    cista-eiflow, per step: K1 per GRU iteration, the two warps, one ISTA
    call, fnet's and enet's norms, K5 for the three encoders' square convs
    and the upsamp conv. cista-eraft (the time-parallel window): fnet once
    over the T+1 voxels and cnet once over T, one flow call (K1 per GRU
    iteration), then per step the warps, the ISTA call and the upsamp conv.
    cista-idnet, per step: the warps, the ISTA call, K5 for the
    LiteEncoder's three 64->64 convs (one call over all bins) and the upsamp
    conv; no correlation and no norms. cista-lstc and cista-gtflow, per
    step: the warps, the ISTA call and the upsamp conv."""
    if mode in ("cista-lstc", "cista-gtflow"):
        return {"K2": 2 * steps, "K3": steps, "K5": steps}
    if mode == "cista-eiflow":
        return {"K1": iters * steps, "K2": 2 * steps, "K3": steps,
                "K4": 2 * NORMS * steps, "K5": (3 * SQUARE_CONVS + 1) * steps}
    if mode == "cista-eraft":
        return {"K1": iters, "K2": 2 * steps, "K3": steps, "K4": NORMS,
                "K5": 2 * SQUARE_CONVS + steps}
    return {"K2": 2 * steps, "K3": steps, "K5": (IDNET_SQUARE_CONVS + 1) * steps}


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
        got = serving_point(torch, repo, counters, "cista-eiflow", iters, depth, path,
                            window_launches("cista-eiflow", iters, STEPS))
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
        window = window_launches("cista-eraft", iters, STEPS)
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
    base = window_launches("cista-eraft", iters, steps)
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


def tf32_flags(torch) -> str:
    """cuDNN's TF32 switches as this PyTorch reports them."""
    cudnn = torch.backends.cudnn
    try:
        legacy = cudnn.allow_tf32
    except RuntimeError:
        legacy = "mixed"
    conv = getattr(cudnn, "conv", None)
    prec = getattr(conv, "fp32_precision", "absent")
    return f"cudnn.allow_tf32={legacy}, cudnn.conv.fp32_precision={prec}"


def f32_at_default_flags(torch, repo: Path, counters: dict) -> dict:
    """Phase 5: nothing in this script sets cuDNN's TF32 flags, so they are
    PyTorch's defaults (TF32 on for cuDNN convolutions). One f32
    Reconstructor, cista-eiflow (6, 5), against the same port on the CPU
    over 3 steps, with the flags as they were afterwards. The runner turns
    TF32 off for its own calls (``device.cudnn_fp32``); the same model
    stepped outside the runner, at the defaults, shows what TF32 does to an
    f32 step. Tolerance 1e-4: with TF32 off the two sides differ only in
    the order of f32 sums (1e-5 to 3e-5 at every point of phases 4 and 7 on
    an H100), where TF32's 10-bit mantissa moves the flows by 1e-3."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.runner import Reconstructor

    iters, depth, path = POINTS[1]
    cfg = Config(model_mode="cista-eiflow", image_dim=(H, W), depth=depth, flow_iters=iters,
                 path_to_test_model=str(repo / path))
    before = tf32_flags(torch)
    print(f"f32 at the process's TF32 defaults ({before}): cista-eiflow ({iters},{depth}), "
          "3 steps")
    ev = voxels(2, 3)
    cpu = Reconstructor(cfg, device="cpu").step_window(ev, return_all=True)
    rec = Reconstructor(cfg, device="cuda")
    gpu, got = counted(counters, lambda: rec.step_window(ev, return_all=True))
    expect_launches("f32 at default flags", got, window_launches("cista-eiflow", iters, 3))
    err = max(float(np.abs(a - b).max()) for a, b in zip(gpu, cpu))
    after = tf32_flags(torch)
    # the fault the runner's scoping removes: the model's own forward, unscoped
    raw = Reconstructor(cfg, device="cuda")
    recs, flows = [], []
    with torch.no_grad():
        for v in raw.device_events(ev):
            out, flow, raw.state = raw.model(v, raw.prev_image, raw.state, iters=iters)
            raw.prev_image = out
            recs.append(out[0, 0].float().cpu().numpy())
            flows.append(flow["flow_final"][0].float().cpu().numpy())
    err_raw = max(float(np.abs(np.stack(recs) - cpu[0]).max()),
                  float(np.abs(np.stack(flows) - cpu[1]).max()))
    print(f"  runner, f32: max abs err against the CPU {err:.3e} (tol 1e-4); the model's "
          f"forward outside the runner at these flags: {err_raw:.3e}; flags after: {after}")
    if err > 1e-4:
        raise AssertionError(f"f32 at the default flags differs from the CPU by {err}")
    if after != before:
        raise AssertionError(f"the runner left the flags changed: {before} -> {after}")
    return got


def gate_replay(torch, repo: Path, counters: dict) -> dict:
    """Phase 6: the quality gate on the card. The held-out sequences come
    from the port's simulator (2 sequences of 30 frames at 180x240, seed
    0, written anew into the ignored build/gate_data); each row of the JAX package's
    gate runs through ``evaluate.evaluate_sequences`` (one step_window per
    GT frame interval, the last step scored on the host in f32, the first
    3 frames skipped, the mean over sequences rounded to 4 places). f32:
    every metric within 0.2% of its target (symmetric relative deviation,
    denominators floored at 1e-3, as eval_harness). bf16: each metric's
    deviation printed, psnr, ssim and epe held to the gate's floors.
    Launches: every pack is one window of one step."""
    import contextlib
    import io
    import shutil

    from cista_flow_torch import evaluate
    from cista_flow_torch.config import Config
    from cista_flow_torch.data.sim import ensure_eval_data

    t0 = time.perf_counter()
    # made anew each run: ensure_eval_data keeps any sequence it finds
    data_dir = repo / "build" / "gate_data"
    shutil.rmtree(data_dir, ignore_errors=True)
    eval_dir = ensure_eval_data(str(data_dir), H, W, eval_frames=GATE_FRAMES, seed=0)
    packs = 2 * (GATE_FRAMES - 1)
    print(f"gate replay: held-out data in {time.perf_counter() - t0:.1f} s; "
          f"{len(GATE_ROWS)} rows x (f32, bf16), {packs} packs each")
    total = {k: 0 for k in counters}
    failures = []
    for row, (mode, stem, targets_name, depth, iters) in GATE_ROWS.items():
        with open(repo / "gate" / targets_name) as f:
            targets = json.load(f)
        for dtype in ("float32", "bfloat16"):
            cfg = Config(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters,
                         dtype=dtype, path_to_test_model=str(repo / "gate" / f"{stem}.npz"),
                         path_to_test_data=eval_dir, test_data_mode="upsampled",
                         is_write_image=False, output_folder=str(repo / "build" / "gate_out"))
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                (rows, keys, raw), got = counted(
                    counters, lambda: evaluate.evaluate_sequences(cfg, device="cuda"))
            secs = time.perf_counter() - t1
            per_pack = window_launches(mode, cfg.default_flow_iters(), 1)
            expect_launches(f"gate {row} {dtype}", got,
                            {k: n * packs for k, n in per_pack.items()})
            for key in total:
                total[key] += got[key]
            measured = evaluate.mean_metrics(rows, keys)
            ok, _ = evaluate.compare(measured, targets, GATE_TOLERANCE)
            dev = {k: (measured[k] - tv) / max(abs(tv), 1e-3) for k, tv in targets.items()}
            print(f"  {row} {dtype} ({secs:.1f} s): max |dev| "
                  f"{100 * max(abs(d) for d in dev.values()):.3f}%; "
                  + ", ".join(f"{k} {measured[k]:.4f} ({100 * d:+.3f}%)" for k, d in dev.items()))
            print("    unrounded: " + ", ".join(f"{k} {v:.6f}" for k, v in raw.items()))
            if dtype == "float32" and not ok:
                failures.append(f"{row} f32 beyond {100 * GATE_TOLERANCE:.1f}%: {dev}")
            if dtype == "bfloat16":
                fl = GATE_FLOORS[mode]
                if not (measured["psnr"] > fl["psnr"] and measured["ssim"] > fl["ssim"]
                        and measured["epe"] < fl["epe"]):
                    failures.append(f"{row} bf16 past the floors {fl}: {measured}")
    if failures:
        raise AssertionError("gate replay: " + "; ".join(failures))
    return total


CLI_FRAMES = 10          # frames of a sequence the serving CLIs read (test_img_num)
CLI_EVENTS = 15000       # the CLIs' --num_events (the reference's default)
CLI_STREAM = 32          # test_noeval's windows in bf16 (4 chunks of 8); 4 in f32 and on the CPU
SAMSUNG = (480, 640)     # test_noeval's frame size under --dvs samsung


def write_event_text(path: Path, events: np.ndarray, header=None) -> None:
    """Events (N, 4) as the reference's text stream (``t x y p``, ``%.9f``
    timestamps), after an optional ``W H`` header line; zipped (one member,
    ``events.txt``) when ``path`` ends in ``.zip``."""
    import zipfile
    txt = path.with_suffix(".txt")
    with open(txt, "w") as f:
        if header is not None:
            f.write(f"{header[1]} {header[0]}\n")
        np.savetxt(f, events, fmt="%.9f %d %d %d")
    if path.suffix == ".zip":
        with zipfile.ZipFile(path, "w") as z:
            z.write(txt, "events.txt")
        txt.unlink()


def cli_data(repo: Path) -> dict:
    """The CLIs' inputs in the ignored build/cli_data, from the gate data
    (phase 6 wrote it): the with-flow layout itself; sim_00's first
    CLI_FRAMES frames with their events as one headerless events.zip
    (ECD's layout); a .txt stream of sim_00's events with its header; a
    480x640 stream from the simulator for --dvs samsung; and all of
    sim_00's events (``events``, 577k) for the device voxelization."""
    import shutil

    from cista_flow_torch.data.sim import ensure_eval_data, simulate_sequence
    gate = Path(ensure_eval_data(str(repo / "build" / "gate_data"), H, W,
                                 eval_frames=GATE_FRAMES, seed=0))
    root = repo / "build" / "cli_data"
    shutil.rmtree(root, ignore_errors=True)
    seq, ecd = gate / "sim_00", root / "ecd" / "sim_00"
    ecd.mkdir(parents=True)
    windows = []
    for i in range(GATE_FRAMES - 1):
        with np.load(seq / f"events_{i:06d}.npz") as z:
            windows.append(np.stack([z["t"], z["x"], z["y"], z["p"]], 1))
    for i in range(CLI_FRAMES):
        shutil.copy(seq / f"frame_{i:04d}.png", ecd)
    shutil.copy(seq / "timestamps.txt", ecd)
    events = np.concatenate(windows)
    write_event_text(ecd / "events.zip", np.concatenate(windows[:CLI_FRAMES - 1]))
    write_event_text(root / "stream.txt", events[:CLI_STREAM * CLI_EVENTS], header=(H, W))
    big = simulate_sequence(5, 2, *SAMSUNG)["events"][0]
    write_event_text(root / "samsung.txt", np.stack(big, 1)[:4 * CLI_EVENTS], header=SAMSUNG)
    return {"gate": gate, "ecd": root / "ecd", "stream": root / "stream.txt",
            "samsung": root / "samsung.txt", "events": events, "out": root / "out"}


def recorded_windows():
    """A context in which every ``Reconstructor.step_window`` call appends
    its window length to the list it yields."""
    import contextlib

    from cista_flow_torch.runner import Reconstructor

    @contextlib.contextmanager
    def ctx():
        lengths, step_window = [], Reconstructor.step_window

        def recorded(self, voxels, *args, **kwargs):
            lengths.append(len(voxels))
            return step_window(self, voxels, *args, **kwargs)
        Reconstructor.step_window = recorded
        try:
            yield lengths
        finally:
            Reconstructor.step_window = step_window
    return ctx()


def read_pngs(base: Path) -> dict:
    """The reconstructions a CLI wrote under ``base``, decoded."""
    from cista_flow_torch.data.png import read_png
    return {str(p.relative_to(base)): read_png(str(p)) for p in sorted(base.rglob("frame_*.png"))}


def serving_clis(torch, repo: Path, counters: dict) -> dict:
    """Phase 6b: the three serving CLIs of the port at 180x240 on the gate
    anchors, as a user runs them (``evaluate_sequences``/``run`` of
    ``cista_flow_torch.test_*``, PNG writing on): ``test_noeval`` on a .txt
    stream under cista-eiflow (6,5), ``test_wo_flow`` on an ECD-layout
    .zip stream under cista-eraft (12,5) ('real' windows of 15000 events),
    ``test_with_flow --is_gt_flow`` under cista-gtflow with the flagship
    anchor's reconstructor (its flow net's keys dropped). Each in f32 on
    the card against the same CLI on the CPU (the mean row within 0.2%;
    test_noeval's written frames within one gray level) and in bf16 (the
    gate's floors; test_noeval: above 30 dB PSNR against f32), with the
    launches of every window as ``window_launches`` reckons them; frames/s
    (host clock, the second bf16 run) and the host split per window. Then
    the shapes no earlier phase holds, against the plain path on the CPU
    at phase 4's 1e-3: test_noeval's voxels under --dvs samsung at 480x640
    (K1 at n = 60*80, K5 on 640-px rows, K3 at (1, 128, 240, 320)) and one
    flow_half window at (6,5) (the flow net at 90x120, K1 at n = 12*16);
    and ``ops/voxel.py`` on the card against the numpy golden at 15,000
    and 500,000 events."""
    import contextlib
    import io as _io

    from cista_flow_torch import evaluate, test_noeval, test_with_flow, test_wo_flow
    from cista_flow_torch.config import Config
    from cista_flow_torch.data.readers import FixedSizeEventReader
    from cista_flow_torch.runner import Reconstructor
    from cista_flow_torch.timing import HostSplit

    t0 = time.perf_counter()
    data = cli_data(repo)
    print(f"serving CLIs: data in {time.perf_counter() - t0:.1f} s (build/cli_data)")
    cases = (
        ("test_noeval", "cista-eiflow", 6, 5, "flagship_sim40_f16",
         dict(path_to_test_data=str(data["stream"]), num_events=CLI_EVENTS, test_img_num=3)),
        ("test_wo_flow", "cista-eraft", 12, 5, "eraft_sim40_f16",
         dict(path_to_test_data=str(data["ecd"]), num_events=CLI_EVENTS, test_data_mode="real",
              test_img_num=CLI_FRAMES, is_write_event=True, is_write_flow=True)),
        ("test_with_flow", "cista-gtflow", None, 5, "flagship_sim40_f16",
         dict(path_to_test_data=str(data["gate"]), test_data_mode="upsampled", is_gt_flow=True,
              test_img_num=CLI_FRAMES, is_write_flow=True)))
    total = {k: 0 for k in counters}
    failures = []
    for cli, mode, iters, depth, stem, flags in cases:
        module = {"test_noeval": test_noeval, "test_wo_flow": test_wo_flow,
                  "test_with_flow": test_with_flow}[cli]
        tag = f"{cli} {mode} ({iters},{depth})"
        out = {}
        # test_noeval's bf16 runs read the whole stream: CLI_STREAM windows
        longer = {"test_img_num": CLI_STREAM - 1} if cli == "test_noeval" else {}
        for run, dtype, device in (("f32", "float32", "cuda"), ("cpu", "float32", "cpu"),
                                   ("bf16", "bfloat16", "cuda"), ("bf16 again", "bfloat16", "cuda")):
            folder = data["out"] / cli / run.replace(" ", "_")
            cfg = Config(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters,
                         dtype=dtype, path_to_test_model=str(repo / "gate" / f"{stem}.npz"),
                         output_folder=str(folder),
                         **{**flags, **(longer if dtype == "bfloat16" else {})})
            split = HostSplit()
            t1 = time.perf_counter()
            with recorded_windows() as lengths, contextlib.redirect_stdout(_io.StringIO()):
                result, got = counted(counters, lambda: (module.run if cli == "test_noeval"
                                                         else module.evaluate_sequences)(
                    cfg, device=device, split=split))
            secs = time.perf_counter() - t1
            if device == "cuda":
                want = {}
                for n in lengths:
                    for k, v in window_launches(mode, cfg.default_flow_iters(), n).items():
                        want[k] = want.get(k, 0) + v
                expect_launches(f"{tag} {run} ({secs:.1f} s), {len(lengths)} windows of "
                                f"{sum(lengths)} steps", got, want)
                for key in total:
                    total[key] += got[key]
            if device == "cpu":
                print(f"  {tag} on the CPU: {secs:.1f} s")
            out[run] = (result, read_pngs(folder), split, secs, sum(lengths))
        steps = out["bf16 again"][4]
        split = out["bf16 again"][2]
        loop = sum(split.seconds.values())
        ms = split.per_window_ms()
        print(f"  {tag}: bf16 {steps / loop:.1f} frames/s over the loop, "
              f"{steps / out['bf16 again'][3]:.1f} with the model's load ({steps} steps); "
              "host ms per window: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
              + f"; largest besides the device call: "
              f"{max((k for k in ms if k != 'device'), key=ms.get)}; on {nvidia_smi()}")
        print(f"    f32: {out['f32'][4] / sum(out['f32'][2].seconds.values()):.1f} frames/s "
              "over the loop")
        if cli == "test_noeval":
            a, b, c = out["f32"][1], out["cpu"][1], out["bf16"][1]
            if not a or list(a) != list(b) or not set(a) <= set(c):
                failures.append(f"{tag}: written frames differ: {list(a)} {list(b)} {list(c)}")
                continue
            lv = max(int(np.abs(a[k].astype(int) - b[k].astype(int)).max()) for k in a)
            psnr = min(psnr_per_step([a[k] / 255.0 for k in a], [c[k] / 255.0 for k in a]))
            print(f"    f32 card vs cpu: written frames within {lv} gray level(s) (tol 1); "
                  f"bf16 vs f32 frames: min PSNR {psnr:.2f} dB (> {PSNR_MIN})")
            if lv > 1 or psnr <= PSNR_MIN:
                failures.append(f"{tag}: f32 {lv} levels from the cpu, bf16 {psnr:.2f} dB")
            continue
        rows = {run: out[run][0] for run in out}
        keys = rows["f32"][1]
        gpu, cpu, bf = (evaluate.mean_metrics(rows[r][0], keys) for r in ("f32", "cpu", "bf16"))
        ok, _ = evaluate.compare(gpu, cpu, GATE_TOLERANCE)
        dev = {k: (gpu[k] - v) / max(abs(v), 1e-3) for k, v in cpu.items()}
        print(f"    f32 card vs cpu, mean row: max |dev| {100 * max(map(abs, dev.values())):.4f}% "
              f"(tol {100 * GATE_TOLERANCE:.1f}%): " + ", ".join(f"{k} {v:.4f}" for k, v in gpu.items()))
        fl = GATE_FLOORS["cista-eiflow" if mode == "cista-gtflow" else mode]
        above = bf["psnr"] > fl["psnr"] and bf["ssim"] > fl["ssim"] and bf.get("epe", 0.0) < fl["epe"]
        print(f"    bf16 mean row: " + ", ".join(f"{k} {v:.4f}" for k, v in bf.items())
              + f"; floors {fl}: {'above' if above else 'BELOW'}")
        if not ok:
            failures.append(f"{tag}: f32 card vs cpu beyond 0.2%: {dev}")
        if not above:
            failures.append(f"{tag}: bf16 past the floors {fl}: {bf}")

    # new shapes, against the plain path on the CPU (phase 4's 1e-3)
    flagship = str(repo / "gate" / "flagship_sim40_f16.npz")
    cfg = Config(model_mode="cista-eiflow",
                 image_dim=SAMSUNG, depth=5, flow_iters=6, path_to_test_model=flagship,
                 dvs="samsung", num_events=CLI_EVENTS)
    windows = list(FixedSizeEventReader(str(data["samsung"]), CLI_EVENTS))[:2]
    vox = np.stack([test_noeval.voxelize(w, cfg) for w in windows])
    flow_half = Config(model_mode="cista-eiflow",
                       image_dim=(H, W), depth=5, flow_iters=6, path_to_test_model=flagship,
                       flow_half=True)
    for tag, c, ev in ((f"test_noeval --dvs samsung voxels {SAMSUNG[0]}x{SAMSUNG[1]}", cfg, vox),
                       ("flow_half window (6,5)", flow_half, voxels(7, 2))):
        rec = Reconstructor(c, device="cuda")
        gpu, got = counted(counters, lambda: rec.step_window(ev, return_all=True))
        expect_launches(f"{tag}, f32, {len(ev)} steps", got,
                        window_launches("cista-eiflow", 6, len(ev)))
        for key in total:
            total[key] += got[key]
        cpu = Reconstructor(c, device="cpu").step_window(ev, return_all=True)
        err = max(float(np.abs(a - b).max()) for a, b in zip(gpu, cpu))
        print(f"  {tag}: f32 cuda vs cpu plain: max abs err {err:.3e} (tol 1e-3); "
              f"max |flow| {float(np.abs(gpu[1]).max()):.2f}")
        if err > 1e-3 or not np.isfinite(gpu[0]).all():
            failures.append(f"{tag}: cuda differs from the plain path by {err}")

    # device voxelization against the numpy golden
    from cista_flow_torch.events import event_preprocess, events_to_voxel_grid
    from cista_flow_torch.ops import voxel as dvox
    for n in (15000, 500000):
        ev = data["events"][:n]
        if len(ev) < n:
            raise AssertionError(f"the gate data holds {len(ev)} events, fewer than {n}")
        cap = (n + 65535) // 65536 * 65536
        buf = np.zeros((cap, 4))
        buf[:n] = ev
        t, x, y, p = (torch.from_numpy(buf[:, i]).cuda() for i in range(4))
        x, y, p = x.long(), y.long(), p.long()
        valid = torch.arange(cap, device="cuda") < n

        def device_voxels():
            return dvox.event_preprocess(dvox.events_to_voxel_grid(t, x, y, p, 5, H, W, valid),
                                         filter_hot_pixel=True)
        raw = dvox.events_to_voxel_grid(t, x, y, p, 5, H, W, valid).cpu().numpy()
        got = device_voxels().cpu().numpy()
        h0 = time.perf_counter()
        ref_raw = events_to_voxel_grid(ev, 5, W, H)
        ref = event_preprocess(ref_raw.copy(), filter_hot_pixel=True)
        host_ms = 1e3 * (time.perf_counter() - h0)
        # the golden adds each cell's c contributions one by one in f32: it
        # is off the exact sum by up to (c - 1) * 2^-24 * sum|v| (recursive
        # summation's bound); the device sums in f64 and rounds once
        u = 2.0 ** -24
        mag = events_to_voxel_grid(np.concatenate([ev[:, :3], np.ones((n, 1))], 1), 5, W, H)
        c = 2 * np.bincount((ev[:, 1] + ev[:, 2] * W).astype(np.int64), minlength=H * W)
        bound = c.reshape(H, W) * u * mag + 2 * u * np.abs(ref_raw) + 1e-30
        raw_ratio = float((np.abs(raw - ref_raw) / bound).max())
        rel = float((np.abs(raw - ref_raw) / np.maximum(np.abs(ref_raw), 1.0)).max())
        norm_ref = event_preprocess(raw.copy(), filter_hot_pixel=True)
        norm = float((np.abs(got - norm_ref) / np.maximum(np.abs(norm_ref), 1.0)).max())
        norm_golden = float((np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max())
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        device_voxels()
        start.record()
        for _ in range(20):
            device_voxels()
        end.record()
        torch.cuda.synchronize()
        print(f"  ops/voxel.py at {n} events (buffer {cap}): raw grid against the golden "
              f"{raw_ratio:.3f} of the golden's own summation bound (tol 1; "
              f"|err| / max(1, |golden|) {rel:.3e}); normalised against the golden's "
              f"normalisation of the device grid {norm:.3e} (tol 1e-6; against the golden "
              f"{norm_golden:.3e}); device {start.elapsed_time(end) / 20:.4f} ms per window "
              f"(CUDA events, 20 calls) against the host golden's {host_ms:.2f} ms")
        if raw_ratio > 1.0 or norm > 1e-6:
            failures.append(f"ops/voxel.py at {n} events: {raw_ratio:.3f} of the bound, "
                            f"normalised {norm:.3e}")
    if failures:
        raise AssertionError("serving CLIs: " + "; ".join(failures))
    return total


def idnet_path(torch, repo: Path, counters: dict) -> dict:
    """Phase 7: cista-idnet at (1, 2) and (1, 5), stepped over the window
    with the predicted next-step flow chained; the checks of phase 4."""
    print(f"cista-idnet path: Reconstructor.step_window, {H}x{W}, {STEPS} steps")
    total = {k: 0 for k in counters}
    for iters, depth, path in IDNET_POINTS:
        got = serving_point(torch, repo, counters, "cista-idnet", iters, depth, path,
                            window_launches("cista-idnet", iters, STEPS))
        for key in total:
            total[key] += got[key]
    return total


def long_chunks(torch, repo: Path, counters: dict) -> dict:
    """Phase 8: one 160-step chunk of seeded voxels as one window at batch
    1, in bf16 and in f32, at every served point: bf16 above 30 dB PSNR
    against f32 at every step (the JAX package's rule), launches counted."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.runner import Reconstructor

    points = ([("cista-eiflow", *p) for p in POINTS] + [("cista-eraft", *p) for p in ERAFT_POINTS]
              + [("cista-idnet", *IDNET_POINTS[0])])
    ev = voxels(5, CHUNK)
    print(f"{CHUNK}-step chunks: bf16 against f32, batch 1, {H}x{W}")
    total = {k: 0 for k in counters}
    for mode, iters, depth, path in points:
        outs = {}
        for dtype in ("float32", "bfloat16"):
            rec = Reconstructor(Config(image_dim=(H, W), model_mode=mode, depth=depth,
                                       flow_iters=iters, dtype=dtype,
                                       path_to_test_model=str(repo / path)), device="cuda")
            (out, flows), got = counted(counters, lambda: rec.step_window(ev, return_all=True))
            tag = f"{mode} ({iters},{depth}) {dtype} {CHUNK}-step window"
            expect_launches(tag, got, window_launches(mode, iters, CHUNK))
            check_outputs(out, flows, CHUNK)
            outs[dtype] = out
            for key in total:
                total[key] += got[key]
            del rec
        psnr = psnr_per_step(outs["float32"], outs["bfloat16"])
        worst = int(np.argmin(psnr))
        marks = [t for t in (1, 16, 40, 80, CHUNK) if t <= CHUNK]
        print(f"  {mode} ({iters},{depth}) bf16 vs f32 over {CHUNK} steps: min "
              f"{psnr[worst]:.2f} dB at step {worst + 1}; at steps "
              + ", ".join(f"{t}: {psnr[t - 1]:.1f}" for t in marks))
        if psnr[worst] <= PSNR_MIN:
            raise AssertionError(f"{mode} ({iters},{depth}): bf16 drift over {CHUNK} steps, "
                                 f"PSNR {psnr[worst]:.2f} <= {PSNR_MIN}")
    return total


TRAIN_VIDEOS, TRAIN_FRAMES = 4, 11   # four 10-step sequences: one batch of 4
TRAIN_T, TRAIN_BATCH = 10, 4
TRAIN_POINT = (6, 5, "gate/flagship_sim40_f16.npz")


def train_launches(loss_mode: str, iters: int, t_len: int, mode: str = "cista-eiflow") -> dict:
    """Kernel launches of one train step of ``t_len`` steps; the backward
    launches none (each kernel's gradient is autograd of its plain version).
    Per step, in every mode: one ISTA call; K2 for the two warps, the loss's
    validity mask, the consistency term's warp of the previous frame (loss
    'rec', from step 2) and one photometric warp per flow prediction (loss
    'flow' or 'both'; ``iters`` of them). cista-eiflow: K1 per GRU
    iteration, fnet's norms (one call over the frame pair) and enet's, K5
    for the three encoders' square convs and the upsamp conv. cista-eraft,
    stepwise: K1 per GRU iteration, fnet's norms over both voxels, K5 for
    fnet's and cnet's square convs and the upsamp conv. cista-idnet: K5 for
    the LiteEncoder's three 64->64 convs per deblur iteration and the
    upsamp conv. cista-lstc and cista-gtflow: the upsamp conv."""
    k2 = sum(3 + (loss_mode == "rec" and s >= 2) + (iters if loss_mode != "rec" else 0)
             for s in range(t_len))
    per_step = {"cista-eiflow": {"K1": iters, "K4": 2 * NORMS, "K5": 3 * SQUARE_CONVS + 1},
                "cista-eraft": {"K1": iters, "K4": NORMS, "K5": 2 * SQUARE_CONVS + 1},
                "cista-idnet": {"K5": IDNET_SQUARE_CONVS * iters + 1}}.get(mode, {"K5": 1})
    return {"K2": k2, "K3": t_len, **{k: n * t_len for k, n in per_step.items()}}


def train_batch(torch, repo: Path, t_len: int, batch: int, device,
                mode: str = "cista-eiflow") -> dict:
    """The first ``batch`` sequences of ``t_len`` steps of the simulated
    training set (written on first use), as f32 tensors on ``device``, with
    what ``mode`` trains on (cista-eraft: the previous voxel)."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.data.sim import write_train_dataset
    from cista_flow_torch.data.train_loader import StackedSequenceLoader, TrainSequenceDataset

    data = repo / "build" / "train_data"
    index = data / "train_e2v_estflow.txt"
    if not index.exists():
        write_train_dataset(str(data), TRAIN_VIDEOS, TRAIN_FRAMES, H, W, seed=0)
    cfg = Config(image_dim=(H, W), path_to_train_data=str(data), len_sequence=t_len,
                 model_mode=mode)
    loader = StackedSequenceLoader(TrainSequenceDataset(str(index), cfg), batch, t_len,
                                   shuffle=False, num_workers=0)
    return {k: torch.from_numpy(v).to(device, torch.float32) for k, v in next(iter(loader)).items()}


def leaf_report(name, got: dict, ref: dict, tol: float, flow_trains: bool,
                mode: str = "cista-eiflow", exact: dict | None = None) -> None:
    """Every gradient leaf of ``got`` against ``ref`` at ``tol`` of the
    leaf's largest magnitude, with two kinds of exception, each held to a
    relative L2 error instead and printed: the tied ISTA block, whose
    softshrink has a kink at +-lambda (lambda ~1e-3; an element whose
    pre-activation lies within rounding of it takes the other branch on the
    other device), at ``tol``; and where the flow net trains, its three
    encoders at 1e-2: they read inputs that are constant over most of the
    frame (the zero first reconstruction; event voxels, zero on most
    pixels), whose normalisations make their weight gradients sums that
    cancel (see tests/test_torch_train_step.py; cista-eraft has fnet and
    cnet). A bias that feeds a normalisation (true gradient 0) is held to
    1e-5 of the step's largest gradient. IDNet's and the GT-flow modes'
    leaves have no norms and take neither exception but the ISTA block's.
    ``exact`` (phase 11): an f64 evaluation of the same gradients; a leaf
    beyond its limit then passes where ``got`` is no farther from it than
    twice ``ref``'s distance by relative L2 (``ref`` itself may be the
    farther one), and is printed."""
    import re
    pre_norm = re.compile(r"event_flownet\.(fnet|enet|cnet)\.(conv1|layer\d\.\d\."
                          r"(conv1|conv2|downsample\.0))\.bias")
    encoders = ("event_flownet.cnet.", "event_flownet.fnet.", "event_flownet.enet.")
    top = max(float(r.abs().max()) for r in ref.values())
    rows, bad = [], []
    for k, r in ref.items():
        g = got[k]
        normed = mode in ("cista-eiflow", "cista-eraft")
        if normed and pre_norm.match(k):
            if float(g.abs().max()) > 1e-5 * top:
                bad.append(k)
            continue
        scale = float(r.abs().max())
        if scale == 0.0:
            if float(g.abs().max()) != 0.0:
                bad.append(k)
            continue
        ratio = float((g - r).abs().max()) / scale
        l2 = float((g - r).norm() / r.norm())
        if ".lista_blocks." in k:
            limit, err = tol, l2
        elif normed and flow_trains and k.startswith(encoders):
            limit, err = 1e-2, l2
        else:
            limit, err = tol, ratio
        rows.append((err / limit, k, ratio, l2))
        if err > limit and exact is not None:
            x = exact[k]
            d_got, d_ref = (float((t.double() - x).norm() / x.norm()) for t in (g, r))
            print(f"    {k}: beyond its limit; against f64 {d_got:.3e} (the reference "
                  f"{d_ref:.3e})")
            if d_got <= 2 * d_ref:
                continue
        if err > limit:
            bad.append(k)
    rows.sort(reverse=True)
    print(f"  {name}: {len(ref)} gradient leaves; the five nearest their limit "
          "(max error / leaf max, relative L2):")
    for frac, k, ratio, l2 in rows[:5]:
        print(f"    {frac:6.3f} of the limit  {ratio:.3e}  {l2:.3e}  {k}")
    if bad:
        raise AssertionError(f"{name}: gradient leaves out of tolerance: {bad[:8]}")


def card_against_cpu(torch, repo: Path, counters: dict) -> dict:
    """One f32 train step on the card against the same step on the CPU (the
    plain versions), phase 2 and phase 3's flow half, ft1 weights, T = 2,
    batch 1: the loss to 1e-5 relative, every gradient leaf to 1e-3 of its
    largest magnitude, and wherever the CPU has a nonzero gradient the
    card has one (a kernel cut out of the graph leaves zeros)."""
    from cista_flow_torch import weights
    from cista_flow_torch.config import Config
    from cista_flow_torch.models import composite
    from cista_flow_torch.parallel import train_step as TS

    total = {k: 0 for k in counters}
    cfg = Config(model_mode="cista-eiflow", image_dim=(H, W), depth=1, flow_iters=1)
    sd = weights.load_state_dict(str(repo / "gate/flagship_ft1_f16.npz"))
    seq = train_batch(torch, repo, 2, 1, "cpu")
    for fix, mode, tag in (("flow", "rec", "phase 2, rec trains"),
                           ("rec", "both", "phase 3 flow half, flow trains")):
        grads, losses = {}, {}
        for dev in ("cpu", "cuda"):
            model = composite.init(cfg, device="cpu")
            model.load_reference_state(sd)
            model.to(dev)
            opt = TS.make_optimizer(model, 1e-4)
            step = TS.make_train_step(cfg, opt, mode, fix, False)
            batch = {k: v.to(dev) for k, v in seq.items()}
            if dev == "cuda":
                loss, got = counted(counters, lambda: step(model, batch))
                expect_launches(f"{tag}, f32 T=2 step", got, train_launches(mode, 1, 2))
                for key in total:
                    total[key] += got[key]
            else:
                loss = step(model, batch)
            losses[dev] = float(loss)
            grads[dev] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                          if p.grad is not None}
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        print(f"  {tag}: loss card {losses['cuda']:.7f}, cpu {losses['cpu']:.7f}, relative "
              f"difference {rel:.3e} (tol 1e-5)")
        if rel > 1e-5:
            raise AssertionError(f"{tag}: loss differs by {rel}")
        if sorted(grads["cuda"]) != sorted(grads["cpu"]):
            raise AssertionError(f"{tag}: the card's gradient leaves are not the CPU's")
        cut = [k for k, g in grads["cpu"].items()
               if float(g.abs().max()) > 0 and float(grads["cuda"][k].abs().max()) == 0]
        zero = [k for k, g in grads["cpu"].items() if float(g.abs().max()) == 0]
        print(f"    {len(grads['cpu'])} trained leaves; zero on the card where the CPU's is "
              f"not: {len(cut)}; zero on both: {len(zero)} {zero[:6]}")
        if cut:
            raise AssertionError(f"{tag}: no gradient on the card for {cut[:8]}")
        leaf_report(tag, grads["cuda"], grads["cpu"], 1e-3, fix == "rec")
    return total


def kernels_after_optimizer_step(torch) -> None:
    """K5, K3 and K1 on weights a foreach Adam updates in place, after a
    real ``optimizer.step()``: each wrapper's packed copy of the weight was
    made (and cached) before the step and must be remade after it. bf16
    activations on bf16 weights (K3, K5: the packed tensor-core tile) and
    f32 convc1 weights (K1: its packed f32 weight)."""
    from cista_flow_torch.device import cudnn_fp32
    from cista_flow_torch.ops import cuda_conv, cuda_corr, cuda_ista2
    from cista_flow_torch.ops.corr import build_corr_pyramid

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    def rand(*shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device=dev)).to(dtype)

    c = 64
    conv = [torch.nn.Parameter(rand(c, c, 3, 3, scale=0.05)), torch.nn.Parameter(rand(c))]
    ista = [torch.nn.Parameter(t) for t in (
        rand(c, 2 * c, 3, 3, scale=0.03), rand(c, scale=0.1), rand(2 * c, c, 3, 3, scale=0.03),
        rand(2 * c, scale=0.1), rand(2 * c, scale=0.01).abs(), rand(c, 2 * c, 3, 3, scale=0.03),
        rand(c, scale=0.1))]
    proj = [torch.nn.Parameter(rand(256, 324, 1, 1, scale=0.05, dtype=torch.float32)),
            torch.nn.Parameter(rand(256, scale=0.1, dtype=torch.float32))]
    x = rand(2, c, 48, 64)
    x1, z = rand(2, c, 48, 64), rand(2, 2 * c, 48, 64, scale=0.1)
    fm = rand(2, 256, 8, 12, dtype=torch.float32)
    pyr = build_corr_pyramid(fm, fm.roll(1, dims=3), 4)
    coords = (torch.rand(2, 2, 8, 12, generator=g, device=dev) * 10.0).contiguous()

    def run():
        with torch.no_grad():
            return (cuda_conv.conv3x3(x, *conv, "reflect", True),
                    cuda_ista2.fused_ista_dg(tuple(ista[:5]), ista[5], ista[6], x1, z, 2),
                    cuda_corr.lookup(pyr, coords, *proj))
    before = run()                                     # fills the weight caches
    opt = torch.optim.Adam(conv + ista + proj, lr=1e-2, foreach=True)
    for p in conv + ista + proj:
        p.grad = torch.ones_like(p)
    opt.step()
    k5, k3, k1 = run()
    with torch.no_grad(), cudnn_fp32():          # the plain versions in f32
        f32 = [p.float() for p in ista]
        r5 = cuda_conv.conv3x3_plain(x.float(), *(p.float() for p in conv), "reflect", True)
        r3 = cuda_ista2.fused_ista_dg_plain(tuple(f32[:5]), f32[5], f32[6], x1.float(),
                                            z.float(), 2)
        r1 = cuda_corr.lookup_plain(pyr, coords, *proj)
    for name, dtype, out, ref, old, tol in (
            ("K5", "bfloat16", k5, r5, before[0], bf16_tol(r5, 2)),
            ("K3", "bfloat16", k3, r3, before[1], bf16_tol(r3, 8)),
            ("K1", "float32", k1, r1, before[2], f32_tol(r1))):
        compare(torch, f"{name} after optimizer.step()", dtype, out, ref, tol)
        outs, olds = (out, old) if isinstance(out, tuple) else ((out,), (old,))
        moved = max(float((a.float() - b.float()).abs().max()) for a, b in zip(outs, olds))
        print(f"    (the step moved its output by {moved:.3e}: a stale pack would be off by that)")
        if moved <= 2 * tol:
            raise AssertionError(f"{name}: the optimizer step moved the output by only {moved}")


class StepWatch:
    """Wraps each step function a ``Trainer`` makes: every launch counter
    set to 0 just before a step and read just after, held against
    ``train_launches``; the frozen subnet's parameters, BN statistics and
    Adam state compared bit for bit over the step; device ms per step from
    CUDA events around a synchronised step."""

    def __init__(self, torch, trainer, counters, tag):
        self.torch, self.trainer, self.counters, self.tag = torch, trainer, counters, tag
        self.total = {k: 0 for k in counters}
        self.ms, self.losses = [], []
        make = trainer.step_fn

        def step_fn(fix, mode, gt):
            return self.watch(make(fix, mode, gt), fix, mode)
        trainer.step_fn = step_fn

    def frozen_state(self, fix):
        model, opt = self.trainer.model, self.trainer.optimizer
        sub = getattr(model, {"rec": "cista_net", "flow": "event_flownet"}[fix])
        state = [t.detach().clone() for t in list(sub.parameters()) + list(sub.buffers())]
        adam = [{k: v.clone() for k, v in opt.state[p].items()} if p in opt.state else None
                for p in sub.parameters()]
        return state, adam

    def watch(self, step, fix, mode):
        torch = self.torch

        def watched(model, seq):
            before = self.frozen_state(fix)
            for k in self.counters.values():
                k.launches = 0
            torch.cuda.synchronize()
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(model, seq)
            stop.record()
            torch.cuda.synchronize()
            got = {key: k.launches for key, k in self.counters.items()}
            self.ms.append(start.elapsed_time(stop))
            self.losses.append(float(loss))
            iters = self.trainer.cfgs.default_flow_iters()
            expect_launches(f"{self.tag} step {len(self.ms)} (fix {fix}, loss {mode})", got,
                            train_launches(mode, iters, seq["event_voxel"].shape[0]))
            for key in self.total:
                self.total[key] += got[key]
            after = self.frozen_state(fix)
            same = all(torch.equal(a, b) for a, b in zip(before[0], after[0])) and all(
                (a is None and b is None) or (a is not None and b is not None and all(
                    torch.equal(a[k], b[k]) for k in a)) for a, b in zip(before[1], after[1]))
            if not same:
                raise AssertionError(f"{self.tag}: the frozen subnet ({fix}) changed")
            if not np.isfinite(self.losses[-1]):
                raise AssertionError(f"{self.tag}: loss {self.losses[-1]}")
            return loss
        return watched


def train_step_split(torch, model, cfg, seq, fix, mode, use_gt_flow=False, remat=False):
    """Device ms of one train step's forward (the unroll and its losses),
    backward and optimizer step, from CUDA events, on ``model`` with a fresh
    optimizer."""
    from cista_flow_torch.device import DTYPES
    from cista_flow_torch.parallel import train_step as TS

    opt = TS.make_optimizer(model, 1e-4)
    dtype = DTYPES[cfg.dtype]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    model.train()
    TS.freeze(model, fix)
    torch.cuda.synchronize()
    with cudnn_fp32_scope(torch, cfg.dtype):
        ev[0].record()
        with TS.parameters_as(model, dtype):
            loss = TS.unroll_loss(model, seq, cfg, mode, fix, use_gt_flow, dtype, remat=remat)
            ev[1].record()
            loss.backward()
        ev[2].record()
    TS.optimizer_step(model, opt)
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def training_path(torch, repo: Path, counters: dict) -> dict:
    """Phase 9: training. See the module's docstring."""
    import os
    import shutil

    from cista_flow_torch import train
    from cista_flow_torch.config import Config
    from cista_flow_torch.parallel import train_step as TS
    from cista_flow_torch.runner import Reconstructor

    total = {k: 0 for k in counters}
    t0 = time.perf_counter()
    train_batch(torch, repo, TRAIN_T, TRAIN_BATCH, "cpu")    # writes the set
    print(f"training: the simulated set ({TRAIN_VIDEOS} videos x {TRAIN_FRAMES} frames, "
          f"{H}x{W}) in {time.perf_counter() - t0:.1f} s")
    for key, n in card_against_cpu(torch, repo, counters).items():
        total[key] += n
    kernels_after_optimizer_step(torch)

    iters, depth, anchor = TRAIN_POINT
    runs, grads = {}, {}
    for dtype in ("float32", "bfloat16"):
        out = repo / "build" / "train_models" / dtype
        shutil.rmtree(out, ignore_errors=True)
        cfg = Config(image_dim=(H, W), model_mode="cista-eiflow", depth=depth, flow_iters=iters,
                     dtype=dtype, path_to_train_data=str(repo / "build" / "train_data"),
                     path_to_model=str(out), path_to_e2vflow=str(repo / anchor),
                     len_sequence=TRAIN_T, batch_size=TRAIN_BATCH, flow_epoch=1, rec_epoch=1,
                     epochs=5)
        t1 = time.perf_counter()
        trainer = train.Trainer(cfg, device="cuda")
        watch = StepWatch(torch, trainer, counters, f"Trainer {dtype}")
        torch.cuda.reset_peak_memory_stats()
        trainer.run()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for key in total:
            total[key] += watch.total[key]
        if len(watch.ms) != cfg.epochs:
            raise AssertionError(f"Trainer {dtype}: {len(watch.ms)} steps, expected {cfg.epochs}")
        if any(p.dtype != torch.float32 for p in trainer.model.parameters()):
            raise AssertionError(f"Trainer {dtype}: master parameters left f32")
        print(f"  Trainer {dtype}, (6,5), T={TRAIN_T}, batch {TRAIN_BATCH}: losses "
              + ", ".join(f"{x:.4f}" for x in watch.losses) + "; device ms per step "
              + ", ".join(f"{x:.1f}" for x in watch.ms) + f"; peak memory {peak:.2f} GiB; "
              f"{time.perf_counter() - t1:.1f} s")
        runs[dtype] = (trainer, cfg, watch)

    # the forward/backward split, and the first step's gradients in both
    # dtypes from the same weights and batch (phase 3's flow half)
    from cista_flow_torch.models import composite
    from cista_flow_torch import weights
    seq = train_batch(torch, repo, TRAIN_T, TRAIN_BATCH, "cuda")
    for dtype, (trainer, cfg, _) in runs.items():
        train_step_split(torch, trainer.model, cfg, seq, "rec", "both")   # warm-up
        split = train_step_split(torch, trainer.model, cfg, seq, "rec", "both")
        print(f"  {dtype} step split, device ms: forward {split[0]:.1f}, backward "
              f"{split[1]:.1f}, optimizer {split[2]:.1f} (phase 3 flow half)")
        model = composite.init(cfg, device="cpu")
        model.load_reference_state(weights.load_state_dict(str(repo / anchor)))
        model.to("cuda").train()
        TS.freeze(model, "rec")
        with cudnn_fp32_scope(torch, dtype):
            with TS.parameters_as(model, TS.DTYPES[dtype]):
                loss = TS.unroll_loss(model, seq, cfg, "both", "rec", False, TS.DTYPES[dtype])
            loss.backward()
        grads[dtype] = {n: p.grad.float() for n, p in model.named_parameters()
                        if p.grad is not None}
    a = torch.cat([g.flatten() for g in grads["float32"].values()])
    b = torch.cat([grads["bfloat16"][k].flatten() for k in grads["float32"]])
    cos = float(torch.nn.functional.cosine_similarity(a, b, dim=0))
    by_sub = {}
    for sub in ("event_flownet.fnet", "event_flownet.enet", "event_flownet.cnet",
                "event_flownet.fusion", "event_flownet.update_block"):
        ks = [k for k in grads["float32"] if k.startswith(sub)]
        if ks:
            by_sub[sub.split(".")[-1]] = float(torch.nn.functional.cosine_similarity(
                torch.cat([grads["float32"][k].flatten() for k in ks]),
                torch.cat([grads["bfloat16"][k].flatten() for k in ks]), dim=0))
    print(f"  bf16 against f32 first-step gradients (flow net trains): cosine {cos:.5f}; "
          + ", ".join(f"{k} {v:.5f}" for k, v in by_sub.items()))

    # bf16 convergence on one repeated batch, as the JAX package's own check
    # (tests/test_train_step.py:156-177): random weights, both subnets
    # training, loss 'rec', lr 1e-3, T = 2
    cfg = runs["bfloat16"][1]
    model = composite.init(cfg, device="cuda")
    step = TS.make_train_step(cfg, TS.make_optimizer(model, 1e-3), "rec", None, False)
    short = {k: v[:2].contiguous() for k, v in seq.items()}
    losses = [float(step(model, short)) for _ in range(3)]
    print(f"  bf16, random weights, one repeated batch (T=2, batch {TRAIN_BATCH}): losses "
          + ", ".join(f"{x:.5f}" for x in losses))
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"bf16 training does not converge on one batch: {losses}")

    # the last checkpoint serves
    trainer, cfg, _ = runs["float32"]
    saved = sorted(os.listdir(trainer.path_to_model))
    if saved != [f"{trainer.model_name}_{e}.pth.tar" for e in (1, 2, 4)]:
        raise AssertionError(f"checkpoints {saved}")
    path = os.path.join(trainer.path_to_model, saved[-1])
    rec = Reconstructor(Config(model_mode="cista-eiflow",
                               image_dim=(H, W), depth=depth, flow_iters=iters,
                               path_to_test_model=path), device="cuda")
    (out, flows), got = counted(counters, lambda: rec.step_window(voxels(6, STEPS),
                                                                  return_all=True))
    expect_launches(f"checkpoint {saved[-1]} served, {STEPS} steps", got,
                    window_launches("cista-eiflow", iters, STEPS))
    check_outputs(out, flows, STEPS)
    for key in total:
        total[key] += got[key]
    return total


# phase 10: (mode, iters, depth, anchor, [(fix, loss_mode, use_gt_flow, tag)])
MODE_STEPS = (
    ("cista-eraft", 1, 1, "gate/eraft_ft1_f16.npz",
     (("rec", "flow", True, "phase 1"), ("rec", "both", False, "phase 3 flow half"))),
    ("cista-idnet", 1, 2, "gate/idnet_ft2_f16.npz", (("rec", "both", False, "phase 3 flow half"),)),
    ("cista-gtflow", 1, 5, "gate/flagship_sim40_f16.npz", ((None, "rec", True, "GT flow"),)),
)
# each mode's reference default, bf16, in the phase that trains the most
MODE_BF16 = (("cista-eraft", 12, 5, "gate/eraft_sim40_f16.npz", "rec", "both", False),
             ("cista-idnet", 1, 5, "gate/idnet_sim40_f16.npz", "rec", "both", False),
             ("cista-gtflow", 1, 5, "gate/flagship_sim40_f16.npz", None, "rec", True))
SIM_SMOKE = ["--n_videos", "6", "--n_frames", "21", "--eval_frames", "12", "--epochs", "6",
             "--batch_size", "4", "--len_sequence", "10"]


def mode_model(torch, cfg, repo: Path, anchor: str, device):
    from cista_flow_torch import weights
    from cista_flow_torch.models import composite
    model = composite.init(cfg, device="cpu")
    model.load_reference_state(weights.load_state_dict(str(repo / anchor)))
    return model.to(device)


def modes_against_cpu(torch, repo: Path, counters: dict) -> dict:
    """One f32 train step per mode and phase on the card against the same
    step on the CPU (plain versions), T = 2, batch 1 (``MODE_STEPS``): the
    loss to 1e-5 relative, every gradient leaf by ``leaf_report`` at 1e-3,
    a gradient on the card wherever the CPU has one, and the launches of
    the card's step."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.parallel import train_step as TS

    total = {k: 0 for k in counters}
    for mode, iters, depth, anchor, phases in MODE_STEPS:
        cfg = Config(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters)
        seq = train_batch(torch, repo, 2, 1, "cpu", mode)
        for fix, loss_mode, gt, phase in phases:
            tag = f"{mode} ({iters},{depth}) {phase}"
            grads, losses = {}, {}
            for dev in ("cpu", "cuda"):
                model = mode_model(torch, cfg, repo, anchor, dev)
                step = TS.make_train_step(cfg, TS.make_optimizer(model, 1e-4), loss_mode, fix, gt)
                batch = {k: v.to(dev) for k, v in seq.items()}
                if dev == "cuda":
                    loss, got = counted(counters, lambda: step(model, batch))
                    expect_launches(f"{tag}, f32 T=2 step", got,
                                    train_launches(loss_mode, iters, 2, mode))
                    for key in total:
                        total[key] += got[key]
                else:
                    loss = step(model, batch)
                losses[dev] = float(loss)
                grads[dev] = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                              if p.grad is not None}
            rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
            print(f"  {tag}: loss card {losses['cuda']:.7f}, cpu {losses['cpu']:.7f}, "
                  f"relative difference {rel:.3e} (tol 1e-5)")
            if rel > 1e-5:
                raise AssertionError(f"{tag}: loss differs by {rel}")
            if sorted(grads["cuda"]) != sorted(grads["cpu"]):
                raise AssertionError(f"{tag}: the card's gradient leaves are not the CPU's")
            cut = [k for k, g in grads["cpu"].items()
                   if float(g.abs().max()) > 0 and float(grads["cuda"][k].abs().max()) == 0]
            if cut:
                raise AssertionError(f"{tag}: no gradient on the card for {cut[:8]}")
            leaf_report(tag, grads["cuda"], grads["cpu"], 1e-3, fix == "rec", mode)
    return total


def busy_share(torch, step, model, seq, ms: float) -> float:
    """The kernel time of a profiler trace of one step (the card's activity
    alone) over ``ms``, the device time of the same step untraced."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(model, seq)
        torch.cuda.synchronize()
    kernels = sum(e.device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return kernels / ms


REMAT_T = 5              # the remat pair's unroll: TRAIN_T until phase 16 needed the time


def modes_bf16(torch, repo: Path, counters: dict) -> dict:
    """bf16 training at full width at each mode's reference default
    (``MODE_BF16``), T = 10, batch 4, from the anchors: one warm-up step,
    then a counted step (launches against ``train_launches``) timed by
    CUDA events with the peak memory, the forward/backward/optimizer split,
    and the device-busy share of a traced step. Then remat on and off at
    cista-eraft (12,5): loss and gradients against the run without remat
    and against a second run without it (run-to-run), and both peaks, at
    T = ``REMAT_T``."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.parallel import train_step as TS

    total = {k: 0 for k in counters}
    for mode, iters, depth, anchor, fix, loss_mode, gt in MODE_BF16:
        cfg = Config(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters,
                     dtype="bfloat16")
        seq = train_batch(torch, repo, TRAIN_T, TRAIN_BATCH, "cuda", mode)
        model = mode_model(torch, cfg, repo, anchor, "cuda")
        step = TS.make_train_step(cfg, TS.make_optimizer(model, 1e-4), loss_mode, fix, gt)
        t0 = time.perf_counter()
        step(model, seq)                                        # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, got = counted(counters, lambda: step(model, seq))
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tag = f"{mode} ({iters},{depth}) bf16, T={TRAIN_T}, batch {TRAIN_BATCH}"
        expect_launches(f"{tag} step", got, train_launches(loss_mode, iters, TRAIN_T, mode))
        for key in total:
            total[key] += got[key]
        t2 = time.perf_counter()
        split = train_step_split(torch, model, cfg, seq, fix, loss_mode, gt)
        t3 = time.perf_counter()
        busy = busy_share(torch, step, model, seq, ms)
        if not np.isfinite(float(loss)):
            raise AssertionError(f"{tag}: loss {float(loss)}")
        print(f"  {tag}: loss {float(loss):.4f}; device ms per step {ms:.1f} (forward "
              f"{split[0]:.1f}, backward {split[1]:.1f}, optimizer {split[2]:.1f}); device "
              f"busy {100 * busy:.1f}%; peak memory {peak:.2f} GiB (host s: warm-up "
              f"{t1 - t0:.1f}, step {t2 - t1:.1f}, split {t3 - t2:.1f}, traced step "
              f"{time.perf_counter() - t3:.1f})")

    # remat on and off at cista-eraft (12,5), bf16, the flow net training
    mode, iters, depth, anchor, fix, loss_mode, gt = MODE_BF16[0]
    cfg = Config(image_dim=(H, W), model_mode=mode, depth=depth, flow_iters=iters,
                 dtype="bfloat16")
    seq = train_batch(torch, repo, REMAT_T, TRAIN_BATCH, "cuda", mode)
    model = mode_model(torch, cfg, repo, anchor, "cuda").train()
    TS.freeze(model, fix)
    runs = {}
    for tag, remat in (("off", False), ("off again", False), ("on", True)):
        for p in model.parameters():
            p.grad = None
        tracked = [int(b) for n, b in model.named_buffers() if n.endswith("num_batches_tracked")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with TS.parameters_as(model, torch.bfloat16):
            loss = TS.unroll_loss(model, seq, cfg, loss_mode, fix, gt, torch.bfloat16,
                                  remat=remat)
            loss.backward()
        torch.cuda.synchronize()
        moved = {int(b) - t for (n, b), t in zip(
            ((n, b) for n, b in model.named_buffers() if n.endswith("num_batches_tracked")),
            tracked)}
        if moved != {REMAT_T}:
            raise AssertionError(f"remat {tag}: BN counts moved by {moved}, not {REMAT_T}")
        runs[tag] = (float(loss), {n: p.grad.detach().float().clone()
                                   for n, p in model.named_parameters() if p.grad is not None},
                     torch.cuda.max_memory_allocated() / 2 ** 30)

    pre_norm = re.compile(r"event_flownet\.(fnet|cnet)\.(conv1|layer\d\.\d\."
                          r"(conv1|conv2|downsample\.0))\.bias")

    def diff(a, b):
        """(bit for bit, the loss's relative difference, the gradients'
        relative L2 difference over every leaf but the pre-norm biases,
        whose true gradient is 0 and whose computed one is rounding)."""
        same = a[0] == b[0] and all(torch.equal(a[1][k], b[1][k]) for k in a[1])
        keys = [k for k in a[1] if not pre_norm.match(k)]
        ga, gb = (torch.cat([g[1][k].flatten() for k in keys]) for g in (a, b))
        return same, abs(a[0] - b[0]) / abs(a[0]), float((ga - gb).norm() / gb.norm())
    for other in ("off again", "on"):
        same, dl, dg = diff(runs["off"], runs[other])
        print(f"  remat: off against {other}: bit for bit {same}; loss {dl:.3e} relative; "
              f"gradients {dg:.3e} relative L2 (pre-norm biases aside)")
    same_rr, dl_rr, dg_rr = diff(runs["off"], runs["off again"])
    same, dl, dg = diff(runs["off"], runs["on"])
    print(f"  remat peak memory: off {runs['off'][2]:.2f} GiB, on {runs['on'][2]:.2f} GiB")
    if not same and (dl > max(4 * dl_rr, 1e-6) or dg > max(4 * dg_rr, 1e-3)):
        raise AssertionError(f"remat moves the step beyond run-to-run: {dl}, {dg} against "
                             f"{dl_rr}, {dg_rr}")
    if runs["on"][2] >= runs["off"][2]:
        raise AssertionError("remat does not lower the peak memory")
    return total


def resume_round_trip(torch, repo: Path, counters: dict) -> dict:
    """The exact resume on the card: ``train.Trainer`` at cista-eraft (1,1),
    f32, T = 5, batch 4, over phases 1 and 2 with ``orbax_ckpt`` (full-state
    saves after epochs 1 and 2); a new trainer with ``load_epoch_for_train
    -1`` holds the saving trainer's parameters, BN buffers and Adam state
    bit for bit; each takes epoch 3 (phase 3's flow half), and so does a
    second resumed trainer. The resumed run must equal the uninterrupted one
    as closely as two resumed runs equal each other (the card's atomics in
    the plain backward, which Adam turns into whole steps on gradients that
    are rounding, make neither bit for bit)."""
    import shutil

    from cista_flow_torch import train
    from cista_flow_torch.config import Config

    out = repo / "build" / "train_models" / "resume"
    shutil.rmtree(out, ignore_errors=True)

    def trainer(epochs, **kw):
        return train.Trainer(Config(
            image_dim=(H, W), model_mode="cista-eraft", depth=1, flow_iters=1,
            path_to_train_data=str(repo / "build" / "train_data"), path_to_model=str(out),
            path_to_e2vflow=str(repo / "gate/eraft_ft1_f16.npz"), len_sequence=5,
            batch_size=TRAIN_BATCH, flow_epoch=1, rec_epoch=1, epochs=epochs, shuffle=False,
            orbax_ckpt=True, **kw), device="cuda")

    pre_norm = re.compile(r"event_flownet\.(fnet|cnet)\.(conv1|layer\d\.\d\."
                          r"(conv1|conv2|downsample\.0))\.bias")

    def state(t):
        opt = t.optimizer.state_dict()["state"]
        return ({k: v.detach().clone() for k, v in t.model.state_dict().items()},
                {i: {k: v.clone() for k, v in st.items()} for i, st in opt.items()})

    def differ(a, b, names):
        """The largest difference of the parameters and buffers; Adam's
        moments' relative L2 difference over every parameter but the
        pre-norm biases (whose gradient is rounding, and Adam's moments of
        it noise); whether the step counts are equal."""
        p = max(float((a[0][k].double() - b[0][k].double()).abs().max()) for k in a[0])
        keep = [i for i in a[1] if not pre_norm.match(names[i])]
        m = max(float((torch.cat([a[1][i][k].flatten() for i in keep])
                       - torch.cat([b[1][i][k].flatten() for i in keep])).norm()
                      / torch.cat([b[1][i][k].flatten() for i in keep]).norm())
                for k in ("exp_avg", "exp_avg_sq"))
        return p, m, all(torch.equal(a[1][i]["step"], b[1][i]["step"]) for i in a[1])

    first = trainer(2)
    first.run()
    saved = state(first)
    names = [n for n, _ in first.model.named_parameters()]     # the optimizer's order
    runs = []
    for _ in range(2):
        resumed = trainer(3, load_epoch_for_train=-1)
        if resumed.resume[1] != 2 or resumed.cfgs.load_epoch_for_train != 2:
            raise AssertionError(f"resume chose {resumed.resume}")
        restored = state(resumed)
        if sorted(restored[1]) != sorted(saved[1]) or differ(restored, saved, names) != (0.0, 0.0, True):
            raise AssertionError(f"resume: the restored state is not the saved one: "
                                 f"{differ(restored, saved, names)}")
        resumed.run()
        runs.append(state(resumed))
    print(f"  resume: from full_state step 2, restored bit for bit (parameters, BN buffers, "
          f"Adam moments and step counts); epoch 3 next")
    first.cfgs.epochs, first.cfgs.load_epoch_for_train = 3, 2
    first.run()                                       # the uninterrupted run
    p_rr, m_rr, _ = differ(runs[0], runs[1], names)
    p, m, steps = differ(runs[0], state(first), names)
    print(f"  resume, one more epoch: against the uninterrupted run parameters and buffers "
          f"within {p:.3e}, Adam moments {m:.3e} relative L2 (pre-norm biases aside), step "
          f"counts equal {steps}; two resumed runs: {p_rr:.3e}, {m_rr:.3e}")
    if not steps or p > max(4 * p_rr, 1e-7) or m > max(4 * m_rr, 1e-6):
        raise AssertionError("resume: the resumed run is not the uninterrupted one")
    return {k: 0 for k in counters}


def sim_quality_smoke(torch, repo: Path, counters: dict) -> dict:
    """A reduced ``python -m cista_flow_torch.sim_quality`` (cista-gtflow,
    180x240, bf16, ``SIM_SMOKE``) into the ignored ``build/sim_quality_smoke``;
    the trained net must beat the untrained one on PSNR."""
    import shutil

    from cista_flow_torch import sim_quality

    work = repo / "build" / "sim_quality_smoke"
    shutil.rmtree(work / "models", ignore_errors=True)
    t0 = time.perf_counter()
    out, got = counted(counters, lambda: sim_quality.run(sim_quality.parse_args(
        ["--workdir", str(work), *SIM_SMOKE])))
    print(f"  sim_quality {' '.join(SIM_SMOKE)}: {json.dumps(out)}; launches {got}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not out["psnr_trained"] > out["psnr_init"]:
        raise AssertionError(f"sim_quality: psnr_trained {out['psnr_trained']} <= "
                             f"psnr_init {out['psnr_init']}")
    return got


def train_modes(torch, repo: Path, counters: dict) -> dict:
    """Phase 10: training in every other mode. See the module's docstring."""
    total = {k: 0 for k in counters}
    train_batch(torch, repo, TRAIN_T, TRAIN_BATCH, "cpu")       # writes the set
    for part in (modes_against_cpu, modes_bf16, resume_round_trip, sim_quality_smoke):
        t0 = time.perf_counter()
        for key, n in part(torch, repo, counters).items():
            total[key] += n
        print(f"  {part.__name__}: {time.perf_counter() - t0:.1f} s")
    return total


# phase 11: flow-net pretraining. (arch, GRU iterations, frame, batch) of the
# bf16 steps at full width: sim_flow_quality's defaults for DCEIFlow and
# E-RAFT (180x240, batch 8); for RAFT the upstream chairs stage's batch 10
# at 384x512, the /32 crop nearest its 368x496, which make_train_step refuses
# (RAFT pads to /8, the sequence loss its targets to /32)
PRETRAIN_BF16 = (("dceiflow", 6, (H, W), 8), ("eraft", 12, (H, W), 8),
                 ("raft", 12, (384, 512), 10))
PRETRAIN_SMALL = (64, 96)        # the card-against-CPU steps: /32 for RAFT's loss
PRETRAIN_LR = 2e-4
# a flow-net bias whose conv feeds a normalisation: its true gradient is 0
FLOW_PRE_NORM = re.compile(r"(fnet|enet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))"
                           r"\.bias")
RAFT_PYRAMID = (10, 48, 64)      # K1: RAFT's 1/8 grid of 384x512 at batch 10
RAFT_NORM_SHAPES = ((20, 64, 192, 256), (20, 96, 96, 128), (20, 128, 48, 64))   # fnet on 2B
RAFT_CONV_SHAPES = ((20, 64, 192, 256), (20, 128, 48, 64))
# K2: the sequence loss's photometric warp of the first frame, at RAFT's
# crop and at DCEIFlow's and E-RAFT's 180x240 padded to 192x256
PRETRAIN_WARP_SHAPES = ((10, 1, 384, 512), (8, 1, 192, 256))
# 24 videos x 4 epochs (120 steps): 8 x 3 left the held-out EPE above the
# untrained net's on the card (3.125 -> 4.203 with torch's default init)
FLOW_SMOKE = ["--n_videos", "24", "--n_frames", "11", "--eval_videos", "2", "--epochs", "4",
              "--opt", "raft"]
FLOWNET_SMOKE = ["--model_mode", "cista-eiflow", "--n_videos", "4", "--n_frames", "11",
                 "--eval_frames", "12", "--epochs", "1", "--batch_size", "4",
                 "--len_sequence", "10"]


def pretrain_launches(arch: str, iters: int, is_bi: bool = False) -> dict:
    """Kernel launches of one pretraining step (forward only: each kernel's
    gradient is autograd of its plain version). DCEIFlow: K1 per GRU
    iteration, K2 for one photometric warp per flow prediction, fnet's norms
    (one call over the frame pair) and enet's, K5 for the three encoders'
    square convs; with ``is_bi`` the backward direction adds the GRU
    iterations, their warps, enet on the reversed voxel and cnet on the
    second frame. E-RAFT and RAFT: K1 and K2 per iteration, fnet's norms
    (one call over both inputs), K5 for fnet's and cnet's square convs."""
    if arch == "dceiflow":
        n = 2 if is_bi else 1
        return {"K1": n * iters, "K2": n * iters, "K4": (1 + n) * NORMS,
                "K5": (1 + 2 * n) * SQUARE_CONVS}
    return {"K1": iters, "K2": iters, "K4": NORMS, "K5": 2 * SQUARE_CONVS}


def pretrain_batch(torch, repo: Path, arch: str, hw, batch: int, device, items=None,
                   bi: bool = False) -> dict:
    """A pretraining batch of NCHW f32 tensors on ``device``. DCEIFlow and
    E-RAFT: ``SimFlowPairs`` of a simulated set at ``hw`` (written once
    into the ignored ``build/pretrain_data``; items 1.. of a video, whose
    previous voxel is not zero), with ``bi`` also the reversed voxel and
    the backward flow; RAFT given ``items`` reads those frames as RGB (a
    scale per channel). RAFT at full width: a seeded RGB-like pair (a
    smooth texture per channel, the second frame the first sampled along a
    seeded smooth flow) and that flow as the target, the chairs stage
    having no data in the repo."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.data import sim
    from cista_flow_torch.ops.warp import sample_pixel_coords

    h, w = hw
    if arch == "raft" and items is None:
        rng = np.random.default_rng(11)
        img0 = np.stack([np.stack([sim.smooth_texture(rng, h, w) for _ in range(3)])
                         for _ in range(batch)]).astype(np.float32)
        flow = np.stack([np.stack([8.0 * (sim.smooth_texture(rng, h, w) - 0.5)
                                   for _ in range(2)]) for _ in range(batch)]).astype(np.float32)
        t0, tf = torch.from_numpy(img0), torch.from_numpy(flow)
        xx = torch.arange(w, dtype=torch.float32)[None, None, :]
        yy = torch.arange(h, dtype=torch.float32)[None, :, None]
        img1 = sample_pixel_coords(t0, xx - tf[:, 0], yy - tf[:, 1], "reflection")
        out = {"gt_img0": t0, "gt_img1": img1, "gt_flow": tf,
               "valid": torch.ones((batch, 1, h, w))}
        return {k: v.to(device) for k, v in out.items()}
    data = repo / "build" / "pretrain_data" / f"{h}x{w}"
    if not (data / "train_e2v_estflow.txt").exists():
        sim.write_train_dataset(str(data), 2, 11, h, w, seed=0, speed_range=(15.0, 110.0),
                                omega_range=(0.05, 0.5))
    cfg = Config(image_dim=(h, w), path_to_train_data=str(data), len_sequence=1,
                 model_mode="cista-eraft" if arch == "eraft" else "cista-eiflow",
                 is_bi=bi, is_reverse_events=bi)
    ds = sim.SimFlowPairs(cfg)
    picked = [ds[i] for i in (items or [i for i in range(1, len(ds)) if i % 10][:batch])]
    out = {k: np.stack([it[k] for it in picked]) for k in picked[0]}
    if arch == "raft":               # the grey frames as RGB, one scale per channel
        for k in ("gt_img0", "gt_img1"):
            out[k] = np.concatenate([out[k], 0.9 * out[k], 0.8 * out[k]], 1)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def pretrain_cfg(arch: str, hw, iters: int, dtype: str = "float32", is_bi: bool = False):
    from cista_flow_torch.config import Config
    return Config(image_dim=tuple(hw), flow_iters=iters, dtype=dtype, is_bi=is_bi,
                  is_reverse_events=is_bi,
                  model_mode="cista-eraft" if arch == "eraft" else "cista-eiflow")


def pretrain_against_cpu(torch, repo: Path, counters: dict) -> dict:
    """(a) One f32 ``make_train_step`` step per arch on the card against the
    same step on the CPU (plain versions), same weights (``flow_net`` from
    seed 0) and batch, at 64x96, batch 2, 2 iterations: DCEIFlow with the
    bidirectional branch, E-RAFT, RAFT (Adam). The loss to 1e-6 relative,
    every gradient leaf by ``leaf_report`` (1e-3; the encoders 1e-2 relative
    L2; beyond that, no farther from an f64 evaluation than twice the CPU),
    a gradient on the card wherever the CPU has one, the launches. Then one
    ``--opt raft`` step of DCEIFlow on both, its clip at half the norm of
    the CPU's gradient above so that it acts: the learning rate the
    schedule's first; the clipped gradients against the CPU's as above, and
    on the card the Adam step's gradients scaled by clip / their norm; the
    parameters after the step AdamW's first step from the clipped gradient
    at that rate (to 2 f32 ulps of the parameter)."""
    import copy

    from cista_flow_torch import pretrain_flow as pf

    total = {k: 0 for k in counters}
    adam = {}
    for arch, bi, opt_name in (("dceiflow", True, "adam"), ("eraft", False, "adam"),
                               ("raft", False, "adam"), ("dceiflow", True, "raft")):
        cfg = pretrain_cfg(arch, PRETRAIN_SMALL, 2, is_bi=bi)
        seq = pretrain_batch(torch, repo, arch, PRETRAIN_SMALL, 2, "cpu", items=[1, 2], bi=bi)
        base = pf.flow_net(arch, cfg, "cpu", seed=0)
        clip = 0.5 * global_norm(torch, adam[arch]["cpu"].values()) if arch in adam else 1.0
        runs = {}
        for dev in ("cpu", "cuda"):
            model = copy.deepcopy(base).to(dev)
            opt = (pf.make_raft_optimizer(model, PRETRAIN_LR, 100, clip=clip)
                   if opt_name == "raft" else pf.make_optimizer(model, PRETRAIN_LR))
            step = pf.make_train_step(cfg, opt, bi, arch)
            batch = {k: v.to(dev) for k, v in seq.items()}
            before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
            if dev == "cuda":
                (loss, epe), got = counted(counters, lambda: step(model, batch))
                expect_launches(f"pretrain {arch}{' bi' if bi else ''} --opt {opt_name}, f32",
                                got, pretrain_launches(arch, 2, bi))
                for key in total:
                    total[key] += got[key]
            else:
                loss, epe = step(model, batch)
            runs[dev] = dict(
                loss=float(loss), epe=float(epe), lr=opt.param_groups[0]["lr"], before=before,
                grads={f"event_flownet.{n}": p.grad.detach().cpu()
                       for n, p in model.named_parameters() if p.grad is not None},
                after={n: p.detach().cpu() for n, p in model.named_parameters()})
        tag = f"pretrain {arch}{' bidirectional' if bi else ''} --opt {opt_name}"
        rel = abs(runs["cuda"]["loss"] - runs["cpu"]["loss"]) / abs(runs["cpu"]["loss"])
        print(f"  {tag}: loss card {runs['cuda']['loss']:.7f}, cpu {runs['cpu']['loss']:.7f}, "
              f"relative difference {rel:.3e} (tol 1e-6); epe {runs['cuda']['epe']:.5f}, "
              f"{runs['cpu']['epe']:.5f}")
        if rel > 1e-6:
            raise AssertionError(f"{tag}: loss differs by {rel}")
        g_cpu, g_card = runs["cpu"]["grads"], runs["cuda"]["grads"]
        mode = "cista-eiflow" if arch == "dceiflow" else "cista-eraft"
        if opt_name == "adam":
            if sorted(g_card) != sorted(g_cpu):
                raise AssertionError(f"{tag}: the card's gradient leaves are not the CPU's")
            cut = [k for k, g in g_cpu.items()
                   if float(g.abs().max()) > 0 and float(g_card[k].abs().max()) == 0]
            if cut:
                raise AssertionError(f"{tag}: no gradient on the card for {cut[:8]}")
            exact = f64_grads(torch, base, cfg, arch, bi, seq)
            print(f"  {tag}: against f64 (relative L2), card / CPU: " + "; ".join(
                f"{n} {a:.2e} / {c:.2e}" for a, c, n in far_from_f64(exact, g_card, g_cpu)[:3]))
            leaf_report(tag, g_card, g_cpu, 1e-3, True, mode, exact=exact)
            adam[arch] = dict(cpu=g_cpu, cuda=g_card, exact=exact)
            continue
        want_lr = pf.onecycle_lr(PRETRAIN_LR, 100)(0)
        if not runs["cuda"]["lr"] == runs["cpu"]["lr"] == want_lr:
            raise AssertionError(f"{tag}: learning rate {runs['cuda']['lr']} on the card, "
                                 f"{runs['cpu']['lr']} on the CPU, not the schedule's {want_lr}")
        norm = global_norm(torch, g_card.values())
        unclipped = adam[arch]["cuda"]
        scale = clip / global_norm(torch, unclipped.values())
        vs_adam = global_norm(torch, (g_card[k] - scale * unclipped[k] for k in g_card)) / clip
        print(f"  {tag}: clip {clip:.4f} (half the CPU's gradient norm); clipped norm on the "
              f"card {norm:.6f}; the card's clipped gradients against its Adam step's x "
              f"{scale:.4f}: {vs_adam:.3e} relative L2 (tol 1e-5)")
        if abs(norm - clip) > 1e-5 * clip or vs_adam > 1e-5:
            raise AssertionError(f"{tag}: the card's clip is not optax's ({norm}, {vs_adam})")
        exact = adam[arch]["exact"]
        exact_scale = clip / global_norm(torch, exact.values())
        leaf_report(f"{tag}, clipped", g_card, g_cpu, 1e-3, True, mode,
                    exact={k: v * exact_scale for k, v in exact.items()})
        for dev, r in runs.items():
            worst = 0.0
            for n, p0 in r["before"].items():
                g = r["grads"][f"event_flownet.{n}"].double()
                want = p0.double() * (1 - want_lr * 1e-4) - want_lr * g / (g.abs() + 1e-8)
                limit = 2 * 2.0 ** -23 * p0.double().abs() + 1e-6 * want_lr
                worst = max(worst, float(((r["after"][n].double() - want).abs() / limit).max()))
            print(f"  {tag}: {dev} parameters after the step against AdamW's first step from "
                  f"the clipped gradients: {worst:.3f} of the limit (2 ulps + 1e-6 lr)")
            if worst > 1.0:
                raise AssertionError(f"{tag}: {dev}: the update is not AdamW's ({worst})")
    return total


def global_norm(torch, grads) -> float:
    """The L2 norm over every tensor of ``grads``, in f64."""
    return float(torch.cat([g.double().flatten() for g in grads]).norm())


def f64_grads(torch, base, cfg, arch, bi, seq) -> dict:
    """The gradients of the same step in f64 on the CPU, keyed
    ``event_flownet.<parameter>``: the flow net and the loss as
    ``make_train_step`` calls them, on f64 copies of ``base`` and ``seq``."""
    import copy

    from cista_flow_torch import pretrain_flow as pf
    from cista_flow_torch.losses.flow import flow_sequence_loss

    model = copy.deepcopy(base).double().train()
    b = {k: v.double() for k, v in seq.items()}
    out = pf.flow_forward(model, b, arch, cfg.default_flow_iters())
    flow_sequence_loss(out, pretrain_target(b, bi), cfg, is_bi=bi)[0].backward()
    return {f"event_flownet.{n}": p.grad for n, p in model.named_parameters()}


def far_from_f64(exact: dict, got: dict, ref: dict) -> list:
    """(distance of ``got``, distance of ``ref``, name) from ``exact`` by
    relative L2 per leaf, the farthest ``got`` first; the pre-norm biases
    (true gradient 0) aside."""
    rows = []
    for k, x in exact.items():
        n = k.removeprefix("event_flownet.")
        if not FLOW_PRE_NORM.match(n):
            rows.append(tuple(float((g[k].double() - x).norm() / x.norm()) for g in (got, ref))
                        + (n,))
    return sorted(rows, reverse=True)


def pretrain_target(b: dict, bi: bool) -> dict:
    """The sequence loss's targets from a pretraining batch ``b``, as
    ``make_train_step`` builds them (the first frame channel)."""
    target = {"gt_img0": b["gt_img0"][:, :1].contiguous(),
              "gt_img1": b["gt_img1"][:, :1].contiguous(), "gt_flow": b["gt_flow"],
              "valid": b["valid"]}
    if bi:
        target.update(gt_flow_bw=b["gt_flow_bw"], valid_bw=b["valid"])
    return target


def grad_sources(torch, repo: Path) -> None:
    """``--grad-sources``: where the card's f32 pretraining gradients part
    from an f64 evaluation of the same step, for RAFT and DCEIFlow
    (bidirectional) at phase 11 (a)'s size and weights. The card runs
    ``make_train_step`` (a zero-rate SGD) under settings that each take one
    suspect out: as the step runs; the K1, K2, K4 and K5 wrappers on their
    plain versions (no kernel, no ``KernelFunction``); cuDNN off
    (PyTorch's own convolutions); both; cuDNN held to deterministic
    algorithms. For each: how many leaves are more than 10x the CPU's
    distance from f64 (and above 1e-5), the three worst by that ratio, and
    the flow head's first conv. Then the CPU's step on frames moved up by
    one ulp at half the pixels (how far input rounding alone carries each
    leaf), and for RAFT the share of pixels where its input scaling x / 255
    rounds otherwise on the card. Then the loss alone: its gradient with
    respect to the f64 run's flow predictions, on the CPU and on the card
    (the K2 kernel forward, and its plain version), against f64."""
    import contextlib
    import copy
    from unittest import mock

    from cista_flow_torch import pretrain_flow as pf
    from cista_flow_torch.losses.flow import flow_sequence_loss
    from cista_flow_torch.ops import cuda_aug, cuda_conv, cuda_corr, cuda_norm

    @contextlib.contextmanager
    def setting(plain=(), cudnn=True, deterministic=False):
        flags = torch.backends.cudnn
        saved = flags.enabled, flags.deterministic
        with contextlib.ExitStack() as stack:
            for m in plain:
                stack.enter_context(mock.patch.object(m, "on_cpu", lambda t: True))
            flags.enabled, flags.deterministic = cudnn, deterministic
            try:
                yield
            finally:
                flags.enabled, flags.deterministic = saved

    wrappers = {"K1": cuda_corr, "K2": cuda_aug, "K4": cuda_norm, "K5": cuda_conv}
    every = tuple(wrappers.values())
    settings = {"as the step runs": {}, "plain versions": dict(plain=every),
                **{f"plain {k} alone": dict(plain=(m,)) for k, m in wrappers.items()},
                "cuDNN off": dict(cudnn=False), "plain versions, cuDNN off": dict(
                    plain=every, cudnn=False), "cuDNN deterministic": dict(deterministic=True)}

    def grads(base, cfg, arch, bi, seq, dev):
        model = copy.deepcopy(base).to(dev)
        step = pf.make_train_step(cfg, torch.optim.SGD(model.parameters(), lr=0.0), bi, arch)
        step(model, {k: v.to(dev) for k, v in seq.items()})
        return {f"event_flownet.{n}": p.grad.detach().cpu() for n, p in model.named_parameters()}

    for arch, bi in (("raft", False), ("dceiflow", True)):
        cfg = pretrain_cfg(arch, PRETRAIN_SMALL, 2, is_bi=bi)
        seq = pretrain_batch(torch, repo, arch, PRETRAIN_SMALL, 2, "cpu", items=[1, 2], bi=bi)
        base = pf.flow_net(arch, cfg, "cpu", seed=0)
        exact = f64_grads(torch, base, cfg, arch, bi, seq)
        g_cpu = grads(base, cfg, arch, bi, seq, "cpu")
        print(f"{arch}{' bidirectional' if bi else ''}, f32 step against f64 (relative L2 "
              "per leaf, card / CPU):")
        for name, kw in settings.items():
            with setting(**kw):
                rows = far_from_f64(exact, grads(base, cfg, arch, bi, seq, "cuda"), g_cpu)
            gap = sorted((r for r in rows if r[0] > 10 * r[1] and r[0] > 1e-5),
                         key=lambda r: r[0] / max(r[1], 1e-30), reverse=True)
            head = next(r for r in rows if r[2] == "update_block.flow_head.conv1.weight")
            print(f"  {name}: {len(gap)} of {len(rows)} leaves beyond 10x the CPU's distance "
                  + ("; ".join(f"{n} {a:.2e} / {c:.2e}" for a, c, n in gap[:3]) or "-")
                  + f"; flow_head.conv1.weight {head[0]:.2e} / {head[1]:.2e}; farthest "
                  f"{rows[0][2]} {rows[0][0]:.2e} / {rows[0][1]:.2e}")

        # how far one ulp of input noise alone moves the CPU's f32 step
        gen = torch.Generator().manual_seed(5)
        nudged = dict(seq)
        for k in ("gt_img0", "gt_img1"):
            up = torch.nextafter(seq[k], torch.full_like(seq[k], 2.0))
            nudged[k] = torch.where(torch.rand(seq[k].shape, generator=gen) < 0.5, up, seq[k])
        rows = far_from_f64(exact, grads(base, cfg, arch, bi, nudged, "cpu"), g_cpu)
        print("  CPU, the frames moved up by one ulp at half the pixels / CPU: "
              + "; ".join(f"{n} {a:.2e} / {c:.2e}" for a, c, n in rows[:3]))
        if arch == "raft":
            x = 255.0 * seq["gt_img0"]
            differ = float(((x.cuda() / 255.0).cpu() != x / 255.0).float().mean())
            print(f"  RAFT's input scaling x / 255 on the card differs from the CPU's at "
                  f"{100 * differ:.1f}% of the pixels")

        model = copy.deepcopy(base).double().train()
        out = pf.flow_forward(model, {k: v.double() for k, v in seq.items()}, arch,
                              cfg.default_flow_iters())
        found = {}
        for name, dev, dtype, kw in (("f64", "cpu", torch.float64, {}),
                                     ("CPU", "cpu", torch.float32, {}),
                                     ("card", "cuda", torch.float32, {}),
                                     ("card, plain K2", "cuda", torch.float32,
                                      dict(plain=(cuda_aug,)))):
            with setting(**kw):
                o = {k: v.detach().to(dev, dtype).requires_grad_(k.startswith("flow_preds"))
                     for k, v in out.items() if torch.is_tensor(v)}
                target = pretrain_target({k: v.to(dev, dtype) for k, v in seq.items()}, bi)
                loss = flow_sequence_loss(o, target, cfg, is_bi=bi)[0]
                found[name] = torch.autograd.grad(loss, o["flow_preds"])[0].double().cpu()
        x = found.pop("f64")
        print("  the loss's gradient w.r.t. the f64 run's flow predictions against f64 "
              "(relative L2): " + ", ".join(f"{n} {float((g - x).norm() / x.norm()):.2e}"
                                            for n, g in found.items()))


def traced_step(torch, repo: Path, step, model, batch, ms: float):
    """One ``step(model, batch)`` under the profiler (host and card):
    returns the device-busy share (the card's activity, kernels, copies and
    fills, over ``ms``, the device time of the same step untraced) and that
    activity in device ms by part of the step, read from the trace's
    launches: ``optimizer`` where the launch lies in torch's
    ``Optimizer.step`` range (the clip and AdamW), ``backward`` where it
    comes from another thread than the step's (autograd runs a CUDA
    backward on its own device thread), ``forward`` the rest (the casts,
    the flow net, the loss)."""
    prof_ = torch.profiler
    with prof_.profile(activities=[prof_.ProfilerActivity.CPU,
                                   prof_.ProfilerActivity.CUDA]) as prof:
        with prof_.record_function("chip_smoke.step"):
            step(model, batch)
        torch.cuda.synchronize()
    path = repo / "build" / "pretrain_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    path.unlink()
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    main_tid = next(e["tid"] for e in marks if e["name"] == "chip_smoke.step")
    optimizer = [(e["ts"], e["ts"] + e["dur"]) for e in marks
                 if e["name"].startswith("Optimizer.step#") and e["tid"] == main_tid]
    # the host side of each launch: the CUDA API call, on the thread that made it
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat", "").startswith("cuda_") and "correlation" in e.get("args", {})}
    parts = dict(forward=0.0, backward=0.0, optimizer=0.0, unmatched=0.0)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            part = "unmatched"
        elif launch["tid"] != main_tid:
            part = "backward"
        elif any(a <= launch["ts"] <= b for a, b in optimizer):
            part = "optimizer"
        else:
            part = "forward"
        parts[part] += e["dur"] / 1e3
    if not optimizer or not parts["backward"] or parts["unmatched"] > 0.01 * sum(parts.values()):
        raise AssertionError(f"the trace's split is not readable: {len(optimizer)} optimizer "
                             f"ranges, device ms {parts}")
    return sum(parts.values()) / ms, parts


def pretrain_bf16(torch, repo: Path, counters: dict) -> dict:
    """(b) bf16 pretraining steps at full width (``PRETRAIN_BF16``), the
    ``--opt raft`` optimizer: a warm-up step, then a counted step
    (launches against ``pretrain_launches``) timed by CUDA events with the
    peak memory, then a traced step (``traced_step``: the device-busy share
    and the device time of the forward, the backward and the optimizer);
    the loss finite and the parameters f32."""
    from cista_flow_torch import pretrain_flow as pf

    total = {k: 0 for k in counters}
    for arch, iters, hw, batch_size in PRETRAIN_BF16:
        cfg = pretrain_cfg(arch, hw, iters, "bfloat16")
        batch = pretrain_batch(torch, repo, arch, hw, batch_size, "cuda")
        model = pf.flow_net(arch, cfg, "cuda", seed=0)
        opt = pf.make_raft_optimizer(model, PRETRAIN_LR, 100)
        step = pf.make_train_step(cfg, opt, False, arch)
        t0 = time.perf_counter()
        step(model, batch)                                        # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        (loss, epe), got = counted(counters, lambda: step(model, batch))
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tag = f"pretrain {arch} bf16, {hw[0]}x{hw[1]}, batch {batch_size}, {iters} iterations"
        expect_launches(f"{tag} step", got, pretrain_launches(arch, iters))
        for key in total:
            total[key] += got[key]
        busy, split = traced_step(torch, repo, step, model, batch, ms)
        if not np.isfinite(float(loss)) or any(p.dtype != torch.float32
                                               for p in model.parameters()):
            raise AssertionError(f"{tag}: loss {float(loss)}, or master parameters not f32")
        print(f"  {tag}: loss {float(loss):.4f}, epe {float(epe):.3f}; device ms per step "
              f"{ms:.1f}; device busy {100 * busy:.1f}%, of which, device ms: forward "
              f"{split['forward']:.1f}, backward {split['backward']:.1f}, optimizer "
              f"{split['optimizer']:.1f}, unmatched {split['unmatched']:.2f}; peak memory "
              f"{peak:.2f} GiB (host s: warm-up {t1 - t0:.1f})")
    return total


def kernels_at_pretrain_shapes(torch) -> dict:
    """(c) The kernels at the shapes pretraining gives them and no earlier
    phase holds, against their plain versions, timed as in phase 3: K1 on
    RAFT's 48x64 pyramid at batch 10, K2 as the sequence loss calls it
    (the first frame, C = 1, in the step's dtype, warped by an f32 flow,
    ungated) at RAFT's 384x512 and at 192x256, K4 at RAFT's fnet planes
    (2B = 20 samples), K5 at RAFT's 64->64 convs at 192x256 and 128->128
    at 48x64. Then K3a and the K4s route with gradients on the card against autograd
    of their plain versions on the same inputs, in f32 and bf16 (the
    Function's backward recomputes that plain version: they differ by the
    card's summation order alone). Returns rows per kernel for the kernels
    line's ``shapes``."""
    import torch.nn.functional as F
    from cista_flow_torch.ops import cuda_aug, cuda_conv, cuda_ista2, cuda_norm
    from cista_flow_torch.profile_kernels import grid_sample_call

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows = {"K1": [], "K2": [], "K4": [], "K5": []}
    print("kernels at the pretraining shapes:")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        with cudnn_fp32_scope(torch, "float32"):
            k1 = k1_checks(torch, randn, dtype, shapes=(RAFT_PYRAMID,))
        rows["K1"] += [dict(r, dtype=dtype) for r in k1["shapes"]]
        for shape in PRETRAIN_WARP_SHAPES:
            bsz, c, hh, ww = shape
            img = torch.rand(*shape, generator=g, device=dev).to(dt)     # a frame in [0, 1)
            flow = randn(bsz, 2, hh, ww, scale=3.0)
            ref = cuda_aug.warp_reflect_plain(img.float(), flow, -1.0)
            err = compare(torch, f"K2 warp {shape}", dtype, cuda_aug.warp_reflect(img, flow, -1.0),
                          ref, warp_tol(img, ref, max(hh, ww), dtype))
            ms = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow, -1.0))
            plain = time_ms(torch, lambda: cuda_aug.warp_reflect_plain(img, flow, -1.0))
            lib = time_ms(torch, grid_sample_call(img, flow, -1.0))
            bms, by = bound(2 * img.numel() * es + flow.numel() * 4,
                            bsz * hh * ww * (40 + 8 * c), "float32")
            print(f"  K2 {shape} {dtype}: {ms:.4f} ms (plain {plain:.4f}, grid_sample "
                  f"{lib:.4f}, bound {bms:.4f} by {by})")
            rows["K2"].append(dict(shape=list(shape), dtype=dtype, max_abs_err=err, ms=ms,
                                   plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib))
            del img, flow, ref
        for shape in RAFT_NORM_SHAPES:
            x = (randn(*shape) * 2.0 + 0.5).to(dt)
            ref = cuda_norm.instance_norm_plain(x.float(), relu=True)
            err = compare(torch, f"K4 norm {shape} relu=True", dtype,
                          cuda_norm.instance_norm_fused(x, relu=True), ref,
                          2e-5 if dtype == "float32" else bf16_tol(ref, 2))
            ms = time_ms(torch, lambda: cuda_norm.instance_norm_fused(x, relu=True))
            plain = time_ms(torch, lambda: cuda_norm.instance_norm_plain(x, relu=True))
            lib = time_ms(torch, lambda: F.relu(F.instance_norm(x)))
            bms, by = bound(2 * x.numel() * es, 7 * x.numel(), "float32")
            print(f"  K4 {shape} {dtype}: {ms:.4f} ms (plain {plain:.4f}, F.instance_norm + "
                  f"relu {lib:.4f}, bound {bms:.4f}; rule "
                  f"{cuda_norm.launch_rule(shape[2] * shape[3], es)})")
            rows["K4"].append(dict(shape=list(shape), dtype=dtype, max_abs_err=err, ms=ms,
                                   plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib))
            del x, ref
        for shape in RAFT_CONV_SHAPES:
            c = shape[1]
            x = randn(*shape).to(dt)
            wk = randn(c, c, 3, 3, scale=(9 * c) ** -0.5).to(dt)
            bk = randn(c, scale=0.1).to(dt)
            with cudnn_fp32_scope(torch, "float32"):
                ref = cuda_conv.conv3x3_plain(x.float(), wk.float(), bk.float(), "zeros", True)
                err = compare(torch, f"K5 conv3x3 {shape[1:]} zeros relu=True", dtype,
                              cuda_conv.conv3x3(x, wk, bk, "zeros", True), ref,
                              f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 2))
                ms = time_ms(torch, lambda: cuda_conv.conv3x3(x, wk, bk, "zeros", True))
                lib = time_ms(torch, lambda: cuda_conv.conv3x3_plain(x, wk, bk, "zeros", True))
            ops = 2 * 9 * c * c * shape[0] * shape[2] * shape[3]
            bms, by = bound((2 * x.numel() + wk.numel() + bk.numel()) * es, ops, dtype)
            print(f"  K5 {shape} {dtype}: {ms:.4f} ms (F.conv2d {lib:.4f}, bound {bms:.4f} by "
                  f"{by}; {ops / ms * 1e-9:.1f} TFLOP/s)")
            rows["K5"].append(dict(shape=list(shape), dtype=dtype, max_abs_err=err, ms=ms,
                                   plain_ms=lib, bound_ms=bms, bound_by=by, library_ms=lib))
            del x, ref

        # K3a and the K4s route under a gradient: the kernel forward, autograd
        # of the plain version backward, against autograd of the plain version
        c = 64
        leaves = [randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5), randn(c, scale=0.05),
                  randn(2 * c, c, 3, 3, scale=(9 * c) ** -0.5), randn(2 * c, scale=0.05),
                  torch.rand(2 * c, generator=g, device=dev) * 0.01,
                  randn(2, c, 45, 60), randn(2, 2 * c, 45, 60, scale=0.1)]
        cases = {"K3a": (lambda *t: cuda_ista2.fused_ista_v2(t[:5], t[5], t[6], 2),
                         lambda *t: cuda_ista2.ista_loop_plain(t[:5], t[5], t[6], 2), leaves),
                 "K4s": (lambda x: cuda_norm.instance_norm_from_stats(x, relu=True),
                         lambda x: cuda_norm.instance_norm_plain(x, relu=True),
                         [randn(4, 64, 48, 64) * 2.0 + 0.5])}
        for key, (fn, plain, inputs) in cases.items():
            cot = torch.randn(inputs[-1].shape, generator=g, device=dev).to(dt)
            grads = []
            for f in (fn, plain):
                ts = [t.to(dt).requires_grad_(True) for t in inputs]
                out = f(*ts)
                if f is fn and getattr(out.grad_fn, "kernel", None) != key:
                    raise AssertionError(f"{key}: its kernel Function is not in the graph")
                grads.append(torch.autograd.grad(out, ts, cot))
            for i, (a, b) in enumerate(zip(*grads)):
                compare(torch, f"{key} gradient of input {i}, kernel forward", dtype, a, b,
                        f32_tol(b) if dtype == "float32" else bf16_tol(b, 2))
    return rows


def flow_quality_smoke(torch, repo: Path, counters: dict) -> dict:
    """(d) A reduced ``python -m cista_flow_torch.sim_flow_quality``
    (``FLOW_SMOKE``: DCEIFlow, 180x240, bf16, the one-cycle AdamW) into the
    ignored ``build/sim_flow_quality_smoke``: every EPE finite and the
    trained net's below the untrained one's; then its checkpoint through
    ``--path_to_flownet`` into one reduced ``sim_quality`` epoch of
    cista-eiflow (``FLOWNET_SMOKE``)."""
    import shutil

    from cista_flow_torch import sim_flow_quality, sim_quality

    work = repo / "build" / "sim_flow_quality_smoke"
    shutil.rmtree(work / "models", ignore_errors=True)
    t0 = time.perf_counter()
    out, got = counted(counters, lambda: sim_flow_quality.run(sim_flow_quality.parse_args(
        ["--workdir", str(work), *FLOW_SMOKE])))
    print(f"  sim_flow_quality {' '.join(FLOW_SMOKE)}: {json.dumps(out)}; launches {got}; "
          f"{time.perf_counter() - t0:.1f} s")
    if not all(np.isfinite(out[k]) for k in ("epe_zero", "epe_init", "epe_trained")):
        raise AssertionError(f"sim_flow_quality: an EPE is not finite: {out}")
    if not out["epe_trained"] < out["epe_init"]:
        raise AssertionError(f"sim_flow_quality: epe_trained {out['epe_trained']} >= "
                             f"epe_init {out['epe_init']}")
    qwork = repo / "build" / "sim_quality_flownet"
    shutil.rmtree(qwork / "models", ignore_errors=True)
    t1 = time.perf_counter()
    q, got_q = counted(counters, lambda: sim_quality.run(sim_quality.parse_args(
        ["--workdir", str(qwork), "--path_to_flownet", out["ckpt"], *FLOWNET_SMOKE])))
    print(f"  sim_quality {' '.join(FLOWNET_SMOKE)} --path_to_flownet {out['ckpt']}: "
          f"{json.dumps(q)}; launches {got_q}; {time.perf_counter() - t1:.1f} s")
    if not all(np.isfinite(v) for k, v in q.items() if k not in ("ckpt", "epochs")):
        raise AssertionError(f"sim_quality from the pretrained flow net: {q}")
    return {k: got[k] + got_q[k] for k in got}


def timed_calls(seconds: dict, targets):
    """A context in which each ``(owner, attribute, item)`` of ``targets``
    is wrapped to add its calls' host seconds to ``seconds[item]``."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in targets]

        def timer(fn, item):
            def call(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    seconds[item] = seconds.get(item, 0.0) + time.perf_counter() - t0
            return call
        for (owner, attr, fn), (_, _, item) in zip(saved, targets):
            setattr(owner, attr, timer(fn, item))
        try:
            yield seconds
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)
    return ctx()


def chairs2_pretraining(torch, repo: Path, counters: dict) -> dict:
    """(e) A FlyingChairs2-layout folder written by the port at
    FlyingChairs2's 384x512 (``data.sim.write_chairs2_dataset``:
    ``CHAIRS2_SAMPLES`` simulated RGB pairs, ``.flo`` both ways, HDF5
    events) into the ignored ``build/chairs2_data``; then ``python -m
    cista_flow_torch.pretrain_flow --data_kind chairs2`` (its ``main``, in
    this process) in bf16 at the /32 crop 352x480, batch ``CHAIRS2_BATCH``,
    one epoch (3 steps), for DCEIFlow (``--is_bi``) and RAFT (``--opt
    raft``), 6 GRU iterations. For each: every loss finite, the launches of
    every step (``pretrain_launches``), device ms per step (CUDA events;
    the first step is the warm-up), the device-busy share of one more
    traced step (``traced_step``), the host ms per batch by item (PNG
    decode, ``.flo``, HDF5, voxelization, augmentation, the rest of
    ``make_batches``), the peak memory, and the checkpoint loaded strictly
    into a fresh net."""
    import contextlib
    import io as _io
    import shutil

    from cista_flow_torch import pretrain_flow as pf
    from cista_flow_torch.config import Config
    from cista_flow_torch.data import flying_chairs2 as fc2
    from cista_flow_torch.data import png
    from cista_flow_torch.data.augmentors import EventFlowAugmentor
    from cista_flow_torch.data.sim import write_chairs2_dataset

    root = repo / "build" / "chairs2_data"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_chairs2_dataset(str(root), CHAIRS2_SAMPLES, *CHAIRS2_HW, seed=0)
    size = sum(p.stat().st_size for p in root.rglob("*") if p.is_file()) / 2 ** 20
    print(f"  chairs2: {CHAIRS2_SAMPLES} samples at {CHAIRS2_HW[0]}x{CHAIRS2_HW[1]} written in "
          f"{time.perf_counter() - t0:.1f} s ({size:.1f} MiB, build/chairs2_data)")
    # one frame's decode, its rows Paeth-filtered as written and with filter 0
    paeth = root / "train" / "0000000-img_0.png"
    plain = root / "frame_filter0.png"
    png.write_png(str(plain), png.read_png(str(paeth))[:, :, ::-1])
    decode = {}
    for name, path in (("paeth", paeth), ("filter 0", plain)):
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            png.read_png(str(path))
            times.append(1e3 * (time.perf_counter() - t1))
        decode[name] = statistics.median(times)
    plain.unlink()
    print(f"  PNG decode of one {CHAIRS2_HW[0]}x{CHAIRS2_HW[1]} RGB frame (median of 3): "
          + ", ".join(f"{k} rows {v:.1f} ms" for k, v in decode.items()))
    total = {k: 0 for k in counters}
    for arch, extra in (("dceiflow", ["--is_bi", "--is_reverse_events"]),
                        ("raft", ["--opt", "raft"])):
        models = root / "models"
        steps, batches, host = [], [], {}
        make_step, make_batches = pf.make_train_step, pf.make_batches

        def counted_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def run(model, batch):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out, got = counted(counters, lambda: step(model, batch))
                stop.record()
                torch.cuda.synchronize()
                steps.append((start.elapsed_time(stop), got, float(out[0]), step, model, batch))
                return out
            return run

        def timed_batches(*args, **kwargs):
            it = make_batches(*args, **kwargs)
            while True:
                t1 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                batches.append(time.perf_counter() - t1)
                yield batch

        flags = ["--data_kind", "chairs2", "--flow_arch", arch, "--path_to_train_data", str(root),
                 "--path_to_model", str(models), "--image_dim", *map(str, CHAIRS2_CROP),
                 "--batch_size", str(CHAIRS2_BATCH), "--epochs", "1", "--dtype", "bfloat16",
                 "--lr", str(PRETRAIN_LR), *extra]
        targets = [(fc2, "read_gen", "png"), (fc2, "read_dense_flow", "flo"),
                   (fc2, "read_event_h5", "hdf5"), (fc2, "events_to_voxel_triangular", "voxelize"),
                   (EventFlowAugmentor, "__call__", "augment")]
        torch.cuda.reset_peak_memory_stats()
        pf.make_train_step, pf.make_batches = counted_step, timed_batches
        try:
            with timed_calls(host, targets), contextlib.redirect_stdout(_io.StringIO()):
                t1 = time.perf_counter()
                code = pf.main(flags)
                secs = time.perf_counter() - t1
        finally:
            pf.make_train_step, pf.make_batches = make_step, make_batches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tag = (f"pretrain_flow --data_kind chairs2 {arch} bf16, {CHAIRS2_CROP[0]}x"
               f"{CHAIRS2_CROP[1]}, batch {CHAIRS2_BATCH}")
        if code != 0 or len(steps) != CHAIRS2_SAMPLES // CHAIRS2_BATCH:
            raise AssertionError(f"{tag}: exit {code}, {len(steps)} steps")
        want = pretrain_launches(arch, 6, is_bi=arch == "dceiflow")
        for i, (ms, got, loss, *_) in enumerate(steps):
            expect_launches(f"{tag} step {i + 1} ({ms:.1f} device ms, loss {loss:.4f})", got, want)
            if not np.isfinite(loss):
                raise AssertionError(f"{tag}: step {i + 1}'s loss {loss}")
            for key in total:
                total[key] += got[key]
        ms = statistics.median(m for m, *_ in steps[1:])
        step, model, batch = steps[-1][3:]
        busy, split = traced_step(torch, repo, step, model, batch, ms)
        per_batch = {k: 1e3 * v / len(batches) for k, v in host.items()}
        per_batch["rest"] = 1e3 * sum(batches) / len(batches) - sum(per_batch.values())
        saved = torch.load(models / f"{arch}_b5" / f"{arch}_1.pth.tar", weights_only=True)
        pf.flow_net(arch, Config(model_mode="cista-eiflow"), "cpu").load_state_dict(
            saved["model"], strict=True)
        print(f"  {tag}: {secs:.1f} s for {len(steps)} steps; device ms per step (after the "
              f"warm-up {steps[0][0]:.1f}) {ms:.1f}, busy {100 * busy:.1f}% (device ms: forward "
              f"{split['forward']:.1f}, backward {split['backward']:.1f}, optimizer "
              f"{split['optimizer']:.1f}); host ms per batch of {CHAIRS2_BATCH}: "
              f"{1e3 * sum(batches) / len(batches):.1f} (" +
              ", ".join(f"{k} {v:.1f}" for k, v in per_batch.items()) +
              f"); peak memory {peak:.2f} GiB; the checkpoint loads strictly; on {nvidia_smi()}")
    return total


def flow_pretraining(torch, repo: Path, counters: dict) -> dict:
    """Phase 11: flow-net pretraining. See the module's docstring."""
    total = {k: 0 for k in counters}
    for part in (pretrain_against_cpu, pretrain_bf16, flow_quality_smoke, chairs2_pretraining):
        t0 = time.perf_counter()
        for key, n in part(torch, repo, counters).items():
            total[key] += n
        print(f"  {part.__name__}: {time.perf_counter() - t0:.1f} s")
    return total


# phase 12: f32 (fix, loss_mode, tag) steps of (a) and (c), T = 2, global batch 2
DP_PHASES = (("flow", "rec", "phase 2"), ("rec", "both", "phase 3 flow half"))
DP_T, DP_BATCH, DP_BF16_STEPS = 2, 2, 2   # bf16: 3 steps until phase 16 needed the time


def dp_seq(torch, repo: Path, t_len: int, batch: int) -> str:
    """The first ``batch`` sequences of ``t_len`` steps as a file the ranks
    load (their global batch)."""
    path = repo / "build" / "dp" / f"seq_t{t_len}_b{batch}.pt"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save(train_batch(torch, repo, t_len, batch, "cpu"), path)
    return str(path)


def step_against_one_process(torch, name, cfg, sd, seq, fix, mode, ranks, want) -> dict:
    """The first train step of each rank of ``ranks`` (``parallel.check``'s
    results) against one process's on cuda:0 on the global batch ``seq``
    from the state dict ``sd``: the loss to 1e-5 relative, every gradient
    leaf by ``leaf_report`` at 1e-3, the BN running statistics to 1e-4 of
    their largest magnitude, the ranks' losses and states bit for bit the
    same, each rank's launches ``want``. Returns the one process's
    launches."""
    from cista_flow_torch.models import composite
    from cista_flow_torch.ops.cuda_build import kernel_counters
    from cista_flow_torch.parallel import train_step as TS
    r0 = ranks[0]
    model = composite.init(cfg, device="cpu")
    model.load_reference_state(sd)
    model.to("cuda:0")
    loss, got = counted(kernel_counters(), lambda: float(TS.make_train_step(
        cfg, TS.make_optimizer(model, 1e-4), mode, fix, False)(model, seq)))
    rel = abs(r0["losses"][0] - loss) / abs(loss)
    print(f"  {name}: loss {len(ranks)} ranks {r0['losses'][0]:.7f}, one process {loss:.7f}, "
          f"relative difference {rel:.3e} (tol 1e-5)")
    if rel > 1e-5 or any(r["losses"] != r0["losses"] or r["digest"] != r0["digest"]
                         for r in ranks):
        raise AssertionError(f"{name}: loss {rel}, or the ranks' states differ")
    ref = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()
           if p.grad is not None}
    if sorted(ref) != sorted(r0["grads"]):
        raise AssertionError(f"{name}: the ranks' gradient leaves are not the process's")
    leaf_report(name, r0["grads"], ref, 1e-3, fix == "rec")
    worst = 0.0
    for k, v in model.state_dict().items():
        if "running" in k:
            v = v.cpu()
            worst = max(worst, float((r0["state"][k] - v).abs().max() / v.abs().max()))
    print(f"    BN running statistics: largest difference {worst:.3e} of the "
          "buffer's largest magnitude (tol 1e-4)")
    if worst > 1e-4:
        raise AssertionError(f"{name}: BN running statistics differ by {worst}")
    for r, res in enumerate(ranks):
        expect_launches(f"{name}, rank {r}", res["launches"][0], want)
    return got


def dp_against_one_process(torch, repo: Path, device: str, backend, tag: str) -> dict:
    """Two data-parallel ranks (``parallel.check.train_step_rank``) on
    ``device`` over ``backend`` against one process on cuda:0 on the global
    batch: cista-eiflow (6,5) from the sim40 anchor at 180x240, one f32
    step, T = 2, global batch 2 (local 1), in phase 2 and phase 3's flow
    half (cnet's BatchNorm trains): the loss to 1e-5 relative, every
    gradient leaf by ``leaf_report`` at 1e-3, the BN running statistics to
    1e-4 of their largest magnitude, both ranks' states bit for bit the
    same, and each rank's launches ``train_launches``. Then bf16, T = 10,
    global batch 4, 3 steps in phase 3's flow half: device ms per step per
    rank (steps 2 and 3), busy share of a traced step, peak memory,
    launches per rank and step. Returns the ranks' launches."""
    from cista_flow_torch import weights
    from cista_flow_torch.config import Config
    from cista_flow_torch.parallel import check

    iters, depth, anchor = TRAIN_POINT
    cfg = Config(model_mode="cista-eiflow", image_dim=(H, W), depth=depth, flow_iters=iters)
    bf16 = Config(model_mode="cista-eiflow",
                  image_dim=(H, W), depth=depth, flow_iters=iters, dtype="bfloat16")
    f32_seq = dp_seq(torch, repo, DP_T, DP_BATCH)
    jobs = [dict(cfg=cfg, weights=str(repo / anchor), seq=f32_seq, fix=fix, loss_mode=mode,
                 use_gt_flow=False) for fix, mode, _ in DP_PHASES]
    jobs.append(dict(cfg=bf16, weights=str(repo / anchor),
                     seq=dp_seq(torch, repo, TRAIN_T, TRAIN_BATCH), fix="rec", loss_mode="both",
                     use_gt_flow=False, steps=DP_BF16_STEPS, timed=True))
    t0 = time.perf_counter()
    ranks = check.run(check.train_step_rank, 2, device, jobs, str(repo / "build" / "dp" / "out"),
                      backend=backend)
    print(f"  {tag}: two ranks ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    total = {}
    sd = weights.load_state_dict(str(repo / anchor))
    seq = {k: v.to("cuda:0") for k, v in torch.load(f32_seq, weights_only=True).items()}
    for (fix, mode, phase), r0, r1 in zip(DP_PHASES, ranks[0], ranks[1]):
        name = f"{tag}, {phase}, f32 T={DP_T}, global batch {DP_BATCH}"
        step_against_one_process(torch, name, cfg, sd, seq, fix, mode, (r0, r1),
                                 train_launches(mode, iters, DP_T))
    r0, r1 = ranks[0][-1], ranks[1][-1]
    for r, res in enumerate((r0, r1)):
        for i, got in enumerate(res["launches"]):
            expect_launches(f"{tag}, bf16 T={TRAIN_T}, rank {r}, step {i + 1}", got,
                            train_launches("both", iters, TRAIN_T))
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"{tag}: bf16 losses {res['losses']}")
        print(f"  {tag}, bf16 (6,5), T={TRAIN_T}, global batch {TRAIN_BATCH} (local "
              f"{TRAIN_BATCH // 2}), phase 3 flow half, rank {r}: losses "
              + ", ".join(f"{x:.4f}" for x in res["losses"]) + "; device ms per step "
              + ", ".join(f"{x:.1f}" for x in res["ms"]) + f"; busy {100 * res['busy']:.1f}%; "
              f"peak memory {res['peak_gib']:.2f} GiB")
    for rank in ranks:
        for res in rank:
            for got in res["launches"]:
                for key, n in got.items():
                    total[key] = total.get(key, 0) + n
    return total


def copy_streams(trace_path: str) -> tuple:
    """(the streams of the pinned host-to-device copies, the stream most
    kernels ran on) in a chrome trace."""
    import collections
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    copies = {e["args"].get("stream") for e in events
              if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")
              and "Pinned" in e.get("name", "")}
    kernels = collections.Counter(e["args"].get("stream") for e in events
                                  if e.get("cat") == "kernel")
    return copies, kernels.most_common(1)[0][0]


def train_cli_distributed(torch, repo: Path, counters: dict) -> dict:
    """Phase 12 (b): ``python -m cista_flow_torch.train --distributed``
    (NCCL, a rank per card) trains one epoch (phase 1) of the simulated set
    at (6,5) in bf16 from the sim40 anchor, T = 10, a host batch of 4 (of
    the card count where 4 does not split over it), with full-state saves:
    exit 0, one log, one ``.pth.tar`` and one full state. Then it resumes
    (``--load_epoch_for_train -1``) for epoch 2 (phase 2): on a one-card
    machine in this process under the profiler, whose trace must show the
    prefetcher's pinned copies on another stream than the step's kernels;
    elsewhere as a command, followed by a traced one-process epoch."""
    import contextlib
    import io
    import shutil

    from cista_flow_torch import train

    cards = torch.cuda.device_count()
    batch = TRAIN_BATCH if TRAIN_BATCH % cards == 0 else cards
    data = repo / "build" / "train_data"
    if cards > TRAIN_VIDEOS:
        from cista_flow_torch.data.sim import write_train_dataset
        data = repo / "build" / "dp_train_data"
        if not (data / "train_e2v_estflow.txt").exists():
            write_train_dataset(str(data), cards, TRAIN_FRAMES, H, W, seed=0)
    out = repo / "build" / "dp_models"
    shutil.rmtree(out, ignore_errors=True)
    iters, depth, anchor = TRAIN_POINT
    args = ["--model_mode", "cista-eiflow", "--path_to_train_data", str(data), "--path_to_model",
            str(out), "--path_to_e2vflow", str(repo / anchor), "-d", str(depth), "--flow_iters",
            str(iters), "-s", str(TRAIN_T), "--batch_size", str(batch), "--flow_epoch", "1",
            "--rec_epoch", "1", "--dtype", "bfloat16", "--orbax_ckpt", "--distributed"]
    name = train.model_name_from_cfg(train.parse_args(args)[0])
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "cista_flow_torch.train", *args, "--epochs", "1"],
                         cwd=repo, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    print(f"  (b) train --distributed, {cards} card(s), epoch 1: exit {run.returncode} in "
          f"{secs:.1f} s; " + " | ".join(line for line in run.stdout.splitlines()
                                          if "loss" in line or "saved" in line))
    if run.returncode != 0:
        raise AssertionError(f"train --distributed failed:\n{run.stdout[-3000:]}\n"
                             f"{run.stderr[-3000:]}")
    saved = sorted(os.listdir(out / name))
    if run.stdout.count("saved ") != 1 or saved != [f"{name}_1.pth.tar", "full_state"]:
        raise AssertionError(f"(b) not one writer: {saved}; {run.stdout.count('saved ')} saves "
                             "logged")

    resume = args + ["--epochs", "2", "--load_epoch_for_train", "-1"]
    total = {k: 0 for k in counters}
    log = io.StringIO()
    trace = str(repo / "build" / "dp" / "epoch_trace.json")
    t0 = time.perf_counter()
    if cards == 1:
        traced = resume
    else:
        run = subprocess.run([sys.executable, "-m", "cista_flow_torch.train", *resume],
                             cwd=repo, capture_output=True, text=True)
        if run.returncode != 0:
            raise AssertionError(f"the resume failed:\n{run.stderr[-3000:]}")
        log.write(run.stdout)
        traced = [a for a in args if a != "--distributed"] + [
            "--path_to_model", str(out / "one_process"), "--epochs", "1"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with contextlib.redirect_stdout(log):
            _, got = counted(counters, lambda: train.main(traced))
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    for key in total:
        total[key] += got[key]
    print(f"  (b) resume, epoch 2: {time.perf_counter() - t0:.1f} s; "
          + " | ".join(line for line in log.getvalue().splitlines()
                       if "Resumed" in line or "loss" in line or "saved" in line))
    if "Resumed exactly from full_state step 1" not in log.getvalue():
        raise AssertionError("(b) did not resume from the epoch-1 full state")
    saved = sorted(os.listdir(out / name))
    if saved != [f"{name}_1.pth.tar", f"{name}_2.pth.tar", "full_state"]:
        raise AssertionError(f"(b) after the resume: {saved}")
    copies, main_stream = copy_streams(trace)
    print(f"  (b) traced epoch: the prefetcher's pinned copies on stream(s) {sorted(copies)}, "
          f"the kernels mostly on stream {main_stream}; launches {got}")
    if not copies or main_stream in copies:
        raise AssertionError("the prefetcher's copies are not on a side stream")
    return total


def guard_on_second_card(torch) -> None:
    """Phase 12 (c): from this thread, whose current device is cuda:0, K4
    (f32) and K5 (bf16, the wgmma tile, which reads ``cudaGetDevice``) on
    tensors on cuda:1 against their plain versions there."""
    from cista_flow_torch.ops import cuda_conv, cuda_norm
    dev = torch.device("cuda", 1)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(2, 64, 96, 128, generator=gen, device=dev)
    w = torch.randn(64, 64, 3, 3, generator=gen, device=dev) * (9 * 64) ** -0.5
    b = torch.randn(64, generator=gen, device=dev) * 0.05
    if torch.cuda.current_device() != 0:
        raise AssertionError("the guard check needs cuda:0 current")
    ref = cuda_norm.instance_norm_plain(x, relu=True)
    compare(torch, "(c) K4 on cuda:1 from cuda:0", "float32",
            cuda_norm.instance_norm_fused(x, 1e-5, True), ref, f32_tol(ref))
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    ref = cuda_conv.conv3x3_plain(xb.float(), wb.float(), bb.float(), "zeros", True)
    compare(torch, "(c) K5 bf16 on cuda:1 from cuda:0", "bfloat16",
            cuda_conv.conv3x3(xb, wb, bb, "zeros", True), ref, bf16_tol(ref, 8))
    torch.cuda.synchronize(dev)


def run_parts(parts, total: dict) -> dict:
    """Run a phase's (tag, part) pairs in order, each part's launches added
    to ``total``, printing each one's time."""
    for tag, part in parts:
        t0 = time.perf_counter()
        for key, n in part().items():
            total[key] += n
        print(f"  {tag}: {time.perf_counter() - t0:.1f} s")
    return total


def data_parallel(torch, repo: Path, counters: dict) -> dict:
    """Phase 12: data-parallel training. See the module's docstring."""
    total = {k: 0 for k in counters}
    parts = [("(a) 2 ranks on cuda:0 over gloo",
              lambda: dp_against_one_process(torch, repo, "cuda:0", "gloo",
                                             "(a) 2 ranks, cuda:0, gloo")),
             ("(b) train --distributed", lambda: train_cli_distributed(torch, repo, counters))]
    if torch.cuda.device_count() >= 2:
        parts.append(("(c) 2 ranks on 2 cards over NCCL", lambda: (
            guard_on_second_card(torch),
            dp_against_one_process(torch, repo, "cuda", None, "(c) 2 ranks, 2 cards, nccl"))[1]))
    else:
        parts.append(("(c) two ranks across cards over NCCL: not run, this machine has one card",
                      dict))
    return run_parts(parts, total)


# phase 13: row-sharded serving. (mode, iters, depth, anchor, runs, flow_half)
# at each frame size; a run is (dtype, window): eraft also steps in f32, at
# 180x240 only (stepping holds the same function as the window; at 480x640
# it would take the phase past its two minutes)
SPATIAL_POINTS = (("cista-eiflow", 6, 5, "gate/flagship_sim40_f16.npz",
                   (("float32", True), ("bfloat16", True)), False),
                  ("cista-eraft", 12, 5, "gate/eraft_sim40_f16.npz",
                   (("float32", True), ("bfloat16", True), ("float32", False)), False),
                  ("cista-gtflow", None, 5, "gate/flagship_sim40_f16.npz",
                   (("float32", True), ("bfloat16", True)), False),
                  ("cista-idnet", 1, 5, "gate/idnet_sim40_f16.npz",
                   (("float32", True), ("bfloat16", True)), False),
                  ("cista-eiflow", 6, 5, "gate/flagship_sim40_f16.npz",
                   (("float32", True), ("bfloat16", True)), True))
SPATIAL_SIZES = ((H, W), SAMSUNG)
SPATIAL_STEPS = 8        # phase 13's stream; 16 (STEPS) until phase 15 needed the time
SPATIAL_F32_SIZES = ((H, W),)   # the f32 rank runs; 480x640's too until phase 16 needed the
                                # time (its bf16 runs still hold against the f32 one process)
SPATIAL_K2 = {}          # the banded K2's row of the kernels line, once phase 13 ran


def rank_launches(mode: str, iters, steps: int, window: bool) -> dict:
    """One rank's launches for ``steps`` steps of its band: one process's
    (``window_launches``; cista-eraft stepping encodes both voxels every
    step), but each instance norm is K4s's statistics, combined over the
    ranks, where one process runs K4."""
    if mode == "cista-eraft" and not window:
        want = {"K1": iters * steps, "K2": 2 * steps, "K3": steps, "K4": NORMS * steps,
                "K5": (2 * SQUARE_CONVS + 1) * steps}
    else:
        want = window_launches(mode, iters, steps)
    want = dict(want)
    if "K4" in want:
        want["K4s"] = want.pop("K4")
    return want


def spatial_inputs(torch, repo: Path, hw) -> tuple:
    """(voxels, GT flows) of a ``SPATIAL_STEPS``-step stream at ``hw`` as
    .npy files the ranks load, and the arrays."""
    root = repo / "build" / "spatial"
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(13)
    shape = (SPATIAL_STEPS, 5, *hw)
    vox = (rng.standard_normal(shape) * 2.0 * (rng.random(shape) < 0.05)).astype(np.float32)
    gts = (rng.standard_normal((SPATIAL_STEPS, 2, *hw)) * 1.5).astype(np.float32)
    paths = (root / f"vox_{hw[0]}.npy", root / f"gt_{hw[0]}.npy")
    np.save(paths[0], vox)
    np.save(paths[1], gts)
    return (str(paths[0]), str(paths[1])), (vox, gts)


def banded_k2(torch) -> None:
    """Phase 13: K2 with an output row offset, at the bands of 2 ranks at
    180x240 and 480x640 (the code at half resolution, C = 128, and the
    frame, C = 1), against ``warp_reflect_plain`` of the same band on the
    card, with the gate true (the warp) and false (the band's rows of the
    source, bit for bit); timed at rank 1's code band of 180x240 in bf16
    beside the plain version and ``F.grid_sample`` on the band's grid.
    The bound counts the source rows this flow reaches."""
    from cista_flow_torch.ops import cuda_aug
    from cista_flow_torch.ops.warp import frame_warp_coords
    from cista_flow_torch.parallel import spatial
    from cista_flow_torch.profile_kernels import grid_sample_call

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    errs = []
    for hh, ww in SPATIAL_SIZES:
        part = spatial.partition((hh, ww), 2, 5)
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for c, scale in ((128, 2), (1, 1)):
                img = torch.randn(1, c, hh // scale, ww // scale, generator=g, device=dev).to(dt)
                for r in range(2):
                    lo, hi, _ = part.rows(r, scale)
                    flow = torch.randn(1, 2, hi - lo, ww // scale, generator=g, device=dev) * 3.0
                    ref = cuda_aug.warp_reflect_plain(img.float(), flow, -1.0, None, lo)
                    out = cuda_aug.warp_reflect(img, flow, -1.0, torch.tensor(True, device=dev),
                                                lo)
                    errs.append(compare(torch, f"K2 band rows {lo}..{hi} of {img.shape[2]}, "
                                        f"C={c}", dtype, out, ref,
                                        warp_tol(img, ref, max(hh, ww), dtype)))
                    kept = cuda_aug.warp_reflect(img, flow, -1.0,
                                                 torch.tensor(False, device=dev), lo)
                    if not torch.equal(kept, img[:, :, lo:hi]):
                        raise AssertionError(f"K2 band {lo}..{hi}, gate false: not the source's "
                                             "rows bit for bit")
    # timed: rank 1's code band at 180x240, bf16, the serving path's gate
    part = spatial.partition((H, W), 2, 5)
    lo, hi, _ = part.rows(1, 2)
    img = torch.randn(1, 128, H // 2, W // 2, generator=g, device=dev).bfloat16()
    flow = torch.randn(1, 2, hi - lo, W // 2, generator=g, device=dev) * 3.0
    gate = torch.tensor(True, device=dev)
    ms = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow, -1.0, gate, lo))
    plain = time_ms(torch, lambda: cuda_aug.warp_reflect_plain(img, flow, -1.0, gate, lo))
    lib = time_ms(torch, grid_sample_call(img, flow, -1.0, lo))
    _, gy = frame_warp_coords(flow, -1.0, lo, H // 2)
    reach = (min(max(int(gy.min().floor()), 0), H // 2 - 1),
             min(int(gy.max().ceil()) + 1, H // 2 - 1))
    rows_read = reach[1] - reach[0] + 1
    nbytes = (rows_read + (hi - lo)) * 128 * (W // 2) * 2 + flow.numel() * 4
    bms, by = bound(nbytes, (hi - lo) * (W // 2) * (40 + 8 * 128), "float32")
    print(f"  K2 band (1, 128, rows {lo}..{hi} of {H // 2}, {W // 2}) bf16: {ms:.4f} ms "
          f"(plain {plain:.4f}, grid_sample {lib:.4f}, bound {bms:.4f} by {by}: source rows "
          f"{reach[0]}..{reach[1]} reached) on {nvidia_smi()}")
    SPATIAL_K2.update(max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                      library_ms=lib)


def widened_k3(torch) -> None:
    """Phase 13: what the ISTA loop's one halo costs. K3 (bf16, depth 5, C
    = 64) on rank 0's half-resolution band of 2 ranks widened by the 11
    halo rows it computes, against the same band bare (the rows an
    exchange per conv would compute), at 180x240 and 480x640."""
    from cista_flow_torch.ops import cuda_ista2
    from cista_flow_torch.parallel import spatial

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(32)
    c, depth = 64, 5

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()
    wts = (randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5), randn(c, scale=0.05),
           randn(2 * c, c, 3, 3, scale=(9 * c) ** -0.5), randn(2 * c, scale=0.05),
           (torch.rand(2 * c, generator=g, device=dev) * 0.01).bfloat16())
    gw, gb = randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5), randn(c, scale=0.05)
    for hh, ww in SPATIAL_SIZES:
        rows = spatial.partition((hh, ww), 2, depth).sizes(2)[0]
        ms = {}
        try:
            for name, n in (("bare", rows), ("widened", rows + 2 * depth + 1)):
                x1, z = randn(1, c, n, ww // 2), randn(1, 2 * c, n, ww // 2, scale=0.1)
                ms[name] = time_ms(torch, lambda: cuda_ista2.fused_ista_dg(wts, gw, gb, x1, z,
                                                                           depth))
        except RuntimeError as e:       # device_ms found every trace short of records
            print(f"  K3 bf16 depth {depth} on rank 0's band of {hh}x{ww}: not measured ({e})")
            continue
        print(f"  K3 bf16 depth {depth} on rank 0's band of {hh}x{ww} ({rows} half-resolution "
              f"rows): {ms['bare']:.4f} ms bare, {ms['widened']:.4f} ms widened by "
              f"{2 * depth + 1} rows ({ms['widened'] / ms['bare']:.2f}x) on {nvidia_smi()}")


def spatial_ranks(torch, repo: Path, device: str, backend, tag: str, timed: bool,
                  ref_device: str = "cuda:0") -> dict:
    """Phase 13 (a) or (c): 2 ranks (``parallel.check.spatial_rank``) on
    ``device`` over ``backend`` serve ``SPATIAL_POINTS`` at both sizes,
    ``SPATIAL_STEPS`` steps, batch 1 (cista-idnet with ``next_flow`` chained over the steps,
    cista-eiflow ``flow_half`` on the bands of the half frame), against one
    process on cuda:0 on the same inputs: f32
    frames and flows within phase 4's 1e-3 at every step, bf16 frames above
    30 dB against the f32 one process at every step, each rank's launches
    ``rank_launches``, rank 0 alone returning the frame. With ``timed``
    (NCCL, a card per rank) bf16 device ms per step and the exchanges'
    share beside one card's. Returns the launches of the ranks and of the
    one-process references, the ranks' K2 under 'K2b'."""
    from cista_flow_torch.config import Config
    from cista_flow_torch.ops.cuda_build import kernel_counters
    from cista_flow_torch.parallel import check
    from cista_flow_torch.runner import Reconstructor

    counters = kernel_counters()
    total = {k: 0 for k in counters}
    total["K2b"] = 0
    jobs, names, inputs = [], [], {}
    for hw in SPATIAL_SIZES:
        paths, arrays = spatial_inputs(torch, repo, hw)
        inputs[hw] = arrays
        for mode, iters, depth, anchor, runs, half in SPATIAL_POINTS:
            for dtype, window in runs:
                if ((timed and dtype != "bfloat16") or (not window and hw != (H, W))
                        or (dtype == "float32" and hw not in SPATIAL_F32_SIZES)):
                    continue
                cfg = Config(image_dim=hw, model_mode=mode, depth=depth, flow_iters=iters,
                             dtype=dtype, flow_half=half, path_to_test_model=str(repo / anchor))
                gt = paths[1] if mode == "cista-gtflow" else None
                jobs.append(dict(kind="serve", cfg=cfg, voxels=paths[0], gt_flows=gt,
                                 window=window, timed=timed))
                names.append((hw, mode, iters, depth, dtype, window))
    t0 = time.perf_counter()
    ranks = check.run(check.spatial_rank, 2, device, jobs, str(repo / "build" / "spatial" / "out"),
                      backend=backend)
    print(f"  {tag}: two ranks ran {len(jobs)} windows of {SPATIAL_STEPS} steps in "
          f"{time.perf_counter() - t0:.1f} s")
    refs, failures = {}, []
    for (hw, mode, iters, depth, dtype, window), job, r0, r1 in zip(names, jobs, *ranks):
        half = job["cfg"].flow_half
        name = (f"{tag}, {mode}{' flow_half' if half else ''} ({iters},{depth}) "
                f"{hw[0]}x{hw[1]} {dtype} "
                f"{'window' if window else f'{SPATIAL_STEPS} x step'}")
        vox, gts = inputs[hw]
        gts = gts if mode == "cista-gtflow" else None
        key = (hw, mode, window, half)
        if key not in refs:
            rec = Reconstructor(dataclasses.replace(job["cfg"], dtype="float32"),
                                device=ref_device)
            refs[key], got = counted(counters, lambda: serve_stream(rec, vox, gts, window))
            for k in counters:
                total[k] += got[k]
        ref = refs[key]
        if r1["out"] is not None or r0["out"][0].shape != (SPATIAL_STEPS, *hw):
            failures.append(f"{name}: rank 0 alone returns the frame")
            continue
        for r, res in enumerate((r0, r1)):
            want = rank_launches(mode, iters if iters else 0, SPATIAL_STEPS, window)
            expect_launches(f"{name}, rank {r}", res["launches"], want)
            for k, n in res["launches"].items():
                total["K2b" if k == "K2" else k] += n
        sent = {k: sum(res["sent"][k] for res in (r0, r1)) / 2 / SPATIAL_STEPS / 1e6
                for k in r0["sent"]}
        line = (f"  {name}: MB sent per rank and step " +
                ", ".join(f"{k} {v:.3f}" for k, v in sent.items()))
        if dtype == "float32":
            err = max(float(np.abs(a - b).max()) for a, b in zip(r0["out"], ref))
            line += f"; against one process: max abs err {err:.3e} (tol 1e-3)"
            if err > 1e-3:
                failures.append(f"{name}: {err} from one process")
        else:
            psnr = psnr_per_step(r0["out"][0], ref[0])
            line += f"; bf16 against the f32 one process: min PSNR {min(psnr):.2f} dB (> {PSNR_MIN})"
            if min(psnr) <= PSNR_MIN:
                failures.append(f"{name}: bf16 PSNR {min(psnr):.2f}")
        if timed:
            one = one_card_ms(torch, job["cfg"], vox, gts)
            line += (f"; device ms per step rank 0 {r0['ms']:.2f}, rank 1 {r1['ms']:.2f}, "
                     f"exchanges {100 * r0['exchange_share']:.1f}% and "
                     f"{100 * r1['exchange_share']:.1f}% of the window's kernel time; one card "
                     f"{one:.2f} ms on {nvidia_smi()}")
        print(line)
    if failures:
        raise AssertionError("; ".join(failures))
    return total


def serve_stream(rec, vox, gts, window: bool) -> tuple:
    """(frames, flows) of a stream through ``rec``: one window, or a
    ``step`` per voxel."""
    use_gt = gts is not None
    if window:
        return rec.step_window(vox, gts, use_gt_flow=use_gt, return_all=True)
    steps = [rec.step(v, gts[t] if use_gt else None, use_gt_flow=use_gt)
             for t, v in enumerate(vox)]
    return tuple(np.stack(o) for o in zip(*steps))


def one_card_ms(torch, cfg, vox, gts) -> float:
    """Device ms per step of one process's window on cuda:0 (after one
    warm-up window), CUDA events."""
    from cista_flow_torch.runner import Reconstructor
    rec = Reconstructor(cfg, device="cuda:0")
    rec.step_window(vox, gts, use_gt_flow=gts is not None)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rec.step_window(vox, gts, use_gt_flow=gts is not None)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / len(vox)


def spatial_cli(torch, repo: Path) -> dict:
    """Phase 13 (b): ``python -m cista_flow_torch.test_noeval --mesh_shape 2
    --mesh_axes spatial --device cuda:0`` (two gloo ranks sharing the
    card; rank 0 reads the stream and writes) as a command, against
    ``test_noeval.main`` on one process in this one: exit 0, the same
    files, frames within one grey level. cista-eiflow (6,5), f32, phase
    6b's stream. Returns the one process's launches."""
    import contextlib
    import io as _io
    import shutil

    from cista_flow_torch import test_noeval
    from cista_flow_torch.ops.cuda_build import kernel_counters
    data = cli_data(repo)
    base = data["out"] / "spatial"
    shutil.rmtree(base, ignore_errors=True)
    flags = ["--model_mode", "cista-eiflow", "--flow_iters", "6", "-d", "5",
             "--path_to_test_model", str(repo / "gate" / "flagship_sim40_f16.npz"),
             "--path_to_test_data", str(data["stream"]), "--num_events", str(CLI_EVENTS),
             "--test_img_num", "5", "--image_dim", str(H), str(W)]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_io.StringIO()):
        _, got = counted(kernel_counters(), lambda: test_noeval.main(
            flags + ["-o", str(base / "one"), "--device", "cuda"]))
    print(f"  (b) test_noeval on one process: {time.perf_counter() - t0:.1f} s")
    extra = ["--device", "cuda:0", "--mesh_shape", "2", "--mesh_axes", "spatial"]
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "cista_flow_torch.test_noeval", *flags,
                          "-o", str(base / "two"), *extra], cwd=repo, capture_output=True,
                         text=True)
    print(f"  (b) test_noeval {' '.join(extra)}: exit {run.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    if run.returncode != 0:
        print(run.stderr)               # every rank's traceback, the first one's too
        raise AssertionError(f"test_noeval {extra} failed:\n{run.stdout[-2000:]}")
    a, b = read_pngs(base / "one"), read_pngs(base / "two")
    if not a or list(a) != list(b):
        raise AssertionError(f"(b) the files differ: {list(a)} {list(b)}")
    lv = max(int(np.abs(a[k].astype(int) - b[k].astype(int)).max()) for k in a)
    print(f"  (b) {len(a)} frames written by both, within {lv} grey level(s) (tol 1)")
    if lv > 1:
        raise AssertionError(f"(b) frames {lv} grey levels apart")
    return got


def spatial_across_cards(torch, repo: Path, counters: dict) -> dict:
    """Phase 13 (c), which ``--spatial-cards`` runs alone: two NCCL ranks,
    a card each."""
    if torch.cuda.device_count() < 2:
        raise AssertionError("phase 13 (c) needs two cards")
    return spatial_ranks(torch, repo, "cuda", None, "(c) 2 ranks, 2 cards, nccl", True)


def spatial(torch, repo: Path, counters: dict) -> dict:
    """Phase 13: row-sharded serving. See the module's docstring."""
    total = {k: 0 for k in counters}
    total["K2b"] = 0
    parts = [("(a) 2 ranks on cuda:0 over gloo",
              lambda: spatial_ranks(torch, repo, "cuda:0", "gloo", "(a) 2 ranks, cuda:0, gloo",
                                    False)),
             ("(b) test_noeval on 2 ranks", lambda: spatial_cli(torch, repo))]
    if torch.cuda.device_count() >= 2:
        parts.append(("(c) 2 ranks on 2 cards over NCCL",
                      lambda: spatial_across_cards(torch, repo, counters)))
    else:
        parts.append(("(c) two ranks across cards over NCCL: not run, this machine has one card",
                      dict))
    return run_parts(parts, total)


# phase 14: row-sharded training. f32 T and batch of the check against one
# process; bf16 T, batch and timed steps of the timing
SPATIAL_TRAIN_T, SPATIAL_TRAIN_BATCH = 2, 1
SPATIAL_BF16_T, SPATIAL_BF16_STEPS = 10, 3


def spatial_train_launches(loss_mode: str, iters: int, t_len: int) -> dict:
    """One rank's launches for a train step on its band (cista-eiflow):
    one process's (``train_launches``: the loss runs on every rank, on the
    whole frames gathered from the bands), each instance norm K4s's
    statistics where one process runs K4."""
    want = dict(train_launches(loss_mode, iters, t_len))
    want["K4s"] = want.pop("K4")
    return want


def spatial_train_ranks(torch, repo: Path, device: str, backend, tag: str) -> dict:
    """Phase 14 (a) or (c): a ``1,2`` (data, spatial) mesh
    (``parallel.check.spatial_train_rank``) on ``device`` over ``backend``:
    cista-eiflow (6,5) from the sim40 anchor at 180x240, one f32 step, T =
    2, batch 1, in phase 2 and phase 3's flow half (cnet's BatchNorm trains
    on every rank's rows; K1, K4s and the exchanges take gradients), against
    one process on cuda:0: the loss to 1e-5 relative, every gradient leaf by
    ``leaf_report`` at 1e-3, the BN running statistics to 1e-4 of their
    largest magnitude, both ranks' states bit for bit the same, each rank's
    launches ``spatial_train_launches``. Then bf16, phase 3's flow half, T =
    10, batch 1, 3 timed steps: device ms per step per rank, launches per
    rank and step, peak memory per rank and the MB each rank's exchanges
    send per step, forward and backward. Returns the launches, the ranks'
    K2 under 'K2b'."""
    from cista_flow_torch import weights
    from cista_flow_torch.config import Config
    from cista_flow_torch.ops.cuda_build import kernel_counters
    from cista_flow_torch.parallel import check

    iters, depth, anchor = TRAIN_POINT
    cfg = Config(model_mode="cista-eiflow", image_dim=(H, W), depth=depth, flow_iters=iters)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    f32_seq = dp_seq(torch, repo, SPATIAL_TRAIN_T, SPATIAL_TRAIN_BATCH)
    jobs = [dict(kind="step", grid=(1, 2), cfg=cfg, weights=str(repo / anchor), seq=f32_seq,
                 fix=fix, loss_mode=mode, use_gt_flow=False) for fix, mode, _ in DP_PHASES]
    jobs.append(dict(kind="step", grid=(1, 2), cfg=bf16, weights=str(repo / anchor),
                     seq=dp_seq(torch, repo, SPATIAL_BF16_T, 1), fix="rec", loss_mode="both",
                     use_gt_flow=False, steps=SPATIAL_BF16_STEPS))
    t0 = time.perf_counter()
    ranks = check.run(check.spatial_train_rank, 2, device, jobs,
                      str(repo / "build" / "spatial_train" / "out"), backend=backend)
    print(f"  {tag}: two ranks ran {len(jobs)} jobs in {time.perf_counter() - t0:.1f} s")
    total = {k: 0 for k in (*kernel_counters(), "K2b")}
    sd = weights.load_state_dict(str(repo / anchor))
    seq = {k: v.to("cuda:0") for k, v in torch.load(f32_seq, weights_only=True).items()}
    for (fix, mode, phase), r0, r1 in zip(DP_PHASES, ranks[0], ranks[1]):
        name = f"{tag}, {phase}, f32 T={SPATIAL_TRAIN_T}, batch {SPATIAL_TRAIN_BATCH}"
        got = step_against_one_process(torch, name, cfg, sd, seq, fix, mode, (r0, r1),
                                       spatial_train_launches(mode, iters, SPATIAL_TRAIN_T))
        for k, n in got.items():
            total[k] += n
    smi = nvidia_smi()
    for r, res in enumerate(rank[-1] for rank in ranks):
        for i, got in enumerate(res["launches"]):
            expect_launches(f"{tag}, bf16 T={SPATIAL_BF16_T}, rank {r}, step {i + 1}", got,
                            spatial_train_launches("both", iters, SPATIAL_BF16_T))
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"{tag}: bf16 losses {res['losses']}")
        sent = ", ".join(f"{k} {v / 1e6:.2f}" for k, v in res["sent"].items())
        print(f"  {tag}, bf16 (6,5), T={SPATIAL_BF16_T}, batch 1, phase 3 flow half, rank {r}: "
              "losses " + ", ".join(f"{x:.4f}" for x in res["losses"]) + "; device ms per "
              "step " + ", ".join(f"{x:.1f}" for x in res["ms"]) + f"; peak memory "
              f"{res['peak_gib']:.2f} GiB; MB sent per step {sent} on {smi}")
    for rank in ranks:
        for res in rank:
            for got in res["launches"]:
                for key, n in got.items():
                    total["K2b" if key == "K2" else key] += n
    return total


def spatial_training(torch, repo: Path, counters: dict) -> dict:
    """Phase 14: row-sharded training. See the module's docstring."""
    total = {k: 0 for k in (*counters, "K2b")}
    parts = [("(a) 2 ranks on cuda:0 over gloo",
              lambda: spatial_train_ranks(torch, repo, "cuda:0", "gloo",
                                          "(a) 1,2 mesh, cuda:0, gloo"))]
    if torch.cuda.device_count() >= 2:
        parts.append(("(c) 2 ranks on 2 cards over NCCL",
                      lambda: spatial_train_ranks(torch, repo, "cuda", None,
                                                  "(c) 1,2 mesh, 2 cards, nccl")))
    else:
        parts.append(("(c) two ranks across cards over NCCL: not run, this machine has one card",
                      dict))
    return run_parts(parts, total)


# phase 3's rows at the shapes of phases 15 and 11 (e), recorded from the
# wrappers' inputs in one cista-eiflow (6,5) step at MVSEC's 260x346 (the flow
# net's frame padded to 288x352) and in DCEIFlow's and RAFT's training
# forwards at the chairs2 crop 352x480, batch CHAIRS2_BATCH (the encoders on
# 2B)
MVSEC_HW = (260, 346)                 # DAVIS346
MVSEC_CORR = (1, 36, 44)
MVSEC_WARP = ((1, 128, 130, 173), (1, 1, 260, 346))
MVSEC_ISTA = (1, 64, 130, 173)        # x1; z has 128 channels; depth 5
MVSEC_NORM = ((1, 64, 144, 176), (1, 96, 72, 88), (1, 128, 36, 44))
MVSEC_CONV = (((1, 64, 144, 176), "zeros"), ((1, 128, 36, 44), "zeros"),
              ((1, 64, 260, 346), "reflect"))
CHAIRS2_HW = (384, 512)               # FlyingChairs2's frames
CHAIRS2_CROP = (352, 480)             # a /32 crop: RAFT's padders agree only there
CHAIRS2_BATCH = 4
CHAIRS2_SAMPLES = 12                  # 3 steps an epoch
CHAIRS2_CORR = (CHAIRS2_BATCH, 44, 60)
CHAIRS2_NORM = ((8, 64, 176, 240), (8, 96, 88, 120), (8, 128, 44, 60))
CHAIRS2_CONV = (((8, 64, 176, 240), "zeros"), ((8, 128, 44, 60), "zeros"))


def kernels_at_new_shapes(torch) -> dict:
    """With phase 3: K1, K2, K3, K4 and K5 at the shapes MVSEC's 260x346
    frame gives them (batch 1; phase 15), and K1, K4 and K5 at the chairs2
    crop's (phase 11 (e); phase 11 (c) holds RAFT at 384x512, batch 10),
    in f32 and bf16 against their plain versions as phase 3 holds them, each
    timed. Returns rows per kernel for the kernels line's ``shapes``, each
    tagged with its phase."""
    import torch.nn.functional as F
    from cista_flow_torch.ops import cuda_aug, cuda_conv, cuda_ista2, cuda_norm
    from cista_flow_torch.profile_kernels import grid_sample_call

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    rows = {k: [] for k in ("K1", "K2", "K3", "K4", "K5")}
    print("kernels at the MVSEC (260x346) and chairs2 (352x480) shapes:")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        with cudnn_fp32_scope(torch, "float32"):
            k1 = k1_checks(torch, randn, dtype, shapes=(MVSEC_CORR, CHAIRS2_CORR))
        for r, tag in zip(k1["shapes"], ("mvsec", "chairs2")):
            rows["K1"].append(dict(r, dtype=dtype, path=tag))
        gate = torch.tensor(True, device=dev)
        for shape in MVSEC_WARP:
            bsz, c, hh, ww = shape
            img = randn(*shape).to(dt)
            flow = randn(bsz, 2, hh, ww, scale=3.0)
            ref = cuda_aug.warp_reflect_plain(img.float(), flow, -1.0)
            err = compare(torch, f"K2 warp {shape}", dtype,
                          cuda_aug.warp_reflect(img, flow, -1.0, gate), ref,
                          warp_tol(img, ref, max(hh, ww), dtype))
            ms = time_ms(torch, lambda: cuda_aug.warp_reflect(img, flow, -1.0, gate))
            plain = time_ms(torch, lambda: cuda_aug.warp_reflect_plain(img, flow, -1.0, gate))
            lib = time_ms(torch, grid_sample_call(img, flow, -1.0))
            bms, by = bound(2 * img.numel() * es + flow.numel() * 4,
                            bsz * hh * ww * (40 + 8 * c), "float32")
            print(f"  K2 {shape} {dtype}: {ms:.4f} ms (plain {plain:.4f}, grid_sample "
                  f"{lib:.4f}, bound {bms:.4f} by {by})")
            rows["K2"].append(dict(shape=list(shape), dtype=dtype, path="mvsec", max_abs_err=err,
                                   ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                   library_ms=lib))
        b, c, hh, ww = MVSEC_ISTA
        x1, z = randn(b, c, hh, ww).to(dt), randn(b, 2 * c, hh, ww, scale=0.1).to(dt)
        wts = (randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5).to(dt), randn(c, scale=0.05).to(dt),
               randn(2 * c, c, 3, 3, scale=(9 * c) ** -0.5).to(dt),
               randn(2 * c, scale=0.05).to(dt),
               (torch.rand(2 * c, generator=g, device=dev) * 0.01).to(dt))
        gw, gb = randn(c, 2 * c, 3, 3, scale=(18 * c) ** -0.5).to(dt), randn(c, scale=0.05).to(dt)
        with cudnn_fp32_scope(torch, "float32"):
            ref = cuda_ista2.fused_ista_dg_plain(tuple(t.float() for t in wts), gw.float(),
                                                 gb.float(), x1.float(), z.float(), 5)
            err = compare(torch, f"K3 ista+Dg depth 5 {MVSEC_ISTA}", dtype,
                          cuda_ista2.fused_ista_dg(wts, gw, gb, x1, z, 5), ref,
                          f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 8))
            ms = time_ms(torch, lambda: cuda_ista2.fused_ista_dg(wts, gw, gb, x1, z, 5))
            plain = time_ms(torch, lambda: cuda_ista2.fused_ista_dg_plain(wts, gw, gb, x1, z, 5))
        nbytes = (x1.numel() * 2 + z.numel() * 2 + sum(t.numel() for t in wts) + gw.numel()
                  + gb.numel()) * es
        ops = 11 * 2 * 9 * (2 * c) * c * b * hh * ww
        bms, by = bound(nbytes, ops, dtype)
        print(f"  K3 depth 5 {MVSEC_ISTA} {dtype}: {ms:.4f} ms (plain {plain:.4f}, bound "
              f"{bms:.4f} by {by}; {ops / ms * 1e-9:.1f} TFLOP/s)")
        rows["K3"].append(dict(shape=list(MVSEC_ISTA), dtype=dtype, path="mvsec", max_abs_err=err,
                               ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None))
        for shapes, tag in ((MVSEC_NORM, "mvsec"), (CHAIRS2_NORM, "chairs2")):
            for shape in shapes:
                x = (randn(*shape) * 2.0 + 0.5).to(dt)
                ref = cuda_norm.instance_norm_plain(x.float())
                err = compare(torch, f"K4 norm {shape}", dtype, cuda_norm.instance_norm_fused(x),
                              ref, 2e-5 if dtype == "float32" else bf16_tol(ref, 2))
                ms = time_ms(torch, lambda: cuda_norm.instance_norm_fused(x))
                plain = time_ms(torch, lambda: cuda_norm.instance_norm_plain(x))
                lib = time_ms(torch, lambda: F.instance_norm(x))
                bms, by = bound(2 * x.numel() * es, 6 * x.numel(), "float32")
                print(f"  K4 {shape} {dtype}: {ms:.4f} ms (plain {plain:.4f}, F.instance_norm "
                      f"{lib:.4f}, bound {bms:.4f}; rule "
                      f"{cuda_norm.launch_rule(shape[2] * shape[3], es)})")
                rows["K4"].append(dict(shape=list(shape), dtype=dtype, path=tag, max_abs_err=err,
                                       ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                       library_ms=lib))
                del x, ref
        for shapes, tag in ((MVSEC_CONV, "mvsec"), (CHAIRS2_CONV, "chairs2")):
            for shape, mode in shapes:
                c = shape[1]
                x = randn(*shape).to(dt)
                wk = randn(c, c, 3, 3, scale=(9 * c) ** -0.5).to(dt)
                bk = randn(c, scale=0.1).to(dt)
                relu = mode == "reflect"           # the upsamp conv's relu is fused
                with cudnn_fp32_scope(torch, "float32"):
                    ref = cuda_conv.conv3x3_plain(x.float(), wk.float(), bk.float(), mode, relu)
                    err = compare(torch, f"K5 conv3x3 {shape} {mode}", dtype,
                                  cuda_conv.conv3x3(x, wk, bk, mode, relu), ref,
                                  f32_tol(ref) if dtype == "float32" else bf16_tol(ref, 2))
                    ms = time_ms(torch, lambda: cuda_conv.conv3x3(x, wk, bk, mode, relu))
                    lib = time_ms(torch, lambda: cuda_conv.conv3x3_plain(x, wk, bk, mode, relu))
                ops = 2 * 9 * c * c * shape[0] * shape[2] * shape[3]
                bms, by = bound((2 * x.numel() + wk.numel() + bk.numel()) * es, ops, dtype)
                print(f"  K5 {shape} {mode} {dtype}: {ms:.4f} ms (F.conv2d {lib:.4f}, bound "
                      f"{bms:.4f} by {by}; {ops / ms * 1e-9:.1f} TFLOP/s)")
                rows["K5"].append(dict(shape=list(shape), dtype=dtype, path=tag, max_abs_err=err,
                                       ms=ms, plain_ms=lib, bound_ms=bms, bound_by=by,
                                       library_ms=lib))
                del x, ref
    return rows


# phase 15: MVSEC. The simulated indoor_flying4 recording at DAVIS346's
# 260x346 holds ~43k events a frame pair; windows of 20000 events give items
# of 1 or 2 windows (item 0: 1) and keep each voxel near the anchor's
# training regime (one voxel a frame interval): f32 on the CPU averages
# 22.98 dB, SSIM 0.786 over 10 items' 7 scored frames; at 15000 events (2-3
# windows) 21.77 dB, below the gate's floor
MVSEC_SPLIT = "indoor_flying4"
MVSEC_REAL = 12                      # simulated frames: items 0..9 are backed
MVSEC_ITEMS = 10                     # items of the runs on the card
MVSEC_CPU_ITEMS = 6                  # items of the card-against-CPU commands: 3 scored rows
MVSEC_EVENTS = 20000
MVSEC_BF16_DEV = {"psnr": 0.05, "ssim": 0.002}   # |bf16 - f32| of the mean, each bf16 run


def read_all_csv(path: Path) -> list:
    import csv
    with open(path, newline="") as f:
        return list(csv.reader(f, delimiter="\t"))


MVSEC_NATIVE_SPLIT = []             # phase 15 (d)'s host split, for phase 16 (a)


def mvsec_run(repo: Path, counters: dict, run: str, dtype: str, items: int,
              voxelize=None) -> tuple:
    """``test_mvsec.evaluate`` in this process on phase 15's recording
    under cista-eiflow (6,5), ``items`` items, with the launches of every
    window checked (``window_launches``) and the host split per item,
    its HDF5 reads and GT flow (``timed_calls``) split out of 'chunking'.
    ``voxelize`` (a pair of the voxel and normalise functions) replaces the
    MVSEC dataset's. Returns (mean, split, rows, launches)."""
    import contextlib
    import io as _io

    from cista_flow_torch import test_mvsec
    from cista_flow_torch.config import Config
    from cista_flow_torch.data import hdf5, mvsec
    from cista_flow_torch.timing import HostSplit

    root = repo / "build" / "mvsec_data"
    cfg = Config(image_dim=MVSEC_HW, model_mode="cista-eiflow", depth=5, flow_iters=6,
                 dtype=dtype, path_to_test_model=str(repo / "gate" / "flagship_sim40_f16.npz"),
                 path_to_test_data=str(root), num_events=MVSEC_EVENTS, test_img_num=items,
                 output_folder=str(root / "out" / run.replace(" ", "_")))
    targets = [(hdf5.Dataset, "__getitem__", "hdf5"),
               (mvsec, "generate_corresponding_gt_flow", "gt_flow")]
    saved = (mvsec.events_to_voxel_grid, mvsec.event_preprocess)
    split, reads = HostSplit(), {}
    t1 = time.perf_counter()
    try:
        if voxelize is not None:
            mvsec.events_to_voxel_grid, mvsec.event_preprocess = voxelize
        with recorded_windows() as lengths, contextlib.redirect_stdout(_io.StringIO()), \
                timed_calls(reads, targets):
            (rows, keys, mean), got = counted(
                counters, lambda: test_mvsec.evaluate(cfg, device="cuda", split=split))
    finally:
        mvsec.events_to_voxel_grid, mvsec.event_preprocess = saved
    secs = time.perf_counter() - t1
    split.seconds["chunking"] -= sum(reads.values())
    split.seconds = {**reads, **split.seconds}
    want = {}
    for n in lengths:
        for key, v in window_launches("cista-eiflow", 6, n).items():
            want[key] = want.get(key, 0) + v
    expect_launches(f"test_mvsec {run} ({secs:.1f} s): {len(lengths)} calls of "
                    f"{lengths} windows", got, want)
    return mean, split, rows, got


def mvsec_eval(torch, repo: Path, counters: dict) -> dict:
    """Phase 15: MVSEC. (a) ``data.sim.write_mvsec_hdf5`` writes
    indoor_flying4 at 260x346 (``MVSEC_REAL`` simulated frames) into the
    ignored ``build/mvsec_data`` through the port's HDF5 writer; the port's
    reader gives back a frame pair's events and a frame as written, bit for
    bit. (b) ``python -m cista_flow_torch.test_mvsec`` as a command under
    cista-eiflow (6,5) from the sim40 anchor, ``--image_dim 260 346
    --num_events 20000``, f32 on the card against the same command with
    ``--device cpu``, both started at once, over ``MVSEC_CPU_ITEMS`` items:
    ``all.csv`` equal in its names and frame counts, every metric within
    1e-4 (one step of its 4-decimal rounding); then ``test_mvsec.evaluate`` in this process over
    ``MVSEC_ITEMS`` items in f32 with the launches of every window
    (``window_launches``); (c) the same in bf16, twice: each run's mean
    PSNR and SSIM within ``MVSEC_BF16_DEV`` of f32's and above the gate's
    floors; (d) windows/s and the host split per window (HDF5 reads and the
    GT flow, timed by ``timed_calls``, the rest of an item ('chunking'),
    voxelization, the device call, metrics, FWL, writers) of the second bf16
    run; (e) ``python -m cista_flow_torch.evaluate
    --harness_mode mvsec --save_targets`` (its ``main``), then the same run
    held to those targets at 1%, both exit 0."""
    import contextlib
    import io as _io
    import shutil
    import subprocess

    from cista_flow_torch import evaluate
    from cista_flow_torch.data import hdf5
    from cista_flow_torch.data.mvsec import VALID_TIME_INDEX
    from cista_flow_torch.data.sim import simulate_sequence, write_mvsec_hdf5

    root = repo / "build" / "mvsec_data"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data_path, _ = write_mvsec_hdf5(str(root / MVSEC_SPLIT), MVSEC_SPLIT, n_real=MVSEC_REAL,
                                    h=MVSEC_HW[0], w=MVSEC_HW[1], seed=0)
    write_s = time.perf_counter() - t0
    # the arrays as the writer makes them: the simulated events after the
    # split's first valid frame's time, 8 pad events, each frame's first event
    sq = simulate_sequence(0, MVSEC_REAL, *MVSEC_HW)
    shift, k = VALID_TIME_INDEX[MVSEC_SPLIT][0], 4
    ts = np.arange(VALID_TIME_INDEX[MVSEC_SPLIT][1] + 2, dtype=np.float64) / 25.0
    rows = [np.stack([x.astype(np.float64), y.astype(np.float64), t + ts[shift],
                      (2 * p - 1).astype(np.float64)], axis=1) for t, x, y, p in sq["events"]]
    t_last = ts[shift + MVSEC_REAL - 1] + 1e-4
    written = np.concatenate(rows + [np.array([[0.0, 0.0, t_last + 1e-6 * i, 1.0]
                                               for i in range(8)])])
    want_inds = np.searchsorted(written[:, 2], ts, side="left")
    with hdf5.File(data_path) as f:
        inds = f["davis/left/image_raw_event_inds"]
        t1 = time.perf_counter()
        i1, i2 = int(inds[shift + k]), int(inds[shift + k + 1])
        events = f["davis/left/events"][i1:i2]
        frame = f["davis/left/image_raw"][shift + k]
        read_ms = 1e3 * (time.perf_counter() - t1)
        if (inds[()].tobytes() != want_inds.astype(np.int64).tobytes()
                or events.tobytes() != written[i1:i2].tobytes() or frame.tobytes()
                != np.round(sq["frames"][k] * 255).astype(np.uint8).tobytes()
                or f["davis/left/image_raw"][0].any()):
            raise AssertionError("MVSEC: the HDF5 reader gives back other arrays than written")
        n_events = len(f["davis/left/events"])
    size = Path(data_path).stat().st_size / 2 ** 20
    print(f"  (a) {MVSEC_SPLIT} at {MVSEC_HW[0]}x{MVSEC_HW[1]}: {n_events} events, written in "
          f"{write_s:.1f} s ({size:.1f} MiB, contiguous); pair {k}'s {len(events)} events and "
          f"frame read back bit for bit in {read_ms:.2f} ms")

    anchor = repo / "gate" / "flagship_sim40_f16.npz"
    flags = ["--model_mode", "cista-eiflow", "-d", "5", "--flow_iters", "6", "--image_dim",
             *map(str, MVSEC_HW), "--path_to_test_data", str(root), "--path_to_test_model",
             str(anchor), "--num_events", str(MVSEC_EVENTS)]
    csvs, procs = {}, {}
    t1 = time.perf_counter()
    for device in ("cuda", "cpu"):                  # both commands at once
        procs[device] = subprocess.Popen(
            [sys.executable, "-m", "cista_flow_torch.test_mvsec", *flags, "--test_img_num",
             str(MVSEC_CPU_ITEMS), "--is_write_flow", "-o", str(root / f"out_{device}"),
             "--device", device], cwd=repo, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True)
    try:
        for device, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"test_mvsec --device {device}: exit {proc.returncode}\n"
                                     f"{err[-3000:]}")
            csvs[device] = read_all_csv(root / f"out_{device}" / anchor.stem / "all.csv")
            print(f"  (b) python -m cista_flow_torch.test_mvsec --device {device}: done at "
                  f"{time.perf_counter() - t1:.1f} s (both started together); all.csv "
                  f"{csvs[device]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    a, b = csvs["cuda"], csvs["cpu"]
    worst = max(abs(float(u) - float(v)) for ra, rb in zip(a[1:], b[1:])
                for u, v in zip(ra[1:-1], rb[1:-1]))
    same_shape = [[r[0], r[-1]] for r in a] == [[r[0], r[-1]] for r in b] and len(a) == 3
    print(f"      f32 card against the CPU: all.csv's largest difference {worst:.4f} "
          f"(tol 1e-4, one step of its rounding); rows and frame counts "
          f"{'equal' if same_shape else 'DIFFER'}")
    if not same_shape or worst > 1e-4 + 1e-9 or int(a[-1][-1]) < 3:
        raise AssertionError(f"MVSEC all.csv: card {a} against cpu {b}")

    total = {k: 0 for k in counters}
    runs = {}
    for run, dtype in (("f32", "float32"), ("bf16", "bfloat16"), ("bf16 again", "bfloat16")):
        mean, split, rows, got = mvsec_run(repo, counters, run, dtype, MVSEC_ITEMS)
        for key in total:
            total[key] += got[key]
        runs[run] = (mean, split, rows)
    MVSEC_NATIVE_SPLIT.append(runs["bf16 again"][1])
    f32, bf = runs["f32"][0], runs["bf16"][0]
    fl = GATE_FLOORS["cista-eiflow"]
    dev = {k: bf[k] - v for k, v in f32.items()}
    above = bf["psnr"] > fl["psnr"] and bf["ssim"] > fl["ssim"]
    # bf16 against f32 on the same windows: the floors alone leave a fault
    # of a few tenths of a dB unseen
    near = all(abs(runs[r][0][k] - f32[k]) <= tol for r in ("bf16", "bf16 again")
               for k, tol in MVSEC_BF16_DEV.items())
    print(f"  (c) f32 mean over {runs['f32'][2][-1][-1]} frames: "
          + ", ".join(f"{k} {v:.4f}" for k, v in f32.items())
          + "; bf16 - f32: " + ", ".join(f"{k} {v:+.4f}" for k, v in dev.items())
          + f" (tol {MVSEC_BF16_DEV}: {'within' if near else 'OUTSIDE'}); bf16 psnr "
          f"{bf['psnr']:.4f}, ssim {bf['ssim']:.4f} against the floors {fl}: "
          + ("above" if above else "BELOW"))
    if not (above and near):
        raise AssertionError(f"MVSEC bf16: {bf} (again {runs['bf16 again'][0]}) against f32 "
                             f"{f32}, tolerances {MVSEC_BF16_DEV}, floors {fl}")
    split = runs["bf16 again"][1]
    ms = split.per_window_ms()
    print(f"  (d) bf16: {split.windows / sum(split.seconds.values()):.1f} windows/s over the "
          f"loop ({split.windows} windows); host ms per window: "
          + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; largest besides the device call: "
          f"{max((k for k in ms if k != 'device'), key=ms.get)}; on {nvidia_smi()}")

    targets = root / "targets_mvsec.json"
    harness = ["--harness_mode", "mvsec", "--targets", str(targets), *flags,
               "--test_img_num", str(MVSEC_CPU_ITEMS), "-o", str(root / "out_harness")]
    with contextlib.redirect_stdout(_io.StringIO()) as log:
        codes = [evaluate.main(harness + ["--save_targets"]),
                 evaluate.main(harness + ["--harness_tolerance", "0.01"])]
    print(f"  (e) evaluate --harness_mode mvsec: --save_targets exit {codes[0]}, the 1% hold "
          f"exit {codes[1]} ({log.getvalue().strip().splitlines()[-1]})")
    if codes != [0, 0]:
        raise AssertionError(f"evaluate --harness_mode mvsec: exits {codes}")
    return total


# phase 16: the library surface. (a) the host event library at MVSEC's
# window and at the serving CLIs' 15000 events at 180x240; (b) test_mvsec on
# two row bands over phase 15's recording; (c) the modules no path of the
# smoke runs, at serving shapes, against the CPU
HOST_LIB_BUILD = {}                  # the host event library's build, from phase 2
HOST_WINDOWS = ((MVSEC_EVENTS, MVSEC_HW), (15000, (H, W)))
HOST_REPEATS = 5
SURFACE_MVSEC_ITEMS = MVSEC_ITEMS     # 7 scored frames: at 6 items' 3, f32 is 22.59 dB
SURFACE_F32_TOL = 1e-4               # max abs error over the reference's largest magnitude
SURFACE_BF16_TOL = 5e-2              # relative L2 error against the CPU's f32: 8-bit significands over ~20 layers
SMALL_ENCODER_NORMS = 21             # the head's, 3 a bottleneck block, 2 downsamples
GROUP_F32_TOL = 1e-5                 # (d): max abs error over the CPU output's largest magnitude
GROUP_BF16_TOL = 3e-2                # (d): relative L2 against the CPU's f32 (CPU bf16: 8.5e-3
#                                      BasicEncoder, 1.9e-2 SmallEncoder; SmallEncoder's ~3e-2)
# (d): K5 launches a call: BasicEncoder's layer1 (4 convs 64->64), layer3's second
# conv and its second block's two (128->128); SmallEncoder's 3x3 convs are 8-24 wide
GROUP_K5 = {"BasicEncoder": 7, "SmallEncoder": 0}


def host_event_library(repo: Path, counters: dict) -> dict:
    """Phase 16 (a): the host event library built from the port's source
    on this machine (phase 2 built it): ``voxelize_events`` in both event
    orders bit for bit ``events_to_voxel_grid_numpy``, ``preprocess_std``
    within rtol 1e-5 / atol 1e-6 of ``event_preprocess_numpy`` (f64 against
    pairwise f32 sums), ``voxelize_triangular`` within the same of
    ``mvsec_utils.events_to_voxel_triangular`` (and whether bit for bit);
    host ms per window of each, median of ``HOST_REPEATS``; then phase 15
    (d)'s host split (bf16, ``MVSEC_ITEMS`` items) on the library and on
    numpy in this call."""
    from cista_flow_torch.data import mvsec_utils
    from cista_flow_torch.events import native, voxel

    def median_ms(fn):
        ts = []
        for _ in range(HOST_REPEATS):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(ts)

    print(f"  (a) host event library {native.so_path().name}: {HOST_LIB_BUILD}")
    rng = np.random.default_rng(16)
    for n, (h, w) in HOST_WINDOWS:
        e = np.stack([np.sort(rng.random(n)), rng.integers(0, w, n), rng.integers(0, h, n),
                      rng.integers(0, 2, n)], axis=1).astype(np.float64)
        for rev in (False, True):
            a = voxel.events_to_voxel_grid(e, 5, w, h, rev)
            if a.tobytes() != voxel.events_to_voxel_grid_numpy(e, 5, w, h, rev).tobytes():
                raise AssertionError(f"host library: voxel of {n} events (reverse {rev}) "
                                     "differs from numpy")
            for hot in (False, True):
                got = voxel.event_preprocess(a.copy(), filter_hot_pixel=hot)
                ref = voxel.event_preprocess_numpy(a.copy(), filter_hot_pixel=hot)
                if not np.allclose(got, ref, rtol=1e-5, atol=1e-6):
                    raise AssertionError(f"host library: preprocess_std (hot {hot}) off by "
                                         f"{np.abs(got - ref).max()}")
        lib = median_ms(lambda: voxel.event_preprocess(voxel.events_to_voxel_grid(e, 5, w, h),
                                                       filter_hot_pixel=True))
        plain = median_ms(lambda: voxel.event_preprocess_numpy(
            voxel.events_to_voxel_grid_numpy(e, 5, w, h), filter_hot_pixel=True))
        exytp = np.stack([e[:, 1], e[:, 2], e[:, 0], 2 * e[:, 3] - 1], axis=1)
        tri = native.voxelize_triangular(exytp, 5, h, w)
        tri_ref = mvsec_utils.events_to_voxel_triangular(exytp, 5, h, w)
        if not np.allclose(tri, tri_ref, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"host library: triangular voxel off by "
                                 f"{np.abs(tri - tri_ref).max()}")
        tri_lib = median_ms(lambda: native.voxelize_triangular(exytp, 5, h, w))
        tri_plain = median_ms(lambda: mvsec_utils.events_to_voxel_triangular(exytp, 5, h, w))
        print(f"      {n} events at {h}x{w}: voxels bit for bit numpy's in both orders, "
              f"preprocess_std within rtol 1e-5 / atol 1e-6; host ms per window (voxel + "
              f"normalise) library {lib:.3f}, numpy {plain:.3f} ({plain / lib:.1f}x); "
              f"triangular {'bit for bit' if tri.tobytes() == tri_ref.tobytes() else 'max abs ' + format(float(np.abs(tri - tri_ref).max()), '.2e')}, "
              f"library {tri_lib:.3f} ms, numpy {tri_plain:.3f} ms")
    runs, total = {}, {k: 0 for k in counters}
    for run, vox in (("bf16 library", None),
                     ("bf16 numpy", (voxel.events_to_voxel_grid_numpy,
                                     voxel.event_preprocess_numpy)),
                     ("bf16 library again", None),
                     ("bf16 numpy again", (voxel.events_to_voxel_grid_numpy,
                                           voxel.event_preprocess_numpy))):
        _, runs[run], _, got = mvsec_run(repo, counters, run, "bfloat16", MVSEC_ITEMS, vox)
        for k in total:
            total[k] += got[k]
    if MVSEC_NATIVE_SPLIT:
        runs["phase 15 (d), library"] = MVSEC_NATIVE_SPLIT[0]
    for run, split in runs.items():
        ms = split.per_window_ms()
        print(f"      MVSEC host split, {run}: {split.windows / sum(split.seconds.values()):.1f} "
              f"windows/s; host ms per window " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return total


def sharded_mvsec(torch, repo: Path, counters: dict) -> dict:
    """Phase 16 (b): ``test_mvsec --mesh_shape 2 --mesh_axes spatial``'s
    body (``parallel.check.mvsec_rank``, as ``spatial.serve`` runs it) on
    two gloo ranks sharing cuda:0, phase 15's recording, cista-eiflow
    (6,5), ``SURFACE_MVSEC_ITEMS`` items, f32 and bf16: f32's ``all.csv``
    within 1e-4 (one step of its rounding) of one process's on the card
    (phase 15's f32 run in this call, the same run here without it),
    bf16 above the gate's floors and within ``MVSEC_BF16_DEV`` of f32;
    each rank's launches ``rank_launches`` (K2 counted as K2b)."""
    from cista_flow_torch import test_mvsec
    from cista_flow_torch.config import Config
    from cista_flow_torch.parallel import check

    root = repo / "build" / "mvsec_data"
    anchor = repo / "gate" / "flagship_sim40_f16.npz"
    total = {k: 0 for k in counters}
    total["K2b"] = 0

    def cfg(dtype, out, **mesh):
        return Config(image_dim=MVSEC_HW, model_mode="cista-eiflow", depth=5, flow_iters=6,
                      dtype=dtype, path_to_test_model=str(anchor), path_to_test_data=str(root),
                      num_events=MVSEC_EVENTS, test_img_num=SURFACE_MVSEC_ITEMS,
                      output_folder=str(root / out), **mesh)
    one_csv = root / "out" / "f32" / anchor.stem / "all.csv"
    if not MVSEC_NATIVE_SPLIT:                  # phase 15 did not run in this call
        one_csv = root / "one_f32" / anchor.stem / "all.csv"
        _, got = counted(counters, lambda: test_mvsec.evaluate(cfg("float32", "one_f32"),
                                                                device="cuda"))
        for k in counters:
            total[k] += got[k]
    dtypes = ("float32", "bfloat16")
    t0 = time.perf_counter()
    ranks = check.run(check.mvsec_rank, 2, "cuda:0",
                      [dict(cfg=cfg(d, f"ranks_{d}", mesh_shape="2", mesh_axes="spatial"))
                       for d in dtypes], str(root / "ranks_out"), backend="gloo")
    print(f"  (b) test_mvsec on two ranks sharing cuda:0 over gloo: {len(dtypes)} runs of "
          f"{SURFACE_MVSEC_ITEMS} items in {time.perf_counter() - t0:.1f} s")
    means = {}
    for dtype, r0, r1 in zip(dtypes, *ranks):
        rows, _, means[dtype] = r0["out"]
        if r1["out"] is not None:
            raise AssertionError("test_mvsec on ranks: rank 1 returned a result")
        for r, res in enumerate((r0, r1)):
            expect_launches(f"(b) test_mvsec {dtype}, rank {r} ({r0['windows']} windows)",
                            res["launches"],
                            rank_launches("cista-eiflow", 6, r0["windows"], True))
            for k, n in res["launches"].items():
                total["K2b" if k == "K2" else k] += n
        sent = {k: sum(res["sent"][k] for res in (r0, r1)) / 2 / r0["windows"] / 1e6
                for k in r0["sent"]}
        print(f"      {dtype}: mean " + ", ".join(f"{k} {v:.4f}" for k, v in means[dtype].items())
              + "; MB sent per rank and window " + ", ".join(f"{k} {v:.3f}"
                                                            for k, v in sent.items()))
    a = read_all_csv(root / "ranks_float32" / anchor.stem / "all.csv")
    b = read_all_csv(one_csv)
    worst = max(abs(float(u) - float(v)) for ra, rb in zip(a[1:], b[1:])
                for u, v in zip(ra[1:-1], rb[1:-1]))
    same = [[r[0], r[-1]] for r in a] == [[r[0], r[-1]] for r in b] and len(a) == 3
    print(f"      f32 all.csv on two ranks against one process ({one_csv.relative_to(root)}): "
          f"largest difference {worst:.4f} (tol 1e-4); rows and frame counts "
          f"{'equal' if same else 'DIFFER'}")
    if not same or worst > 1e-4 + 1e-9:
        raise AssertionError(f"test_mvsec on two ranks: all.csv {a} against one process {b}")
    f32, bf = means["float32"], means["bfloat16"]
    fl = GATE_FLOORS["cista-eiflow"]
    near = all(abs(bf[k] - f32[k]) <= tol for k, tol in MVSEC_BF16_DEV.items())
    above = bf["psnr"] > fl["psnr"] and bf["ssim"] > fl["ssim"]
    print(f"      bf16 - f32 on two ranks: " + ", ".join(f"{k} {bf[k] - f32[k]:+.4f}" for k in f32)
          + f" (tol {MVSEC_BF16_DEV}: {'within' if near else 'OUTSIDE'}); against the floors "
          f"{fl}: {'above' if above else 'BELOW'}")
    if not (near and above):
        raise AssertionError(f"test_mvsec on two ranks, bf16 {bf} against f32 {f32}")
    return total


def surface_error(dtype: str, got, ref) -> tuple:
    """(error, tolerance, name): f32 the max abs error over the
    reference's largest magnitude, bf16 the relative L2 error."""
    got, ref = got.detach().float().cpu(), ref.detach().float()
    if dtype == "float32":
        return float((got - ref).abs().max() / ref.abs().max()), SURFACE_F32_TOL, "max abs / max"
    return float((got - ref).norm() / ref.norm()), SURFACE_BF16_TOL, "relative L2"


def surface_modules(torch, counters: dict) -> dict:
    """Phase 16 (c): the modules of the JAX package's library surface that
    no path of the smoke runs, seeded weights, on the card in f32 (cuDNN's
    TF32 off) and bf16 against the same module on the CPU in f32
    (``surface_error``): ``SmallEncoder`` with instance norm at 180x240,
    batch 8 (K4 ``SMALL_ENCODER_NORMS`` a call), ``SmallUpdateBlock`` at
    its 1/8 frame, ``lookup_efficient_corr`` at batch 8 on a 24x32 frame
    (n = 6144 samples) also against ``build_corr_pyramid`` + K1's lookup
    without ``proj=`` on the card, and each cell variant at CISTA's 64
    channels and 90x120 (its 64->64 3x3 convs K5)."""
    import copy

    from cista_flow_torch.nn import encoders, gru, layers
    from cista_flow_torch.ops import corr, cuda_corr

    total = {k: 0 for k in counters}
    torch.manual_seed(16)
    g = torch.Generator().manual_seed(16)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g)

    b = BATCH
    x_img = rand(b, 3, H, W)
    enc = encoders.SmallEncoder(3, 128, "instance").eval()
    upd = gru.SmallUpdateBlock(324, 96).eval()
    net, inp = rand(b, 96, 23, 30).tanh(), rand(b, 64, 23, 30).relu()
    cor, emap, flow = rand(b, 324, 23, 30), rand(b, 128, 23, 30), rand(b, 2, 23, 30, scale=3)
    f1, f2 = rand(b, 256, 24, 32), rand(b, 256, 24, 32)
    coords = corr.coords_grid(b, 24, 32) + rand(b, 2, 24, 32, scale=4)
    x64, hc = rand(b, 64, 90, 120), (rand(b, 64, 90, 120), rand(b, 64, 90, 120))
    x_up, hc_up = rand(b, 64, 45, 60), (rand(b, 64, 90, 120), rand(b, 64, 90, 120))
    u, lam = rand(1, 64, 1, 1), rand(1, 64, 1, 1).abs()
    rconv = layers.RecurrentConvLayer(64, 64, activation="relu")
    rup = layers.RecurrentUpsampleConvLayer(64, 64, "relu")
    gates = layers.DecayGates(64, 192, 3)
    neuron = layers.NeuronLSTC(64, 64)
    cases = {                 # name -> (module or None, fn(module, *inputs), inputs, launches)
        "SmallEncoder instance 180x240": (enc, lambda m, x: m(x), (x_img,),
                                          {"K4": SMALL_ENCODER_NORMS}),
        "SmallUpdateBlock": (upd, lambda m, *a: m(*a)[2], (net, inp, cor, emap, flow), {}),
        "lookup_efficient_corr n=6144": (None, lambda m, a, c, xy: corr.lookup_efficient_corr(
            corr.build_efficient_corr(a, c), xy), (f1, f2, coords), {}),
        "doubletanh": (None, lambda m, *a: layers.doubletanh(*a), (x64, u, lam), {}),
        "RecurrentConvLayer": (rconv, lambda m, x, h, c: torch.cat(m(x, (h, c))[1], 1),
                               (x64, *hc), {"K5": 1}),
        "RecurrentUpsampleConvLayer": (rup, lambda m, x, h, c: torch.cat(m(x, (h, c))[1], 1),
                                       (x_up, *hc_up), {"K5": 1}),
        "DecayGates": (gates, lambda m, x, y: m(x, y), (x64, rand(b, 192, 90, 120)), {}),
        "NeuronLSTC": (neuron, lambda m, x, z: m(x, z), (x64, hc[0]), {"K5": 1}),
    }
    with torch.no_grad():
        refs = {name: fn(m, *inputs) for name, (m, fn, inputs, _) in cases.items()}
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            for name, (m, fn, inputs, want) in cases.items():
                md = None if m is None else copy.deepcopy(m).to("cuda", dt)
                # coordinates stay f32, as the flow nets keep them
                args = [a.to("cuda") if a is coords else a.to("cuda", dt) for a in inputs]
                with cudnn_fp32_scope(torch, dtype):
                    out, got = counted(counters, lambda: fn(md, *args))
                    torch.cuda.synchronize()
                err, tol, kind = surface_error(dtype, out, refs[name])
                expect_launches(f"(c) {name} {dtype}: {kind} against the CPU {err:.2e} "
                                f"(tol {tol:.0e})", got, want)
                if not np.isfinite(err) or err > tol:
                    raise AssertionError(f"(c) {name} {dtype}: {err} against the CPU")
                for k in total:
                    total[k] += got[k]
            # the on-the-fly correlation against the volume and K1 on the card
            a, c = f1.to("cuda", dt), f2.to("cuda", dt)
            xy = coords.to("cuda")
            eff = corr.lookup_efficient_corr(corr.build_efficient_corr(a, c), xy)
            vol, got = counted(counters, lambda: cuda_corr.lookup(corr.build_corr_pyramid(a, c),
                                                                   xy))
            torch.cuda.synchronize()
            err, tol, kind = surface_error(dtype, vol, eff.cpu())
            expect_launches(f"(c) lookup_efficient_corr {dtype} against build_corr_pyramid + K1 "
                            f"on the card: {kind} {err:.2e} (tol {tol:.0e})", got, {"K1": 1})
            if not np.isfinite(err) or err > tol:
                raise AssertionError(f"(c) efficient corr {dtype}: {err} against K1's lookup")
            for k in total:
                total[k] += got[k]
    return total


def event_ms(torch, fn, calls: int = 10) -> float:
    """Ms per call between two CUDA events around ``calls`` back-to-back
    calls after a warm-up: the card's span, gaps between launches included.
    Phase 16 runs after phase 12, whose profiler traces then lose kernel
    records (``profile_kernels.device_ms`` would refuse them)."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / calls


def group_norm_encoders(torch, counters: dict) -> dict:
    """Phase 16 (d): ``BasicEncoder(3, 256, "group")`` and
    ``SmallEncoder(3, 128, "group")``, seeded weights (the group norms'
    affine drawn too), at 180x240, batch 8, on the card in f32 (cuDNN's
    TF32 off) and bf16 against the same module on the CPU in f32: f32 to
    ``GROUP_F32_TOL`` of the output's largest magnitude, bf16 to
    ``GROUP_BF16_TOL`` relative L2; K5's launches a call (``GROUP_K5``; no
    other kernel: group norm is plain PyTorch); event ms a call."""
    import copy

    from cista_flow_torch.nn import encoders

    total = {k: 0 for k in counters}
    torch.manual_seed(16)
    g = torch.Generator().manual_seed(17)
    x = torch.randn(BATCH, 3, H, W, generator=g)
    for enc in (encoders.BasicEncoder(3, 256, "group"), encoders.SmallEncoder(3, 128, "group")):
        name = type(enc).__name__
        with torch.no_grad():
            for m in enc.modules():
                if isinstance(m, torch.nn.GroupNorm):
                    m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
                    m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g))
            ref = enc.eval()(x)
            for dtype in ("float32", "bfloat16"):
                dt = getattr(torch, dtype)
                md, xd = copy.deepcopy(enc).to("cuda", dt), x.to("cuda", dt)
                with cudnn_fp32_scope(torch, dtype):
                    out, got = counted(counters, lambda: md(xd))
                    torch.cuda.synchronize()
                    ms = event_ms(torch, lambda: md(xd))
                out = out.float().cpu()
                if dtype == "float32":
                    err, tol, kind = (float((out - ref).abs().max() / ref.abs().max()),
                                      GROUP_F32_TOL, "max abs / max")
                else:
                    err, tol, kind = (float((out - ref).norm() / ref.norm()), GROUP_BF16_TOL,
                                      "relative L2")
                expect_launches(f"(d) {name} group {dtype} {H}x{W} batch {BATCH}: {kind} against "
                                f"the CPU {err:.2e} (tol {tol:.0e}), {ms:.3f} event ms a call",
                                got, {"K5": GROUP_K5[name]})
                if not np.isfinite(err) or err > tol:
                    raise AssertionError(f"(d) {name} group {dtype}: {err} against the CPU")
                for k in total:
                    total[k] += got[k]
    return total


def trainer_cli(torch, repo: Path, counters: dict) -> dict:
    """Phase 16 (e): the JAX trainer's command line on the card:
    ``train.main`` (``python -m cista_flow_torch.train``'s body) in this
    process, from a work directory under ``build/``, with no
    ``--model_mode`` (so ``cista-lstc`` at full width), ``--is_SummaryWriter``
    and ``--no_shuffle``, for one epoch of a tiny simulated set at 180x240:
    exit 0, the ``cista-lstc`` checkpoint of epoch 1, the no-tensorboard
    message where tensorboard is missing (else its log directory), and K3
    and K5 launched."""
    import contextlib
    import importlib.util
    import io
    import shutil

    from cista_flow_torch import train
    from cista_flow_torch.data.sim import write_train_dataset

    work = repo / "build" / "trainer_cli"
    shutil.rmtree(work, ignore_errors=True)
    write_train_dataset(str(work / "data"), 2, 4, H, W, seed=0)
    argv = ["--path_to_train_data", str(work / "data"), "--path_to_model", str(work / "models"),
            "-s", "3", "--batch_size", "2", "--epochs", "1", "--is_SummaryWriter", "--no_shuffle"]
    cfgs, device = train.parse_args(argv)
    if (cfgs.model_mode, cfgs.shuffle, device) != ("cista-lstc", True, "cuda"):
        raise AssertionError(f"(e) parsed {cfgs.model_mode}, shuffle {cfgs.shuffle}, {device}")
    log, cwd, t0 = io.StringIO(), os.getcwd(), time.perf_counter()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(log):
            rc, got = counted(counters, lambda: train.main(argv))
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    secs = time.perf_counter() - t0
    out = log.getvalue()
    name = train.model_name_from_cfg(cfgs)
    saved = sorted(os.listdir(work / "models" / name))
    has_tb = importlib.util.find_spec("tensorboard") is not None
    said = "tensorboard unavailable; scalar logging disabled" in out
    logged = (work / "summary" / name).is_dir()
    print("\n".join(f"      | {line}" for line in out.splitlines()[-4:]))
    print(f"  (e) train with no --model_mode ({name}), --is_SummaryWriter --no_shuffle: exit {rc}"
          f", {secs:.1f} s, saved {saved}, tensorboard {'present' if has_tb else 'missing'}: "
          f"{'log directory written' if logged else 'message printed' if said else 'NOTHING'}; "
          f"launches {got}")
    if rc != 0 or name != "cista-lstc_b5_d5_c64" or saved != [f"{name}_1.pth.tar"] \
            or (logged if not has_tb else not logged) or said == has_tb \
            or "Train Epoch: 1" not in out or not (got["K3"] > 0 and got["K5"] > 0):
        raise AssertionError(f"(e) the trainer's command line on the card: {out[-2000:]}")
    return got


def library_surface(torch, repo: Path, counters: dict) -> dict:
    """Phase 16: the host event library, ``test_mvsec`` on row bands, the
    library surface, the group-norm encoders and the trainer's command line
    (``host_event_library``, ``sharded_mvsec``, ``surface_modules``,
    ``group_norm_encoders``, ``trainer_cli``). Writes phase 15's recording
    first when phase 15 did not run."""
    from cista_flow_torch.data.sim import write_mvsec_hdf5

    root = repo / "build" / "mvsec_data"
    if not (root / MVSEC_SPLIT / f"{MVSEC_SPLIT}_data.hdf5").exists():
        write_mvsec_hdf5(str(root / MVSEC_SPLIT), MVSEC_SPLIT, n_real=MVSEC_REAL,
                         h=MVSEC_HW[0], w=MVSEC_HW[1], seed=0)
    total = {k: 0 for k in (*counters, "K2b")}
    t0 = time.perf_counter()
    for k, n in host_event_library(repo, counters).items():
        total[k] += n
    t1 = time.perf_counter()
    print(f"  (a): {t1 - t0:.1f} s")
    for tag, part in (("b", sharded_mvsec), ("c", surface_modules), ("d", group_norm_encoders),
                      ("e", trainer_cli)):
        got = part(torch, repo, counters) if tag in "be" else part(torch, counters)
        for k, n in got.items():
            total[k] += n
        t2 = time.perf_counter()
        print(f"  ({tag}): {t2 - t1:.1f} s")
        t1 = t2
    return total


def cudnn_fp32_scope(torch, dtype: str):
    import contextlib

    from cista_flow_torch.device import cudnn_fp32
    return cudnn_fp32() if dtype == "float32" else contextlib.nullcontext()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
