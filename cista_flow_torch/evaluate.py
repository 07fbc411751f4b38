"""The with-flow eval: replay sequences through the port and score them.

    python -m cista_flow_torch.evaluate --model_mode cista-eiflow \\
        --path_to_test_data DATA/eval --test_data_mode upsampled \\
        --path_to_test_model gate/flagship_ft1_f16.npz --depth 1 --flow_iters 1 \\
        [--dtype bfloat16] [--device cpu] \\
        [--targets gate/targets_sim_flagship_ft1.json --harness_tolerance 0.002]

Counterpart of the JAX package's ``test_with_flow.evaluate_sequences``
(test_with_flow.py:29-115; ref: test_with_flow.py:24-233) and of
``eval_harness``'s ``mean_metrics`` and ``compare``: each sequence folder
under ``--path_to_test_data`` is read pack by pack (one GT frame interval,
its voxel and its GT flow), each pack runs as one ``step_window`` of the
closed loop, and its last step is scored against the next GT frame and the
GT flow: mse, PSNR, SSIM, photometric loss, EPE, >1/3/5 px rates, out%.
The first 3 frames of a sequence are not scored; the mean row is the mean
over sequences of the per-sequence means, rounded to 4 places as the
committed gate targets were recorded. With ``--targets`` the mean row is
held to the targets at ``--harness_tolerance`` (symmetric relative
deviation, denominators floored at 1e-3); the exit code is 1 if any metric
is off.

The model runs on the card unless ``--device cpu`` is given. The metrics
run on the CPU in f32 on the host copies of the outputs, as the JAX eval
scores host arrays, so neither TF32 nor the kernels reach the scoring.
``result.csv`` per sequence and ``all.csv`` go under
``--output_folder/<model name>/`` (``Config.is_write_image``).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np
import torch

from .config import Config
from .data.readers import ImageReader
from .losses import flow_evaluate, recon_evaluate
from .runner import Reconstructor, discover_sequences

SKIP_FRAMES = 3


def score(rec, flow_final, gt_prev, gt_next, gt_flow, cfg) -> dict:
    """The metrics of one step, from host arrays: rec (H, W), flow_final
    and gt_flow (2, H, W), the GT frames (H, W). On the CPU in f32."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))[None]

    target = {"gt_img0": t(gt_prev)[None], "gt_img1": t(gt_next)[None],
              "gt_flow": t(gt_flow)}
    metrics = recon_evaluate(t(rec)[None], target["gt_img1"])
    metrics.update(flow_evaluate(t(flow_final), target, cfg))
    return {k: float(v) for k, v in metrics.items()}


def _write_rows(path, header, rows):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "a+", newline="") as f:
        w = csv.writer(f, delimiter="\t")
        w.writerow(header)
        w.writerows(rows)


def evaluate_sequences(cfg: Config, device=None):
    """Returns (rows, keys, mean): a row [name, per-metric means rounded to
    4 places, frames] per sequence, then the ``mean`` row; the metric
    names; and the unrounded mean over sequences as {metric: value}."""
    recon = Reconstructor(cfg, device=device)
    reader = ImageReader(cfg)
    rows, seq_means, keys, total = [], [], None, 0
    out_dir = os.path.join(cfg.output_folder, recon.model_name)
    for path in discover_sequences(cfg.path_to_test_data):
        name = os.path.basename(path).split(".")[0]
        if cfg.test_data_name is not None and name != cfg.test_data_name:
            continue
        reader.initialize(path, cfg.test_img_num)
        recon.reset()
        results = []
        frame_idx = 0
        while not reader.ending:
            voxels, frame_pack, gt_frame, flows = \
                reader.update_event_frame_flow_pack(mode=cfg.test_data_mode)
            n = min(len(voxels), len(frame_pack), len(flows))
            rec, flow_final = recon.step_window(voxels[:n])
            gt_next = frame_pack[n] if n < len(frame_pack) else gt_frame
            metrics = score(rec, flow_final, frame_pack[n - 1], gt_next,
                            flows[n - 1], cfg)
            if frame_idx >= SKIP_FRAMES:
                keys = keys or list(metrics)
                results.append([metrics[k] for k in keys])
            frame_idx += 1
        mean = np.array(results).mean(0)
        row = [name] + list(np.round(mean, 4)) + [len(results)]
        rows.append(row)
        seq_means.append(mean)
        total += len(results)
        print(f"Test set {name}: average of {len(results)} frames: "
              + " ".join(f"{k}: {v:.4f}," for k, v in zip(keys, mean)))
        if cfg.is_write_image:
            _write_rows(os.path.join(out_dir, name, "result.csv"),
                        ["Dataset"] + keys + ["N_frames"], [row])
    mean_all = np.array(seq_means).mean(0)
    rows.append(["mean"] + list(np.round(mean_all, 4)) + [total])
    print(f"Average of {total} frames: "
          + " ".join(f"{k}: {v:.4f}," for k, v in zip(keys, mean_all)))
    if cfg.is_write_image and cfg.test_data_name is None:
        _write_rows(os.path.join(out_dir, "all.csv"),
                    ["Dataset"] + keys + ["N_frames"], rows)
    return rows, keys, {k: float(v) for k, v in zip(keys, mean_all)}


def mean_metrics(results, keys) -> dict:
    """The ``mean`` row as {metric: value}."""
    row = results[-1]
    assert row[0] == "mean"
    return {k: float(v) for k, v in zip(keys, row[1:1 + len(keys)])}


def compare(measured: dict, targets: dict, tolerance: float, atol: float = 1e-3):
    """(ok, lines): the symmetric relative deviation of each targeted
    metric, |measured - target| / max(|target|, atol), against
    ``tolerance``; ``atol`` keeps targets of exactly 0 (the outlier rates)
    from making the gate degenerate."""
    lines, ok = [], True
    for k, tv in targets.items():
        if k not in measured:
            lines.append(f"  {k}: target {tv} — MISSING from run")
            ok = False
            continue
        mv = measured[k]
        rel = abs(mv - tv) / max(abs(tv), atol)
        if rel > tolerance:
            ok = False
        lines.append(f"  {k}: measured {mv:.6f} vs target {tv:.6f} "
                     f"(rel dev {rel * 100:.2f}%) {'ok' if rel <= tolerance else 'FAIL'}")
    return ok, lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="with-flow eval of the PyTorch port")
    ap.add_argument("--model_mode", default="cista-eiflow",
                    choices=["cista-eiflow", "cista-eraft", "cista-idnet"])
    ap.add_argument("--image_dim", nargs=2, default=[180, 240], type=int)
    ap.add_argument("--path_to_test_data", required=True)
    ap.add_argument("--test_data_mode", default="real")
    ap.add_argument("--path_to_test_model", default=None)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("-d", "--depth", default=5, type=int)
    ap.add_argument("--flow_iters", default=None, type=int)
    ap.add_argument("-o", "--output_folder", default="test_images")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--targets", default=None, help="targets JSON ({metric: value})")
    ap.add_argument("--harness_tolerance", type=float, default=0.01)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = Config(image_dim=tuple(args.image_dim), model_mode=args.model_mode,
                 depth=args.depth, flow_iters=args.flow_iters, dtype=args.dtype,
                 path_to_test_model=args.path_to_test_model,
                 path_to_test_data=args.path_to_test_data,
                 test_data_mode=args.test_data_mode, output_folder=args.output_folder)
    rows, keys, _ = evaluate_sequences(cfg, device=args.device)
    if args.targets is None:
        return 0
    with open(args.targets) as f:
        targets = json.load(f)
    ok, lines = compare(mean_metrics(rows, keys), targets, args.harness_tolerance)
    print(f"Quality gate (tolerance {args.harness_tolerance * 100:.1f}%):")
    print("\n".join(lines))
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
