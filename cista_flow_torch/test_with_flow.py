"""The with-flow eval: reconstruction and flow metrics against GT.

    python -m cista_flow_torch.test_with_flow --model_mode cista-eiflow \\
        --path_to_test_data DATA --test_data_mode upsampled \\
        --path_to_test_model M.npz [--is_gt_flow] [--is_write_flow] \\
        [--dtype bfloat16] [--device cpu]

Counterpart of the root ``test_with_flow.py`` of the JAX package (ref:
test_with_flow.py:24-233), with the same flags (``config.add_args``): each
sequence folder under ``--path_to_test_data`` is read pack by pack (one GT
frame interval, its voxel and its GT flow), each pack runs as one
``step_window`` of the closed loop (its warps following the GT flow under
``--is_gt_flow``), and its last step is scored against the next GT frame
and the GT flow: mse, PSNR, SSIM, photometric loss, EPE, >1/3/5 px rates,
out%, and LPIPS where ``CISTA_LPIPS`` (or ``CISTA_LPIPS_ALEX``,
``CISTA_LPIPS_VGG``) names a weights file, as the JAX CLI reads it. The
first 3 frames of a sequence are not scored. Writes
``frame_%010d.png`` per step (``--no_write_image`` turns them and
``result.csv`` off), ``flow/flow_%010d.png`` under ``--is_write_flow``, and
``all.csv``: per sequence the means rounded to 4 places, then the mean
over sequences, under ``--output_folder/<model name>/``.

The model runs on the card unless ``--device cpu`` is given. The metrics
run on the CPU in f32 on the host copies of the outputs, as the JAX eval
scores host arrays, so neither TF32 nor the kernels reach the scoring.
"""
from __future__ import annotations

import argparse
import csv
import os
import sys

import numpy as np
import torch

from . import config
from .data.io import EvalWriter, FlowWriter, ImageWriter
from .data.readers import ImageReader
from .losses import flow_evaluate, lpips, recon_evaluate
from .parallel import spatial
from .runner import Reconstructor, discover_sequences
from .timing import HostSplit

SKIP_FRAMES = 3


def host_tensor(a) -> torch.Tensor:
    """A host array as an f32 CPU tensor with a leading batch axis."""
    return torch.from_numpy(np.asarray(a, np.float32))[None]


def score(rec, flow_final, gt_prev, gt_next, gt_flow, cfg, lpips_params=None) -> dict:
    """The metrics of one step, from host arrays: rec (H, W), flow_final
    and gt_flow (2, H, W), the GT frames (H, W). On the CPU in f32; LPIPS
    too with ``lpips_params``."""
    t = host_tensor
    target = {"gt_img0": t(gt_prev)[None], "gt_img1": t(gt_next)[None],
              "gt_flow": t(gt_flow)}
    metrics = recon_evaluate(t(rec)[None], target["gt_img1"], lpips_params)
    metrics.update(flow_evaluate(t(flow_final), target, cfg))
    return {k: float(v) for k, v in metrics.items()}


def summarize(name, keys, results, rows, seq_means, eval_writer) -> int:
    """One sequence's row: the per-metric means rounded to 4 places and
    the frame count, printed, kept, and written to its ``result.csv``."""
    mean = np.array(results).mean(0)
    row = [name] + list(np.round(mean, 4)) + [len(results)]
    rows.append(row)
    seq_means.append(mean)
    print(f"\nTest set {name}: Average results for {len(results)} frames: "
          + " ".join(f"{k}: {v:.4f}," for k, v in zip(keys, mean)) + "\n")
    eval_writer(["Dataset"] + keys + ["N_frames"], row)
    return len(results)


def finish(cfg, model_name, keys, rows, seq_means, total):
    """The mean row over sequences and ``all.csv``; returns (rows, keys,
    the unrounded mean as {metric: value})."""
    mean_all = np.array(seq_means).mean(0)
    print(f"\n Average results for {total} frames: "
          + " ".join(f"{k}: {v:.4f}," for k, v in zip(keys, mean_all)) + "\n")
    rows.append(["mean"] + list(np.round(mean_all, 4)) + [total])
    if cfg.test_data_name is None:
        out_dir = os.path.join(cfg.output_folder, model_name)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "all.csv"), "a+", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(["Dataset"] + keys + ["N_frames"])
            w.writerows(rows)
    return rows, keys, {k: float(v) for k, v in zip(keys, mean_all)}


def evaluate_sequences(cfg, device=None, split: HostSplit | None = None,
                       recon: Reconstructor | None = None):
    """Returns (rows, keys, mean): a row [name, per-metric means rounded to
    4 places, frames] per sequence, then the ``mean`` row; the metric
    names; and the unrounded mean over sequences as {metric: value}.
    ``split`` collects the host clock per item of the loop."""
    split = split if split is not None else HostSplit()
    recon = recon if recon is not None else Reconstructor(cfg, device=device)
    reader = ImageReader(cfg)
    lpips_params = lpips.params_from_env()
    rows, seq_means, keys, total = [], [], None, 0
    for path in discover_sequences(cfg.path_to_test_data):
        name = os.path.basename(path).split(".")[0]
        if cfg.test_data_name is not None and name != cfg.test_data_name:
            continue
        reader.initialize(path, cfg.test_img_num)
        recon.reset()
        image_writer = ImageWriter(cfg, recon.model_name, name)
        eval_writer = EvalWriter(cfg, recon.model_name, name)
        flow_writer = FlowWriter(cfg, recon.model_name, name)
        results = []
        frame_idx = 0
        while not reader.ending:
            with split.reading(reader):
                voxels, frame_pack, gt_frame, flows = \
                    reader.update_event_frame_flow_pack(mode=cfg.test_data_mode)
            n = min(len(voxels), len(frame_pack), len(flows))
            with split("device"):
                rec, flow_final = recon.step_window(voxels[:n], flows[:n],
                                                    use_gt_flow=cfg.is_gt_flow)
            gt_next = frame_pack[n] if n < len(frame_pack) else gt_frame
            with split("metrics"):
                metrics = score(rec, flow_final, frame_pack[n - 1], gt_next, flows[n - 1], cfg,
                                lpips_params)
            with split("writers"):
                image_writer(np.uint8(rec * 255.0), frame_idx + 1)
                flow_writer(flow_final, frame_idx)
            if frame_idx >= SKIP_FRAMES:
                keys = keys or list(metrics)
                results.append([metrics[k] for k in keys])
            frame_idx += 1
            split.windows += 1
        total += summarize(name, keys, results, rows, seq_means, eval_writer)
    return finish(cfg, recon.model_name, keys, rows, seq_means, total)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="with-flow eval of the PyTorch port")
    config.add_args(parser)
    config.add_mesh_args(parser)
    args = parser.parse_args(argv)
    cfg = config.from_args(args)
    world = spatial.serving_ranks(parser, cfg)
    if world is None:
        evaluate_sequences(cfg, device=args.device)
    else:
        spatial.serve(world, args.device, "cista_flow_torch.test_with_flow", "evaluate_sequences", cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
