"""The real-data eval (ECD, HQF): reconstruction metrics and FWL, no GT flow.

    python -m cista_flow_torch.test_wo_flow --model_mode cista-eraft \\
        --path_to_test_data DATA --dataset ECD --num_events 15000 \\
        --path_to_test_model M.npz [--is_write_event] [--is_write_flow] \\
        [--dtype bfloat16] [--device cpu]

Counterpart of the root ``test_wo_flow.py`` of the JAX package (ref:
test_wo_flow.py), with the same flags (``config.add_args``): each sequence
folder (PNG frames, timestamps, events as one ``events.txt``/``.zip``/
``.csv`` stream or per-interval ``.npz`` files) is cut into windows of
about ``--num_events`` events (``ImageReader.update_event_frame_pack_fix``;
one GT frame may span several reconstructions), each window runs as one
``step_window``, and its last step is scored against the GT frame (ECD's
normalised to its 0th-100th percentiles): mse, PSNR, SSIM (and LPIPS
with ``CISTA_LPIPS``, as in ``test_with_flow``), and the flow warp loss FWL
of the last voxel along the last flow. The first 3 windows
are not scored. Outputs as ``test_with_flow``, plus the last voxel's
red-blue preview under ``--is_write_event``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import config
from .data.io import EvalWriter, EventWriter, FlowWriter, ImageWriter, make_event_preview
from .data.readers import ImageReader
from .losses import fwl_metric, lpips, recon_evaluate
from .parallel import spatial
from .runner import Reconstructor, discover_sequences
from .test_with_flow import SKIP_FRAMES, finish, host_tensor, summarize
from .timing import HostSplit
from .utils import normalize_image


def evaluate_sequences(cfg, device=None, split: HostSplit | None = None,
                       recon: Reconstructor | None = None):
    """Returns (rows, keys, mean), as ``test_with_flow.evaluate_sequences``."""
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
        event_writer = EventWriter(cfg, recon.model_name, name)
        results = []
        frame_idx = 0
        while not reader.ending:
            with split.reading(reader):
                voxels, _, gt_frame = reader.update_event_frame_pack_fix(
                    cfg.num_events, cfg.test_data_mode)
            if voxels:
                with split("device"):
                    rec, flow_final = recon.step_window(voxels)
                evs = voxels[-1]
            with split("metrics"):
                gt = normalize_image(gt_frame, 0, 100) if cfg.dataset == "ECD" else gt_frame
                metrics = recon_evaluate(host_tensor(rec)[None], host_tensor(gt)[None],
                                         lpips_params)
                metrics = {k: float(v) for k, v in metrics.items()}
            with split("fwl"):
                metrics["FWL"] = float(fwl_metric(host_tensor(evs), host_tensor(flow_final)))
            with split("writers"):
                image_writer(np.uint8(rec * 255.0), frame_idx + 1)
                flow_writer(flow_final, frame_idx)
                event_writer(make_event_preview(evs, mode="red-blue"), frame_idx)
            if frame_idx >= SKIP_FRAMES:
                keys = keys or list(metrics)
                results.append([metrics[k] for k in keys])
            frame_idx += 1
            split.windows += 1
        total += summarize(name, keys, results, rows, seq_means, eval_writer)
    return finish(cfg, recon.model_name, keys, rows, seq_means, total)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="real-data eval of the PyTorch port")
    config.add_args(parser)
    config.add_mesh_args(parser)
    args = parser.parse_args(argv)
    cfg = config.from_args(args)
    world = spatial.serving_ranks(parser, cfg)
    if world is None:
        evaluate_sequences(cfg, device=args.device)
    else:
        spatial.serve(world, args.device, "cista_flow_torch.test_wo_flow", "evaluate_sequences", cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
