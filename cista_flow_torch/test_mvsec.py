"""The MVSEC eval: reconstruction metrics and FWL over MVSEC's HDF5
recordings.

    python -m cista_flow_torch.test_mvsec --model_mode cista-eiflow \\
        --path_to_test_data DATA --image_dim 260 346 --num_events 15000 \\
        --path_to_test_model M.npz [--test_data_name indoor_flying1] \\
        [--dtype bfloat16] [--device cpu] [--mesh_shape 2 --mesh_axes spatial]

Counterpart of the root ``test_mvsec.py`` of the JAX package (ref:
test_mvsec.py:33-157), with the same flags (``config.add_args``): every
folder under ``--path_to_test_data`` holding a ``<split>_data.hdf5`` of a
split of ``data.mvsec.VALID_TIME_INDEX`` is read by ``MVSEC_NE`` through
the port's HDF5 reader. Each frame pair's event chunks are accumulated to
at least 0.8 ``--num_events`` events, each full accumulation voxelized
(``MVSEC_NE.events_to_voxel``), and a pair's completed windows run as one
``step_window`` call (their number varies from pair to pair). A pair that
ends a window is scored against its second GT frame: mse, PSNR, SSIM (and
LPIPS with ``CISTA_LPIPS``), and FWL of the last voxel along the last flow;
the first 3 scored frames are not counted. The reconstruction, stretched to
0..255, and the flow picture are written at the first scored frame and at
every 10th; ``all.csv`` holds each recording's means rounded to 4 places,
then their mean, under ``--output_folder/<model name>/``. The JAX script's
quirks are fixed as it fixes them (its docstring: the GT frame is
``gt_img1``, FWL comes from the losses module).

The model runs on the card unless ``--device cpu`` is given (f32 with
cuDNN's TF32 off, as the runner runs every f32 call); the metrics run on
the CPU in f32 on the host copies of the outputs. ``--mesh_shape N
--mesh_axes spatial`` serves each recording's rows over N ranks, as the
other serving CLIs do (``parallel.spatial.serve``: rank 0 reads, scores
and writes; 260x346 is cut at multiples of 8 rows of the flow net's
288x352 padded frame).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import config
from .data.io import EvalWriter, FlowWriter, ImageWriter
from .data.mvsec import MVSEC_NE, VALID_TIME_INDEX
from .losses import fwl_metric, lpips, recon_evaluate
from .parallel import spatial
from .runner import Reconstructor
from .test_with_flow import SKIP_FRAMES, finish, host_tensor, summarize
from .timing import HostSplit

TEST_DATA_LIST = list(VALID_TIME_INDEX)


def discover_mvsec(cfg):
    """(sequence folders, split names): the folders under
    ``path_to_test_data`` that hold a ``<split>_data.hdf5`` (ref:
    test_mvsec.py:47-68), one folder per split, ``test_data_name`` alone
    when it is set."""
    seq_paths, seq_names = [], []
    for folder_name in sorted(os.listdir(cfg.path_to_test_data)):
        folder = os.path.join(cfg.path_to_test_data, folder_name)
        if not os.path.isdir(folder):
            continue
        for data_file in os.listdir(folder):
            name = data_file.split(".")[0].split("_data")[0]
            if not os.path.isfile(os.path.join(folder, data_file)):
                continue
            if name in TEST_DATA_LIST and name not in seq_names:
                if cfg.test_data_name is None or name == cfg.test_data_name:
                    seq_paths.append(folder)
                    seq_names.append(name)
    return sorted(seq_paths), sorted(seq_names)


def evaluate(cfg, dataset_factory=None, device=None, split: HostSplit | None = None,
             recon: Reconstructor | None = None):
    """Returns (rows, keys, mean), as ``test_with_flow.evaluate_sequences``.
    ``dataset_factory(cfg, folder, split name)`` replaces ``MVSEC_NE``;
    ``split`` collects the host clock per item of the loop: 'chunking' (an
    item of the dataset: its HDF5 reads, the GT flow, the event chunks),
    'voxelize', 'device', 'metrics', 'fwl', 'writers'; its ``windows``
    counts the voxels served."""
    split = split if split is not None else HostSplit()
    recon = recon if recon is not None else Reconstructor(cfg, device=device)
    lpips_params = lpips.params_from_env()
    rows, seq_means, keys, total = [], [], None, 0
    for path, name in zip(*discover_mvsec(cfg)):
        ds = (dataset_factory(cfg, path, name) if dataset_factory is not None
              else MVSEC_NE(cfg, data_root=path, data_split=name))
        recon.reset()
        image_writer = ImageWriter(cfg, recon.model_name, name)
        eval_writer = EvalWriter(cfg, recon.model_name, name)
        flow_writer = FlowWriter(cfg, recon.model_name, name)
        results = []
        frame_idx = 0
        num_events_acc = 0
        events_acc = []
        print("data_length", len(ds))
        for batch_idx in range(min(len(ds), cfg.test_img_num)):
            with split("chunking"):
                raw_events_list, batch_gt = ds[batch_idx]
            rec = flow_final = evs = None
            windows = []
            with split("voxelize"):
                for events, n_e in raw_events_list:
                    num_events_acc += n_e
                    events_acc.append(events)
                    # accumulate to >= 0.8 * num_events (ref: test_mvsec.py:147-160)
                    if cfg.num_events > 0 and num_events_acc < 0.8 * cfg.num_events:
                        continue
                    num_events_acc = 0
                    windows.append(ds.events_to_voxel(np.concatenate(events_acc, axis=0),
                                                      ds.height, ds.width))
                    events_acc = []
            if windows:
                evs = windows[-1]
                with split("device"):
                    rec, flow_final = recon.step_window(windows)
                split.windows += len(windows)
            if num_events_acc != 0 or rec is None:
                continue
            with split("metrics"):
                metrics = recon_evaluate(host_tensor(rec)[None],
                                         host_tensor(batch_gt["gt_img1"][0])[None], lpips_params)
                metrics = {k: float(v) for k, v in metrics.items()}
            with split("fwl"):
                metrics["FWL"] = float(fwl_metric(host_tensor(evs), host_tensor(flow_final)))
            with split("writers"):
                if frame_idx == 0 or (frame_idx + 1) % 10 == 0:
                    rec_u8 = rec - rec.min()
                    image_writer(np.uint8(255 * rec_u8 / max(rec_u8.max(), 1e-8)), frame_idx + 1)
                    flow_writer(flow_final, frame_idx)
            if frame_idx >= SKIP_FRAMES:
                keys = keys or list(metrics)
                results.append([metrics[k] for k in keys])
            frame_idx += 1
        total += summarize(name, keys, results, rows, seq_means, eval_writer)
    return finish(cfg, recon.model_name, keys, rows, seq_means, total)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="MVSEC eval of the PyTorch port")
    config.add_args(parser)
    config.add_mesh_args(parser)
    args = parser.parse_args(argv)
    cfg = config.from_args(args)
    world = spatial.serving_ranks(parser, cfg)
    if world is None:
        evaluate(cfg, device=args.device)
    else:
        spatial.serve(world, args.device, "cista_flow_torch.test_mvsec", "evaluate", cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
