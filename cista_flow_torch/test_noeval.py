"""Inference without GT (HS-ERGB, raw DVS streams): reconstructions only.

    python -m cista_flow_torch.test_noeval --model_mode cista-eiflow \\
        --path_to_test_data STREAM.txt --num_events 15000 \\
        --path_to_test_model M.npz [--dvs samsung] [--k_shift N] \\
        [--dtype bfloat16] [--device cpu]

Counterpart of the root ``test_noeval.py`` of the JAX package (ref:
test_noeval.py), with the same flags (``config.add_args``): a single-file
stream (``FixedSizeEventReader``: windows of ``--num_events`` events, a
``W H`` header line first, ``--k_shift`` overlap, ``--n_event_skip``
events skipped) or a folder of per-window ``.npz`` files is voxelized on
the host with hot pixels filtered, rotated by 180 degrees under ``--dvs
samsung``, and run in chunks of 8 windows through ``step_window``. The
frames of steps 0, 1, 5, 10, ... are written (with the event preview under
``--is_write_event`` and the flow picture under ``--is_write_flow``). The frame size follows the data:
(180, 320) for a ``240fps`` folder, (480, 640) for ``--dvs samsung``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import config
from .data.io import EventWriter, FlowWriter, ImageWriter, make_event_preview
from .data.readers import STREAM_NAMES, FixedSizeEventReader, SingleEventReaderNpz
from .events import event_preprocess, events_to_voxel_grid
from .parallel import spatial
from .runner import Reconstructor, discover_sequences
from .timing import HostSplit

CHUNK = 8           # windows per step_window: one host transfer each


def stream_reader(path, cfg):
    """The windows of one sequence: a folder's per-window files in order,
    or one stream file."""
    if not os.path.isdir(path):
        return FixedSizeEventReader(path, cfg.num_events, cfg.k_shift, cfg.n_event_skip)
    paths = [os.path.join(root, name) for root, _, files in os.walk(path) for name in files
             if name.split(".")[-1] == "npz" or name in STREAM_NAMES]
    return SingleEventReaderNpz(sorted(paths))


def voxelize(window: np.ndarray, cfg) -> np.ndarray:
    """A window's voxel as the CLI feeds it: hot pixels filtered,
    normalised, turned by 180 degrees under ``--dvs samsung`` (ref:
    test_noeval.py:142-143)."""
    h, w = cfg.image_dim
    voxel = event_preprocess(events_to_voxel_grid(window, cfg.num_bins, w, h),
                             filter_hot_pixel=True)
    return voxel[:, ::-1, ::-1].copy() if cfg.dvs == "samsung" else voxel


def run(cfg, device=None, split: HostSplit | None = None,
        recon: Reconstructor | None = None) -> None:
    split = split if split is not None else HostSplit()
    recon = recon if recon is not None else Reconstructor(cfg, device=device)
    if os.path.isdir(cfg.path_to_test_data):
        sequences = discover_sequences(cfg.path_to_test_data) or [cfg.path_to_test_data]
    else:
        sequences = [cfg.path_to_test_data]
    for path in sequences:
        name = os.path.basename(path).split(".")[0]
        if cfg.test_data_name is not None and name != cfg.test_data_name:
            continue
        print(name)
        windows = stream_reader(path, cfg)
        image_writer = ImageWriter(cfg, recon.model_name, name)
        flow_writer = FlowWriter(cfg, recon.model_name, name)
        event_writer = EventWriter(cfg, recon.model_name, name)
        recon.reset()
        try:
            frame_idx = 0
            done = False
            while not done:
                voxels = []
                while len(voxels) < CHUNK:
                    with split("parse"):
                        window = next(windows, None)
                    if window is None:
                        done = True
                        break
                    with split("voxelize"):
                        voxels.append(voxelize(window, cfg))
                if frame_idx + len(voxels) > cfg.test_img_num + 1:
                    voxels = voxels[:cfg.test_img_num + 1 - frame_idx]
                    done = True
                if not voxels:
                    break
                with split("device"):
                    recs, flows = recon.step_window(voxels, return_all=True)
                with split("writers"):
                    for i, (rec, flow_final, voxel) in enumerate(zip(recs, flows, voxels)):
                        fi = frame_idx + i
                        if fi == 1 or fi % 5 == 0:
                            image_writer(np.uint8(rec * 255.0), fi + 1)
                            event_writer(make_event_preview(voxel, mode="grayscale"), fi)
                            flow_writer(flow_final, fi)
                frame_idx += len(voxels)
                split.windows += len(voxels)
        finally:
            if hasattr(windows, "close"):
                windows.close()


def frame_size(cfg) -> None:
    """The data's frame size (ref: test_noeval.py:184-187)."""
    if cfg.path_to_test_data and cfg.path_to_test_data.rstrip("/").split("/")[-1] == "240fps":
        cfg.image_dim = (180, 320)
    if cfg.dvs == "samsung":
        cfg.image_dim = (480, 640)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="inference without GT, PyTorch port")
    config.add_args(parser)
    config.add_mesh_args(parser)
    args = parser.parse_args(argv)
    cfg = config.from_args(args)
    frame_size(cfg)
    world = spatial.serving_ranks(parser, cfg)
    if world is None:
        run(cfg, device=args.device)
    else:
        spatial.serve(world, args.device, "cista_flow_torch.test_noeval", "run", cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
