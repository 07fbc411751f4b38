"""The sequence reader of the with-flow eval (host side, numpy).

Counterpart of the JAX package's ``ImageReader`` (cista_flow_tpu/data/
video_readers.py; ref: data_readers/video_readers.py:42-457) for the layout
the simulator writes: PNG frames, ``timestamps.txt``, per-interval event
and flow ``.npz`` files. ``update_event_frame_flow_pack`` pairs one GT frame
interval with its events (one voxel) and its GT flow (``flow10 * -1``
unless ``is_forward_flow``). The single-file event readers (.txt/.zip,
pandas) and the video reader (OpenCV) are not ported.
"""
from __future__ import annotations

import os

import numpy as np

from ..events import event_preprocess, events_to_voxel_grid
from .png import read_png


def read_timestamps_file(path, unit="s"):
    """Two txt formats (name- vs value-first) and unit conversion
    (ref: video_readers.py:10-38)."""
    timestamps = []
    col = 1 if os.path.basename(path) == "timestamps.txt" else 0
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if parts:
                timestamps.append(float(parts[col]))
    t = np.array(timestamps)
    if unit == "us":
        t = t / 1e6
    elif unit == "ns":
        t = t / 1e9
    return list(t)


class SingleEventReaderNpz:
    """Per-interval .npz (t, x, y, p) windows for simulated sequences
    (ref: event_readers.py:104-128)."""

    def __init__(self, paths_to_events):
        self.paths = list(paths_to_events)
        self.frame_id = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.frame_id >= len(self.paths):
            raise StopIteration
        with np.load(self.paths[self.frame_id]) as z:
            window = np.stack((z["t"], z["x"], z["y"], z["p"]), axis=1)
        self.frame_id += 1
        return window


class ImageReader:
    """Sequence-folder reader: PNG frames, timestamps, per-interval event
    and GT flow npz files."""

    def __init__(self, cfgs):
        self.height, self.width = cfgs.image_dim
        self.num_bins = cfgs.num_bins
        self.time_unit = cfgs.time_unit
        # GT flow direction and sign (ref: video_readers.py:350-351)
        self.flow_name = "flow01" if cfgs.is_forward_flow else "flow10"
        self.flow_coef = 1 if cfgs.is_forward_flow else -1
        self.dataset = cfgs.dataset
        self.ending = False
        self.num_events = 0

    def initialize(self, path_to_sequence, num_load_frames=-1):
        self.frame_id = 0
        self.flow_id = 0
        self.ending = False
        self.prev_frame = None
        self.path_to_frames, path_to_events, self.path_to_flow = [], [], []
        path_to_timestamps = None
        for root, _, files in os.walk(path_to_sequence):
            for name in files:
                ext = name.split(".")[-1]
                if ext in ("jpg", "png"):
                    self.path_to_frames.append(os.path.join(root, name))
                elif name in ("timestamps.txt", "images.txt", "timestamp.txt"):
                    path_to_timestamps = os.path.join(root, name)
                elif (ext == "npz" and "flow" not in name) or name in (
                        "events.txt", "events.zip", "events.csv"):
                    path_to_events.append(os.path.join(root, name))
                elif ext == "npz" and "flow" in name:
                    self.path_to_flow.append(os.path.join(root, name))
        self.path_to_frames.sort()
        self.path_to_flow.sort()
        self.timestamps = read_timestamps_file(path_to_timestamps, self.time_unit)
        if num_load_frames > 0:
            self.path_to_frames = self.path_to_frames[:num_load_frames]
            self.timestamps = self.timestamps[:num_load_frames]
            self.path_to_flow = self.path_to_flow[:num_load_frames]
        if self.dataset == "HSERGB":
            # HSERGB first-frame duplication (ref: video_readers.py:397-399)
            self.path_to_frames = [self.path_to_frames[0]] + self.path_to_frames
            self.timestamps = [self.timestamps[0]] + self.timestamps
        demo = read_png(self.path_to_frames[0])
        height, width = (demo.shape[0] // 2) * 2, (demo.shape[1] // 2) * 2
        assert height == self.height or width == self.width, \
            f"Image dim should be H{height}xW{width}"
        self.num_frames = len(self.path_to_frames)
        if len(path_to_events) <= 1 or any(not p.endswith(".npz") for p in path_to_events):
            raise NotImplementedError(
                f"{path_to_sequence}: only per-interval events_*.npz files are "
                "read; single-file (.txt/.zip/.csv) event streams are not ported")
        path_to_events.sort()
        if num_load_frames > 0:
            path_to_events = path_to_events[:num_load_frames]
        self.event_window_iterator = SingleEventReaderNpz(path_to_events)

    def update_frame(self):
        frame = read_png(self.path_to_frames[self.frame_id]).astype(np.float32) / 255.0
        frame = frame[:self.height, :self.width]
        ts = self.timestamps[self.frame_id]
        self.frame_id += 1
        return frame, ts

    def update_flow(self):
        with np.load(self.path_to_flow[self.flow_id], allow_pickle=True) as z:
            flow = z[self.flow_name]
        flow = self.flow_coef * flow[:, :self.height, :self.width] \
            if flow.shape[0] == 2 else self.flow_coef * flow[:self.height, :self.width]
        self.flow_id += 1
        return flow

    def update_events(self):
        try:
            return next(self.event_window_iterator)
        except StopIteration:
            return None

    def _voxelize(self, window):
        """One voxel of the whole window (mode 'upsampled';
        ref: video_readers.py:82-97)."""
        self.num_events = len(window)
        v = events_to_voxel_grid(window, self.num_bins, self.width, self.height)
        return [event_preprocess(v, filter_hot_pixel=False)]

    def update_event_frame_flow_pack(self, mode="upsampled"):
        """One GT frame interval: ([voxel], [previous frame], next frame,
        [GT flow]) (ref: video_readers.py:237-282)."""
        assert mode == "upsampled", "Data mode can not be 'real'!"
        if self.frame_id == 0:
            self.prev_frame, _ = self.update_frame()
        frame_pack = [self.prev_frame]
        gt_frame, _ = self.update_frame()
        flow = self.update_flow()
        self.prev_frame = gt_frame
        window = self.update_events()
        if window is None:
            window = np.empty((0, 4))
        if self.frame_id >= self.num_frames:
            self.ending = True
        return self._voxelize(window), frame_pack, gt_frame, [flow]
