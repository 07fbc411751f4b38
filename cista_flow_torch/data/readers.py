"""The eval CLIs' stream and sequence readers (host side, numpy).

Counterparts of the JAX package's readers (cista_flow_tpu/data/
event_readers.py and video_readers.py; ref: data_readers/event_readers.py,
data_readers/video_readers.py:42-457), without pandas or OpenCV:

- ``FixedSizeEventReader``: fixed-count windows of a single-file stream
  (``.txt``, ``.csv``, or a ``.zip`` holding one such file), with the
  ``k_shift`` overlap. It streams: blocks of lines go to ``np.loadtxt``,
  so a file of gigabytes is never held whole.
- ``RefTimeEventReaderZip``: a single-file stream cut at the frames'
  timestamps (ECD, HQF).
- ``SingleEventReaderNpz``: per-interval ``.npz`` windows (the simulator's
  layout).
- ``ImageReader``: a sequence folder (8-bit grayscale PNG frames,
  timestamps, events as per-interval ``.npz`` files or one single-file
  stream, optional GT flow) paired into the packs the three eval CLIs take.

A window is an (N, 4) float64 array ``[t, x, y, p]``, as the JAX readers'
``np.array`` of pandas' frame gives it. Timestamps are parsed by numpy's
correctly rounded float conversion; on decimal text of up to 15
significant digits (``%.6f``, ``%.9f``) that is what pandas' C parser
gives too.
"""
from __future__ import annotations

import io
import itertools
import os
import time
import warnings
import zipfile

import numpy as np

from ..events import event_preprocess, events_to_voxel_grid
from .png import read_png

STREAM_NAMES = ("events.txt", "events.zip", "events.csv")


def open_text(path: str):
    """A text handle on an event stream: the file itself, or the one
    member of a ``.zip`` (as pandas' ``compression='infer'`` reads it)."""
    if not path.endswith(".zip"):
        return open(path)
    with zipfile.ZipFile(path) as zf:       # the open member keeps the file open
        names = [n for n in zf.namelist() if not n.endswith("/")]
        if len(names) != 1:
            raise ValueError(f"{path}: a .zip stream holds one file, found {names}")
        return io.TextIOWrapper(zf.open(names[0]), encoding="utf-8")


def parse_events(lines) -> np.ndarray:
    """Whitespace-separated ``t x y p`` lines (a list or a text handle;
    blank lines skipped, as pandas skips them) -> (N, 4) float64."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)    # a block of blank lines
        out = np.loadtxt(lines, dtype=np.float64, ndmin=2)
    return out if out.size else np.empty((0, 4))


class FixedSizeEventReader:
    """Fixed-count event windows from a .txt/.zip/.csv stream, with optional
    ``k_shift`` sliding-window overlap (ref: event_readers.py:6-47). The
    first ``start_index + 1`` lines are skipped: the stream's ``W H`` header
    and ``start_index`` events."""

    def __init__(self, path_to_event_file, num_events=10000, k_shift=-1,
                 start_index=0):
        self.handle = open_text(path_to_event_file)
        for _ in itertools.islice(self.handle, start_index + 1):
            pass
        self.num_events = num_events
        self.k_shift = k_shift
        self.prev_events_size = num_events - k_shift
        self.frame_idx = 0
        self.prev_events = None

    def _chunk(self, n: int) -> np.ndarray:
        """The next ``n`` events; at the end of the stream StopIteration,
        as pandas' ``get_chunk`` raises it."""
        lines = list(itertools.islice(self.handle, n))
        events = parse_events(lines) if lines else np.empty((0, 4))
        while 0 < len(events) < n and len(lines) == n:    # blank lines were skipped
            lines = list(itertools.islice(self.handle, n - len(events)))
            events = np.concatenate((events, parse_events(lines))) if lines else events
        if not len(events):
            self.close()
            raise StopIteration
        return events

    def close(self):
        self.handle.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self.k_shift > 0:
            if self.frame_idx == 0:
                window = self._chunk(self.num_events)
            else:
                window = np.concatenate((self.prev_events, self._chunk(self.k_shift)), 0)
            self.prev_events = window[-self.prev_events_size:].copy()
            self.frame_idx += 1
        else:
            window = self._chunk(self.num_events)
        return window


class RefTimeEventReaderZip:
    """Windows bounded by the frames' timestamps: loads the whole stream
    (no header line), finds each frame's first event at or after it, and
    yields the events between consecutive frames with times taken from the
    first frame's (ref: event_readers.py:50-101)."""

    def __init__(self, path_to_event_file, t_image):
        if os.path.splitext(path_to_event_file)[1] not in (".txt", ".csv", ".zip"):
            raise ValueError(f"{path_to_event_file}: not a .txt, .csv or .zip event stream")
        with open_text(path_to_event_file) as f:
            self.values = parse_events(f)
        self.t_image = np.array(t_image) - t_image[0]
        self.len = len(t_image) - 1
        self.t0 = t_image[0]
        timestamps = self.values[:, 0] - t_image[0]
        self.bound_index = []
        for t in self.t_image:
            idx = np.searchsorted(timestamps, t, side="left")
            if idx >= len(timestamps):
                idx = len(timestamps) - 1
            self.bound_index.append(int(idx))
        self.frame_id = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self.frame_id >= self.len:
            raise StopIteration
        lo = self.bound_index[self.frame_id]
        hi = self.bound_index[self.frame_id + 1]
        window = self.values[lo:hi].copy()
        window[:, 0] -= self.t0
        self.frame_id += 1
        return window


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
    """Sequence-folder reader: PNG frames, timestamps, events (per-interval
    npz files or one .txt/.zip/.csv stream) and optional GT flow npz files,
    with the windowing policies of the eval CLIs (ref:
    video_readers.py:42-457). Frames are 8-bit grayscale PNG; a JPEG frame
    raises."""

    def __init__(self, cfgs):
        self.height, self.width = cfgs.image_dim
        self.num_bins = cfgs.num_bins
        self.time_unit = cfgs.time_unit
        # GT flow direction and sign (ref: video_readers.py:350-351)
        self.flow_name = "flow01" if cfgs.is_forward_flow else "flow10"
        self.flow_coef = 1 if cfgs.is_forward_flow else -1
        self.dataset = cfgs.dataset
        self.frame_id = 0
        self.num_frames = -1
        self.ending = False
        self.prev_frame = None
        self.num_events = 0
        self.voxelize_seconds = 0.0      # host clock spent in _voxelize

    def initialize(self, path_to_sequence, num_load_frames=-1):
        self.frame_id = 0
        self.event_id = 0
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
                elif (ext == "npz" and "flow" not in name) or name in STREAM_NAMES:
                    path_to_events.append(os.path.join(root, name))
                elif ext == "npz" and "flow" in name:
                    self.path_to_flow.append(os.path.join(root, name))
        jpeg = [p for p in self.path_to_frames if p.endswith(".jpg")]
        if jpeg:
            raise ValueError(
                f"{path_to_sequence}: JPEG frames ({os.path.basename(jpeg[0])}, ...) are not "
                "read by the port, which decodes 8-bit grayscale PNG only; convert them")
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
        if len(path_to_events) > 1:
            path_to_events.sort()
            if num_load_frames > 0:
                path_to_events = path_to_events[:num_load_frames]
            self.event_window_iterator = SingleEventReaderNpz(path_to_events)
        elif len(path_to_events) == 1:
            self.event_window_iterator = RefTimeEventReaderZip(path_to_events[0],
                                                               self.timestamps)

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
            window = next(self.event_window_iterator)
        except StopIteration:
            window = None
        self.event_id += 1
        return window

    # -- windowing policies ---------------------------------------------------

    def _accumulate(self, limit_num_events, threshold_factor, frame_pack):
        """Accumulate events across frames until >= threshold_factor * limit."""
        total, pack, window, gt_frame = 0, [], np.empty((0, 4)), None
        while total < threshold_factor * limit_num_events and \
                self.frame_id < self.num_frames:
            gt_frame, _ = self.update_frame()
            events = self.update_events()
            if frame_pack is not None:
                frame_pack.append(gt_frame)
            if events is not None:
                pack.append(events)
                total += len(events)
            if pack:
                window = np.concatenate(pack, 0) if len(pack) > 1 else pack[0]
        return window, gt_frame

    def _voxelize(self, window, limit_num_events=-1, split=False):
        """One voxel ('upsampled') or ``round(n / limit)`` chunks of about
        ``limit`` events each, hot pixels filtered ('real': several voxels
        per GT frame, ref: video_readers.py:128-141)."""
        t0 = time.perf_counter()
        self.num_events = len(window)
        if not split:
            v = events_to_voxel_grid(window, self.num_bins, self.width, self.height)
            out = [event_preprocess(v, filter_hot_pixel=False)]
        else:
            out = []
            n = max(round(window.shape[0] / limit_num_events), 1)
            for chunk in np.array_split(window, n, axis=0):
                v = events_to_voxel_grid(chunk, self.num_bins, self.width, self.height)
                out.append(event_preprocess(v, filter_hot_pixel=True))
        self.voxelize_seconds += time.perf_counter() - t0
        return out

    def update_event_frame_pack(self, limit_num_events=-1, mode="upsampled"):
        """(voxels, [frames of the window], next GT frame) (ref:
        video_readers.py:70-142)."""
        frame_pack = []
        if self.frame_id == 0:
            self.prev_frame, _ = self.update_frame()
        frame_pack.append(self.prev_frame)
        if limit_num_events > 0 and mode == "upsampled":
            window, gt_frame = self._accumulate(limit_num_events, 0.8, frame_pack)
            frame_pack.pop(-1)
            self.prev_frame = gt_frame
        else:
            gt_frame, _ = self.update_frame()
            window = self.update_events()
            self.prev_frame = gt_frame
            if window is None:
                window = np.empty((0, 4))
        if self.frame_id >= self.num_frames:
            self.ending = True
        split = not (limit_num_events <= 0 or mode == "upsampled")
        return self._voxelize(window, limit_num_events, split), frame_pack, gt_frame

    def update_event_frame_pack_fix(self, limit_num_events=-1, mode="upsampled"):
        """Accumulate >= N events across frames ('real' accumulates to the
        full limit), keep the events inside the frame (ref:
        video_readers.py:145-234; test_wo_flow's windowing)."""
        frame_pack = []
        if self.frame_id == 0:
            self.prev_frame, _ = self.update_frame()
        frame_pack.append(self.prev_frame)
        if limit_num_events > 0 and mode == "upsampled":
            window, gt_frame = self._accumulate(limit_num_events, 0.8, frame_pack)
            frame_pack.pop(-1)
            # the reference leaves `ending` unset here and fails at the end
            # of the stream; the JAX package ends cleanly, and so does this
            if gt_frame is None:
                self.ending = True
                gt_frame = self.prev_frame
            if self.frame_id >= self.num_frames:
                self.ending = True
            self.prev_frame = gt_frame
        elif limit_num_events > 0 and mode == "real":
            window, gt_frame = self._accumulate(limit_num_events, 1.0, None)
            if self.frame_id >= self.num_frames:
                self.ending = True
            self.prev_frame = gt_frame
        else:
            gt_frame, _ = self.update_frame()
            window = self.update_events()
            if self.frame_id >= self.num_frames:
                self.ending = True
            self.prev_frame = gt_frame
        window = window[window[:, 1] < self.width]
        window = window[window[:, 2] < self.height]
        split = not (limit_num_events <= 0 or mode == "upsampled")
        return self._voxelize(window, limit_num_events, split), frame_pack, gt_frame

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
