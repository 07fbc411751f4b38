"""MVSEC datasets over the recordings' HDF5 files (host side, numpy).

Counterpart of cista_flow_tpu/data/mvsec.py:22-270 (ref:
data_readers/MVSEC.py:69-544), read through the port's own HDF5 reader
(``data/hdf5.py``) instead of h5py. The layout: ``<split>_data.hdf5`` with
``davis/left/{events, image_raw, image_raw_ts, image_raw_event_inds}``
(events as [x, y, t, p] rows) and ``<split>_gt.hdf5`` with
``davis/left/{flow_dist, flow_dist_ts}``; each split's valid range of raw
frame indices (``VALID_TIME_INDEX``); the files opened lazily on first use
(a worker process opens its own); the GT flow carried over each frame
pair's interval (``mvsec_utils.generate_corresponding_gt_flow``). Items are
bit for bit the JAX package's on the same files.
"""
from __future__ import annotations

import os

import numpy as np

from ..events import event_preprocess, events_to_voxel_grid
from . import hdf5
from .mvsec_utils import (events_to_txyp, events_to_voxel_triangular,
                          generate_corresponding_gt_flow)

# alias -> the recording's file stem (ref: MVSEC.py:18-48)
DATASET_MAPPING = {}
for _i in (1, 2, 3, 4):
    for _alias in (f"in{_i}", f"inday{_i}", f"indoor{_i}", f"indoor_flying{_i}"):
        DATASET_MAPPING[_alias] = f"indoor_flying{_i}"
for _i in (1, 2):
    for _alias in (f"out{_i}", f"outday{_i}", f"outdoor{_i}", f"outdoor_day{_i}"):
        DATASET_MAPPING[_alias] = f"outdoor_day{_i}"

VALID_TIME_INDEX = {
    "indoor_flying1": [314, 2199],
    "indoor_flying2": [314, 2199],
    "indoor_flying3": [314, 1870],
    "indoor_flying4": [196, 570],
    "outdoor_day1": [245, 3000],
    "outdoor_day2": [4375, 7002],
}
SENSOR_SIZE = (260, 346)            # DAVIS346 (ref: MVSEC.py:309-311)


class _MVSECBase:
    def __init__(self, args, data_root, data_split="in1", data_mode="full",
                 train_ratio=0.6, skip_num=None, skip_mode="c"):
        self.args = args
        self.data_root = data_root
        self.data_split = data_split
        assert data_split in DATASET_MAPPING or data_split in VALID_TIME_INDEX
        self.data_filepath = os.path.join(data_root, data_split + "_data.hdf5")
        self.gt_filepath = os.path.join(data_root, data_split + "_gt.hdf5")
        assert os.path.isfile(self.data_filepath), self.data_filepath
        assert os.path.isfile(self.gt_filepath), self.gt_filepath

        self.data_mode = data_mode
        self.train_ratio = train_ratio
        self.event_bins = args.num_bins
        self.skip_num = 1 if skip_num is None else skip_num
        self.skip_mode = skip_mode
        key = DATASET_MAPPING.get(data_split, data_split)
        self.raw_index_shift = VALID_TIME_INDEX[key][0]
        self.raw_index_max = VALID_TIME_INDEX[key][1] - 1

        if self.skip_mode == "i":
            self.data_length = (self.raw_index_max - self.raw_index_shift) // self.skip_num - 1
        else:
            self.data_length = self.raw_index_max - self.raw_index_shift - (self.skip_num - 1)

        # the reproducible train/val split (ref: MVSEC.py:121-131)
        rng = np.random.RandomState(20)
        split = rng.rand(self.data_length) <= self.train_ratio
        if data_mode == "full":
            self.INDEX_MAP = list(range(self.data_length))
        elif data_mode == "train":
            self.INDEX_MAP = [i for i in range(self.data_length) if split[i]]
        elif data_mode == "val":
            self.INDEX_MAP = [i for i in range(self.data_length) if not split[i]]
        else:
            raise NotImplementedError(f"unknown data mode {data_mode}")
        self.data_length = len(self.INDEX_MAP)

    def open_hdf5(self):
        """Open both files on first use, in the process that reads them
        (ref: MVSEC.py:133-151)."""
        data_file = hdf5.File(self.data_filepath)
        self.events_data = data_file["davis/left/events"]
        self.image_data = data_file["davis/left/image_raw"]
        self.image_ts_data = data_file["davis/left/image_raw_ts"]
        self.image_event_inds = data_file["davis/left/image_raw_event_inds"]
        gt_file = hdf5.File(self.gt_filepath)
        self.flow_dist_data = gt_file["davis/left/flow_dist"]
        self.flow_dist_ts_numpy = np.array(gt_file["davis/left/flow_dist_ts"], dtype=np.float32)
        self._files = (data_file, gt_file)
        self.image_length = len(self.image_data)
        self.event_length = len(self.events_data)
        self.flow_length = len(self.flow_dist_data)

    def _raw_index(self, index):
        if self.skip_mode == "i":
            raw = self.INDEX_MAP[index] * self.skip_num + self.raw_index_shift
        else:
            raw = self.INDEX_MAP[index] + self.raw_index_shift
        assert raw < self.raw_index_max
        return raw

    def _frame_pair(self, raw_index):
        image1 = np.array(self.image_data[raw_index])
        image1_ts = float(self.image_ts_data[raw_index])
        i1 = int(self.image_event_inds[raw_index])
        image2 = np.array(self.image_data[raw_index + self.skip_num])
        image2_ts = float(self.image_ts_data[raw_index + self.skip_num])
        i2 = int(self.image_event_inds[raw_index + self.skip_num])
        assert i1 < i2 < self.event_length
        return image1, image1_ts, i1, image2, image2_ts, i2

    def _gt_flow(self, image1_ts, next_ts):
        left = np.searchsorted(self.flow_dist_ts_numpy, image1_ts, side="right") - 1
        right = np.searchsorted(self.flow_dist_ts_numpy, next_ts, side="right")
        assert left <= right < self.flow_length
        flows = np.array(self.flow_dist_data[left:right])
        flows_ts = self.flow_dist_ts_numpy[left:right + 1]
        return generate_corresponding_gt_flow(flows, flows_ts, image1_ts, next_ts)

    def _events_and_frames(self, index):
        """The frame pair and the events between them, read from the files."""
        if not hasattr(self, "events_data"):
            self.open_hdf5()
        raw = self._raw_index(index)
        image1, image1_ts, i1, image2, next_ts, i2 = self._frame_pair(raw)
        events = np.array(self.events_data[i1:i2])  # [x, y, t, p]
        return image1, image1_ts, image2, next_ts, events

    def get_raw_events(self, index):
        if not hasattr(self, "events_data"):
            self.open_hdf5()
        raw = self._raw_index(index)
        i1 = int(self.image_event_inds[raw])
        i2 = int(self.image_event_inds[raw + self.skip_num])
        return np.array(self.events_data[i1:i2])

    def __len__(self):
        return self.data_length


def _flow_valid(final_flow):
    return ((np.linalg.norm(final_flow, axis=0) > 0)
            & (np.abs(final_flow[0]) < 1000)
            & (np.abs(final_flow[1]) < 1000)).astype(np.float32)


class MVSEC(_MVSECBase):
    """The voxel-per-frame-pair reader (ref: MVSEC.py:69-289): a dict of the
    two frames as 3 channels, the pair's triangular voxel, the (2, H, W) GT
    flow and its validity, centre-cropped to 256x256 (outdoor splits before
    the validity)."""

    def __init__(self, args, data_root, data_split="in1", data_mode="full",
                 train_ratio=0.6, skip_num=None):
        super().__init__(args, data_root, data_split, data_mode, train_ratio, skip_num,
                         skip_mode="c")
        self.crop_size = (256, 256)

    def __getitem__(self, index):
        image1, image1_ts, image2, next_ts, events = self._events_and_frames(index)
        height, width = image1.shape[:2]
        voxel = events_to_voxel_triangular(events, self.event_bins, height, width)
        final_flow = self._gt_flow(image1_ts, next_ts)  # (2, H, W)

        if image1.ndim == 2:
            image1 = np.tile(image1[..., None], (1, 1, 3))
            image2 = np.tile(image2[..., None], (1, 1, 3))
        else:
            image1, image2 = image1[..., :3], image2[..., :3]

        ch, cw = self.crop_size
        if "out" in self.data_split:
            sy, sx = (height - ch) // 2, (width - cw) // 2
            image1 = image1[sy:sy + ch, sx:sx + cw]
            image2 = image2[sy:sy + ch, sx:sx + cw]
            voxel = voxel[:, sy:sy + ch, sx:sx + cw]
            final_flow = final_flow[:, sy:sy + ch, sx:sx + cw]
        height, width = image1.shape[:2]

        flow_valid = _flow_valid(final_flow)

        if (height, width) != (ch, cw):
            sy, sx = (height - ch) // 2, (width - cw) // 2
            image1 = image1[sy:sy + ch, sx:sx + cw]
            image2 = image2[sy:sy + ch, sx:sx + cw]
            voxel = voxel[:, sy:sy + ch, sx:sx + cw]
            final_flow = final_flow[:, sy:sy + ch, sx:sx + cw]
            flow_valid = flow_valid[sy:sy + ch, sx:sx + cw]

        return {
            "gt_img0": np.transpose(image1, (2, 0, 1)).astype(np.float32),
            "gt_img1": np.transpose(image2, (2, 0, 1)).astype(np.float32),
            "event_voxel": voxel,
            "gt_flow": final_flow.astype(np.float32),
            "flow_valid": flow_valid[None],
        }


class MVSEC_NE(_MVSECBase):
    """The raw-event-chunk reader (ref: MVSEC.py:292-544): a frame pair's
    events ([t, x, y, p]) split into about ``num_events``-event chunks and
    returned raw, with the GT frames and the carried GT flow;
    ``test_mvsec`` accumulates chunks and voxelizes them
    (``events_to_voxel``). The sensor is DAVIS346's (260, 346) unless the
    config's ``mvsec_sensor_size`` says otherwise (smaller simulated
    recordings)."""

    def __init__(self, args, data_root, data_split="in1", data_mode="full",
                 train_ratio=0.6, skip_num=None):
        super().__init__(args, data_root, data_split, data_mode, train_ratio, skip_num,
                         skip_mode="i")
        sh, sw = getattr(args, "mvsec_sensor_size", None) or SENSOR_SIZE
        self.width = sw
        self.height = sh
        self.crop_size = (sh, sw)
        self.num_events = args.num_events

    def events_to_voxel(self, events, height, width):
        """Voxelize, centre-crop and normalise (the nonzero entries to zero
        mean and unit variance, hot pixels zeroed) (ref: MVSEC.py:377-390).
        Returns (C, crop_h, crop_w) float32."""
        evs = events_to_voxel_grid(events, self.event_bins, width, height)
        ch, cw = self.crop_size
        sy, sx = (height - ch) // 2, (width - cw) // 2
        evs = evs[:, sy:sy + ch, sx:sx + cw]
        return event_preprocess(evs, filter_hot_pixel=True)

    def __getitem__(self, index):
        image1, image1_ts, image2, next_ts, events = self._events_and_frames(index)
        events = events_to_txyp(events)

        ne = self.num_events if self.num_events > 0 else events.shape[0]
        n = max(round(events.shape[0] / ne), 1)
        raw_events_list = [[chunk, chunk.shape[0]] for chunk in np.array_split(events, n, axis=0)]

        final_flow = self._gt_flow(image1_ts, next_ts)

        if image1.ndim == 2:
            image1 = image1[..., None]
            image2 = image2[..., None]
        else:
            image1 = image1[..., :3].mean(-1, keepdims=True)
            image2 = image2[..., :3].mean(-1, keepdims=True)

        image1 = np.transpose(image1, (2, 0, 1)).astype(np.float32) / 255.0
        image2 = np.transpose(image2, (2, 0, 1)).astype(np.float32) / 255.0

        flow_valid = _flow_valid(final_flow)

        h, w = image1.shape[-2:]
        ch, cw = self.crop_size
        if (h, w) != (ch, cw):
            sy, sx = (h - ch) // 2, (w - cw) // 2
            image1 = image1[:, sy:sy + ch, sx:sx + cw]
            image2 = image2[:, sy:sy + ch, sx:sx + cw]
            final_flow = final_flow[:, sy:sy + ch, sx:sx + cw]
            flow_valid = flow_valid[sy:sy + ch, sx:sx + cw]

        batch = {
            "gt_img0": image1,
            "gt_img1": image2,
            "org_width": self.width,
            "org_height": self.height,
            "gt_flow": final_flow.astype(np.float32),
            "flow_valid": flow_valid[None],
        }
        return raw_events_list, batch
