"""FlyingChairs2 for flow-net pretraining (host side, numpy).

Counterpart of cista_flow_tpu/data/flying_chairs2.py:21-112 (ref:
DCEIFlow/utils/datasets/FlyingChairs2.py:127-335): per sample an RGB PNG
pair, forward and backward ``.flo`` flows and a simulated-event HDF5 file
(``<split>/<id>-img_0.png``, ``-img_1.png``, ``-flow_01.flo``,
``-flow_10.flo``; ``events_<split>/<id>-event.hdf5`` with x, y, t, p),
read through the port's PNG codec and HDF5 reader; the train split's
held-out indices (``validate_indices``) for ``trainval``; with ``is_bi``
the reversed events' voxel for bidirectional training. Items are dicts of
CHW float32 arrays, bit for bit the JAX dataset's but for the colour
jitter's rounding (``augmentors``).
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from .augmentors import fetch_augmentor
from .file_io import read_dense_flow, read_event_h5, read_gen
from .mvsec_utils import events_to_voxel_triangular

# sample ids left out upstream (ref: FlyingChairs2.py FlyingChairs2_BAD_ID)
BAD_IDS = {"0000673"}


class FlyingChairs2:
    def __init__(self, args, data_root, data_kind="train", aug_params=None, validate_indices=()):
        self.event_bins = args.num_bins
        self.is_bi = getattr(args, "is_bi", False)
        self.data_root = data_root

        if data_kind.startswith("train"):
            self.data_split = "train"
            self.data_mode = data_kind[5:] or "train"
        elif data_kind.startswith("val"):
            self.data_split = "val"
            self.data_mode = "full"
        else:
            raise NotImplementedError(f"Unsupported data kind {data_kind}")

        self.augmentor = None
        if aug_params is not None:
            self.augmentor = fetch_augmentor(is_event=True, is_sparse=False, aug_params=aug_params)
        self.validate_indices = set(validate_indices)
        self._fetch_valids()

    def _fetch_valids(self):
        images_root = os.path.join(self.data_root, self.data_split)
        events_root = os.path.join(self.data_root, "events_" + self.data_split)
        img1 = sorted(glob(os.path.join(images_root, "*-img_0.png")))
        img2 = sorted(glob(os.path.join(images_root, "*-img_1.png")))
        f01 = sorted(glob(os.path.join(images_root, "*-flow_01.flo")))
        f10 = sorted(glob(os.path.join(images_root, "*-flow_10.flo")))
        evs = sorted(glob(os.path.join(events_root, "*-event.hdf5")))

        val_idx = {i for i in self.validate_indices if i < len(img1)}
        if self.data_mode.startswith("val"):
            keep = val_idx
        elif self.data_mode == "full":
            keep = set(range(len(img1)))
        else:
            keep = set(range(len(img1))) - val_idx

        self.samples = []
        for i in range(len(img1)):
            base = os.path.basename(img1[i]).split("-", 2)[0]
            if i in keep and base not in BAD_IDS:
                self.samples.append((img1[i], img2[i], f01[i], f10[i], evs[i]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        index = index % len(self.samples)
        p_i1, p_i2, p_f01, p_f10, p_ev = self.samples[index]
        im1 = np.asarray(read_gen(p_i1)).astype(np.uint8)
        im2 = np.asarray(read_gen(p_i2)).astype(np.uint8)
        flow01 = read_dense_flow(p_f01)
        flow10 = read_dense_flow(p_f10)
        events = read_event_h5(p_ev)  # (N, 4) [x, y, t, p]

        h, w = im1.shape[:2]
        voxel = events_to_voxel_triangular(events, self.event_bins, h, w)

        voxel_r = None
        if self.is_bi:
            # the reversed events: order flipped, polarity negated, time mirrored
            rev = np.stack([np.flip(events[:, 0]), np.flip(events[:, 1]),
                            np.flip(events[:, 2].max() - events[:, 2]),
                            np.flip(-events[:, 3])], axis=1)
            voxel_r = events_to_voxel_triangular(rev, self.event_bins, h, w)

        if self.augmentor is not None:
            voxel, im1, im2, flow01, flow10, _, _, voxel_r = self.augmentor(
                voxel, im1, im2, flow01, flow10, event_r=voxel_r)

        mag = np.linalg.norm(flow01, axis=-1)
        valid = (mag < 1000).astype(np.float32)

        batch = {
            "event_voxel": voxel.astype(np.float32),
            "gt_img0": np.transpose(im1, (2, 0, 1)).astype(np.float32) / 255.0,
            "gt_img1": np.transpose(im2, (2, 0, 1)).astype(np.float32) / 255.0,
            "gt_flow": np.transpose(flow01, (2, 0, 1)).astype(np.float32),
            "gt_flow_bw": np.transpose(flow10, (2, 0, 1)).astype(np.float32),
            "valid": valid[None],
        }
        if voxel_r is not None:
            batch["event_voxel_bw"] = voxel_r.astype(np.float32)
        return batch
