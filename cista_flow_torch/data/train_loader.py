"""The training sequences and their batching loader (host side, numpy).

Counterpart of cista_flow_tpu/data/train_loader.py (ref:
data_readers/train_data_loaders.py ``TrainfusedEventData``): the index
``train_e2v_estflow.txt`` -> sequences of line ids, grouped by video id
(``len_sequence > 0``) or regrouped so that each reconstruction sees about
``num_events`` events; each line decodes to one step's event voxel (and its
reversed twin), the two GT frames and the GT flow (and its backward twin).
``StackedSequenceLoader`` cuts the sequences into chunks of ``len_sequence``
steps and yields dicts of (T, B, C, H, W) float32 arrays, the train step's
input. Frames are read with the port's PNG codec. For cista-eraft each step
also carries ``event_voxel_old``, the previous line's window voxelized
(zeros at a video's first frame).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..events import event_preprocess, events_to_voxel_grid
from .png import read_png


class TrainSequenceDataset:
    """Parses ``seq_id num_events ts0 ts1 img0 img1 events flow`` lines
    (ref: train_data_loaders.py:15-17,51-60)."""

    def __init__(self, train_data_txt, cfgs):
        self.model_mode = cfgs.model_mode
        self.root = cfgs.path_to_train_data
        self.num_bins = cfgs.num_bins
        self.height, self.width = cfgs.image_dim
        self.limit_num_events = cfgs.num_events
        self.len_sequence = cfgs.len_sequence
        self.is_reverse_events = cfgs.is_reverse_events
        self.is_bi = cfgs.is_bi

        # the GT flow is stored for backward warping; forward warping flips
        # its name and sign (ref: train_data_loaders.py:31-38)
        if cfgs.is_forward_flow:
            self.flow_name, self.flow_name_bw = "flow01", "flow10"
        else:
            self.flow_name, self.flow_name_bw = "flow10", "flow01"
        self.flow_coef = -1 if cfgs.warp_mode == "forward" else 1

        self.video_cnt, self.num_events_list = [], []
        self.image_paths, self.next_image_paths = [], []
        self.event_paths, self.flow_paths = [], []
        with open(train_data_txt, "rb") as f:
            for line in f:
                s = line.strip().split()
                if not s:
                    continue
                self.video_cnt.append(int(s[0]))
                self.num_events_list.append(int(s[1]))
                self.image_paths.append(s[4].decode())
                self.next_image_paths.append(s[5].decode())
                self.event_paths.append(s[6].decode())
                self.flow_paths.append(s[7].decode())

        if self.len_sequence > 0:
            self._split_sequences()
        else:
            self._split_sequences_keep_org_seq()

    def __len__(self):
        return len(self.sequence_line_id)

    def _split_sequences(self):
        """Consecutive lines of one video id (ref: train_data_loaders.py:71-83)."""
        prev_video_id = -1
        self.sequence_line_id = []
        cur = []
        for line_id, video_id in enumerate(self.video_cnt):
            if video_id != prev_video_id and video_id != 0:
                if cur:
                    self.sequence_line_id.append(cur)
                cur = []
                prev_video_id = video_id
            cur.append(line_id)
        if cur:
            self.sequence_line_id.append(cur)

    def _split_sequences_keep_org_seq(self):
        """Lines regrouped so that each reconstruction reaches about
        ``limit_num_events`` (ref: train_data_loaders.py:86-118); an item is
        a list of per-reconstruction groups of line ids."""
        prev_video_id = -1
        total = 0
        self.sequence_line_id = []
        group, seq = [], []
        single = 0
        for line_id, video_id in enumerate(self.video_cnt):
            if video_id != prev_video_id and video_id != 0:
                if group:
                    seq.append(group)
                if seq:
                    self.sequence_line_id.append(seq)
                seq, group = [], []
                prev_video_id = video_id
                total, single = 0, 0
            total += self.num_events_list[line_id]
            group.append(line_id)
            single += 1
            if total >= self.limit_num_events or (
                    single == 1 and total > 0.8 * self.limit_num_events):
                seq.append(group)
                total, single = 0, 0
                group = []
        if seq:
            self.sequence_line_id.append(seq)

    def _load_events(self, rel_path):
        z = np.load(os.path.join(self.root, rel_path), allow_pickle=True)
        return np.stack((z["t"], z["x"], z["y"], z["p"]), axis=1)

    def _voxel(self, window, is_reverse=False):
        v = events_to_voxel_grid(window, self.num_bins, self.width, self.height,
                                 is_reverse=is_reverse)
        return event_preprocess(v, filter_hot_pixel=False)

    def _load_image(self, rel_path):
        return np.float32(read_png(os.path.join(self.root, rel_path)))[None] / 255.0

    def _load_flow(self, rel_path, name):
        return self.flow_coef * np.load(os.path.join(self.root, rel_path),
                                        allow_pickle=True)[name]

    def get_step(self, line_id, load_flow=True):
        """One step as (batch_data, batch_target) of CHW arrays: the voxel
        (bins, H, W) [+ its reversed twin] [+ cista-eraft's previous voxel],
        the frames (1, H, W), the flow (2, H, W) [+ its backward twin with
        ``is_bi``]. ``load_flow=False`` leaves the flows out, for a reader
        of the raw flow file (``sim.SimFlowPairs``)."""
        window = self._load_events(self.event_paths[line_id])
        batch_data = {"event_voxel": self._voxel(window)}
        if self.is_reverse_events:
            batch_data["event_voxel_bw"] = self._voxel(window, is_reverse=True)
        if self.model_mode == "cista-eraft":
            # zeros at a video's first frame: the first line, or an events
            # file whose frame index is 0 (cista_flow_tpu/data/train_loader.py:148-157)
            name = self.event_paths[line_id]
            if line_id == 0 or int(name.split(".")[-2].split("_")[-1]) == 0:
                batch_data["event_voxel_old"] = np.zeros_like(batch_data["event_voxel"])
            else:
                batch_data["event_voxel_old"] = self._voxel(
                    self._load_events(self.event_paths[line_id - 1]))
        batch_target = {"gt_img0": self._load_image(self.image_paths[line_id]),
                        "gt_img1": self._load_image(self.next_image_paths[line_id])}
        if not load_flow:
            return batch_data, batch_target
        batch_target["gt_flow"] = self._load_flow(self.flow_paths[line_id], self.flow_name)
        if self.is_bi:
            batch_target["gt_flow_bw"] = self._load_flow(self.flow_paths[line_id],
                                                         self.flow_name_bw)
        return batch_data, batch_target

    def __getitem__(self, index):
        """The reference's item: a list of (batch_data, batch_target), one
        per step."""
        return [self.get_step(i) for i in _flatten(self.sequence_line_id[index])]


def _flatten(ids):
    flat = []
    for item in ids:
        if isinstance(item, list):
            flat.extend(item)
        else:
            flat.append(item)
    return flat


class StackedSequenceLoader:
    """Batches of (T, B, C, H, W) arrays for the BPTT train step. Sequences
    shorter than ``len_sequence`` are dropped, longer ones cut into chunks of
    ``len_sequence`` steps; the chunks are shuffled from ``seed`` and a
    thread pool decodes a batch's chunks side by side.

    Data-parallel (cista_flow_tpu/data/train_loader.py:198-226): host
    ``process_index`` of ``process_count`` reads the round-robin chunk
    shard ``chunks[process_index::process_count]``, every shard cut to the
    common batch count (a host with one batch more would wait on a
    collective the others never reach); ``batch_size`` is the batch of one
    host. Of each host batch, rank ``local_index`` of the host's
    ``local_count`` decodes and yields only its contiguous slice of
    ``batch_size / local_count`` sequences, the slice JAX's
    ``shard_seq_batch`` puts on the host's ``local_index``-th device."""

    def __init__(self, dataset: TrainSequenceDataset, batch_size: int,
                 len_sequence: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 4, process_index: int = 0, process_count: int = 1,
                 local_index: int = 0, local_count: int = 1):
        if batch_size % local_count:
            raise ValueError(f"a host batch of {batch_size} does not split over "
                             f"{local_count} local ranks")
        self.ds = dataset
        self.batch_size = batch_size
        self.local_batch = batch_size // local_count
        self.local_start = local_index * self.local_batch
        self.t = len_sequence
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
        self.chunks = []
        for ids in self.ds.sequence_line_id:
            flat = _flatten(ids)
            for s in range(0, len(flat) - self.t + 1, self.t):
                self.chunks.append(flat[s:s + self.t])
        if process_count > 1:
            n_batches = (len(self.chunks) // process_count) // batch_size
            self.chunks = self.chunks[process_index::process_count][:n_batches * batch_size]

    def __len__(self):
        return len(self.chunks) // self.batch_size

    def _load_chunk(self, chunk):
        steps = [self.ds.get_step(i) for i in chunk]
        out = {k: np.stack([s[0][k] for s in steps]) for k in steps[0][0]}
        out.update({k: np.stack([s[1][k] for s in steps]) for k in steps[0][1]})
        return out                      # dict of (T, C, H, W)

    def __iter__(self):
        order = np.arange(len(self.chunks))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            mine = order[i + self.local_start:i + self.local_start + self.local_batch]
            chunk_ids = [self.chunks[j] for j in mine]
            if self.pool is not None:
                loaded = list(self.pool.map(self._load_chunk, chunk_ids))
            else:
                loaded = [self._load_chunk(c) for c in chunk_ids]
            yield {k: np.stack([b[k] for b in loaded], axis=1) for k in loaded[0]}
