"""MVSEC helpers: the asynchronous GT flow carried across a frame pair, the
dense flow error, and the triangular-weight voxelization (host side, numpy).

Counterpart of cista_flow_tpu/data/mvsec_utils.py:19-134 (ref:
data_readers/MVSEC_utils.py). MVSEC's GT flow maps are not synchronised with
the grey frames, so each pixel's displacement is carried through every map
of the interval by nearest-neighbour remaps, the maps at both ends scaled to
the part of them that falls inside it. The JAX package remaps with OpenCV
(``cv2.remap(..., INTER_NEAREST)``); ``remap_nearest`` is the same function
in numpy, so the propagated flow is bit for bit the JAX package's.
"""
from __future__ import annotations

import numpy as np


def flow_error_dense(flow_gt, flow_pred, event_img=None, is_car=False):
    """AEE and the share of inliers (error < 3 px) over the valid GT pixels
    (ref: MVSEC_utils.py:13-46); returns (aee, share, pixels). flow_gt,
    flow_pred: (H, W, 2); ``is_car`` keeps the rows above the car's hood
    (190)."""
    max_row = flow_gt.shape[1]
    if event_img is None:
        event_img = np.ones(flow_pred.shape[0:2])
    if is_car:
        max_row = 190

    event_img = event_img[:max_row, :]
    flow_gt = flow_gt[:max_row, :, :]
    flow_pred = flow_pred[:max_row, :, :]

    event_mask = event_img > 0
    flow_mask = np.logical_and(
        np.logical_and(~np.isinf(flow_gt[:, :, 0]), ~np.isinf(flow_gt[:, :, 1])),
        np.linalg.norm(flow_gt, axis=2) > 0)
    total_mask = np.squeeze(np.logical_and(event_mask, flow_mask))

    ee = np.linalg.norm(flow_gt[total_mask, :] - flow_pred[total_mask, :], axis=-1)
    aee = float(np.mean(ee))
    percent = float((ee < 3.0).sum()) / float(ee.shape[0] + 1e-5)
    return aee, percent, ee.shape[0]


def remap_nearest(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(src, map_x, map_y, cv2.INTER_NEAREST)`` with its default
    constant-zero border: each output pixel takes ``src`` at the map's
    coordinates rounded half to even (OpenCV's cvRound of f32 maps), zero
    where they fall outside the frame or are not finite."""
    h, w = src.shape
    x, y = np.rint(map_x), np.rint(map_y)
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    out = np.zeros(np.shape(map_x), src.dtype)
    out[inside] = src[y[inside].astype(np.int64), x[inside].astype(np.int64)]
    return out


def prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale_factor=1.0):
    """Advance the propagation indices along one GT flow map (nearest
    remap); mask out pixels whose sampled flow is exactly zero (ref:
    MVSEC_utils.py:53-70). Mutates the indices and masks in place."""
    fx = remap_nearest(x_flow, x_indices, y_indices)
    fy = remap_nearest(y_flow, x_indices, y_indices)
    x_mask[fx == 0] = False
    y_mask[fy == 0] = False
    x_indices += fx * scale_factor
    y_indices += fy * scale_factor


def generate_corresponding_gt_flow(flows, flows_ts, start_time, end_time):
    """The GT flow over [start_time, end_time] from the asynchronous maps
    ``flows`` (N, 2, H, W) at ``flows_ts`` (N + 1 bounds) (ref:
    MVSEC_utils.py:97-167); returns (2, H, W)."""
    flow_length = len(flows)
    assert flow_length == len(flows_ts) - 1, f"{flow_length} != {len(flows_ts) - 1}"

    x_flow = np.array(flows[0][0], dtype=np.float32)
    y_flow = np.array(flows[0][1], dtype=np.float32)
    gt_dt = flows_ts[1] - flows_ts[0]
    pre_dt = end_time - start_time

    if start_time > flows_ts[0] and end_time <= flows_ts[1]:
        x_flow *= pre_dt / gt_dt
        y_flow *= pre_dt / gt_dt
        return np.stack((x_flow, y_flow), axis=0)

    x_indices, y_indices = np.meshgrid(np.arange(x_flow.shape[1]), np.arange(x_flow.shape[0]))
    x_indices = x_indices.astype(np.float32)
    y_indices = y_indices.astype(np.float32)
    orig_x = x_indices.copy()
    orig_y = y_indices.copy()
    x_mask = np.ones(x_indices.shape, dtype=bool)
    y_mask = np.ones(y_indices.shape, dtype=bool)

    scale = (flows_ts[1] - start_time) / gt_dt
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale)

    for i in range(1, flow_length - 1):
        prop_flow(np.array(flows[i][0], np.float32), np.array(flows[i][1], np.float32),
                  x_indices, y_indices, x_mask, y_mask)

    gt_dt = flows_ts[flow_length] - flows_ts[flow_length - 1]
    pred_dt = end_time - flows_ts[flow_length - 1]
    prop_flow(np.array(flows[flow_length - 1][0], np.float32),
              np.array(flows[flow_length - 1][1], np.float32),
              x_indices, y_indices, x_mask, y_mask, pred_dt / gt_dt)

    x_shift = x_indices - orig_x
    y_shift = y_indices - orig_y
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return np.stack((x_shift, y_shift), axis=0)


def events_to_txyp(events):
    """MVSEC's event rows [x, y, t, p] as [t, x, y, p], the coordinates and
    polarity truncated to integers (ref: MVSEC_utils.py:366-381)."""
    e = np.asarray(events)
    return np.stack([e[:, 2], e[:, 0].astype(np.int32), e[:, 1].astype(np.int32),
                     e[:, 3].astype(np.int32)], axis=1)


def events_to_voxel_triangular(events_xytp, num_bins, height, width):
    """The triangular-weight voxel of ``MVSEC.__getitem__`` and
    FlyingChairs2 (ref: MVSEC_utils.py:253-303, events_to_voxel_torch):
    bin b accumulates p * max(0, 1 - |t_norm - b|), the polarity as it is
    (no remapping of 0). events_xytp: [x, y, t, p] rows."""
    e = np.asarray(events_xytp)
    xs = e[:, 0].astype(np.int64)
    ys = e[:, 1].astype(np.int64)
    ts = e[:, 2].astype(np.float64)
    ps = e[:, 3].astype(np.float32)

    dt = ts[-1] - ts[0]
    t_norm = (ts - ts[0]) / dt * (num_bins - 1) if dt > 0 else np.zeros_like(ts)
    voxel = np.zeros((num_bins, height, width), np.float32)
    flat = voxel.reshape(num_bins, -1)
    lin = ys * width + xs
    for b in range(num_bins):
        w = np.maximum(0.0, 1.0 - np.abs(t_norm - b)).astype(np.float32)
        np.add.at(flat[b], lin, ps * w)
    return voxel
