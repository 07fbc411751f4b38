"""ESIM-style event-camera simulator, the eval sequence layout and the
training layout.

A numpy copy of the JAX package's simulator (cista_flow_tpu/data/sim.py:
the scene, ``simulate_sequence``, ``write_eval_sequence``,
``write_train_dataset`` and the flow-pretraining pairs ``SimFlowPairs``),
the port's only source of gate and training data: a smooth random
texture moves under a known time-varying affine motion; frames are exact
bilinear samples, events are emitted per pixel at log-intensity
threshold crossings (the ESIM contrast model, Rebecq et al., CoRL'18) and
the flow comes from the analytic motion, so frames, events and flow agree. The same seed gives the same arrays as
the JAX package's. Frames are written with the port's own PNG codec.

``write_mvsec_hdf5`` writes a simulated recording in MVSEC's HDF5 layout
through the port's own HDF5 writer (``data/hdf5.py``), the same arrays as
the JAX package's function (cista_flow_tpu/data/sim.py:284-355), every
dataset contiguous where h5py was asked for gzip chunks of ``image_raw``.
``write_chairs2_dataset`` writes a FlyingChairs2-layout folder of
simulated RGB pairs, flows and HDF5 events (the port's own; the JAX tests
build theirs with OpenCV and h5py). ``python -m cista_flow_torch.data.sim
--out DIR [--mode eval|train]`` is the JAX module's writer CLI
(sim.py:426-458), with the same flags.

Eval layout (ref: data_readers/video_readers.py:343-457):
  - frames ``frame_%04d.png`` (uint8 grayscale), ``timestamps.txt`` lines
    ``<name> <t_seconds>``
  - per-interval events ``events_%06d.npz`` with t (s), x, y, p (0/1;
    1 = brightening), time-sorted
  - per-interval flow ``flow_%06d.npz`` with ``flow01``/``flow10`` arrays
    of shape (2, H, W), channel 0 = x-displacement, channel 1 = y
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import hdf5
from .png import write_png


def smooth_texture(rng: np.random.Generator, h: int, w: int,
                   octaves: int = 4, lo: float = 0.08, hi: float = 1.0):
    """Multi-octave value noise in [lo, hi] (lo > 0 keeps log-intensity finite)."""
    tex = np.zeros((h, w), np.float64)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        ch = max(2, h >> (octaves - 1 - o))
        cw = max(2, w >> (octaves - 1 - o))
        coarse = rng.random((ch, cw))
        tex += amp * _bilinear_resize(coarse, h, w)
        total += amp
        amp *= 0.55
    tex /= total
    tex = (tex - tex.min()) / max(tex.max() - tex.min(), 1e-9)
    return (lo + (hi - lo) * tex).astype(np.float64)


def _bilinear_resize(img, h, w):
    ih, iw = img.shape
    ys = (np.arange(h) + 0.5) * ih / h - 0.5
    xs = (np.arange(w) + 0.5) * iw / w - 0.5
    return _sample_bilinear(img, *np.meshgrid(xs, ys))


def _sample_bilinear(img, gx, gy):
    """Exact bilinear sample of ``img`` at float coords (clamped to edges)."""
    ih, iw = img.shape
    gx = np.clip(gx, 0.0, iw - 1.0)
    gy = np.clip(gy, 0.0, ih - 1.0)
    x0 = np.floor(gx).astype(np.int64)
    y0 = np.floor(gy).astype(np.int64)
    x1 = np.minimum(x0 + 1, iw - 1)
    y1 = np.minimum(y0 + 1, ih - 1)
    fx, fy = gx - x0, gy - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


class AffineMotion:
    """Time-varying rigid motion: rotation ``omega*t`` about the image center
    plus translation ``(vx, vy)*t + 0.5*(ax, ay)*t^2`` (texture-space).

    Scene coordinate of pixel p at time t:  u(p, t) = R(t) (p - c) + c + d(t).
    All maps are exact and invertible, so frames, events and GT flow are
    mutually consistent to machine precision.
    """

    def __init__(self, center, vx=0.0, vy=0.0, ax=0.0, ay=0.0, omega=0.0):
        self.c = np.asarray(center, np.float64)  # (cx, cy)
        self.vx, self.vy, self.ax, self.ay, self.omega = vx, vy, ax, ay, omega

    def _rot(self, t):
        th = self.omega * t
        return np.array([[np.cos(th), -np.sin(th)],
                         [np.sin(th), np.cos(th)]], np.float64)

    def _d(self, t):
        return np.array([self.vx * t + 0.5 * self.ax * t * t,
                         self.vy * t + 0.5 * self.ay * t * t], np.float64)

    def scene_coords(self, px, py, t):
        """u(p, t): where pixel (px, py) looks in texture space at time t."""
        r = self._rot(t)
        dx, dy = px - self.c[0], py - self.c[1]
        ux = r[0, 0] * dx + r[0, 1] * dy + self.c[0] + self._d(t)[0]
        uy = r[1, 0] * dx + r[1, 1] * dy + self.c[1] + self._d(t)[1]
        return ux, uy

    def transport(self, px, py, t_from, t_to):
        """Pixel position at ``t_to`` of the scene point at (px, py), ``t_from``:
        solves R(t1)(p1 - c) + d(t1) = R(t0)(p0 - c) + d(t0)."""
        r0, r1 = self._rot(t_from), self._rot(t_to)
        dd = self._d(t_from) - self._d(t_to)
        dx, dy = px - self.c[0], py - self.c[1]
        sx = r0[0, 0] * dx + r0[0, 1] * dy + dd[0]
        sy = r0[1, 0] * dx + r0[1, 1] * dy + dd[1]
        # R(t1)^T = R(-t1)
        qx = r1[0, 0] * sx + r1[1, 0] * sy + self.c[0]
        qy = r1[0, 1] * sx + r1[1, 1] * sy + self.c[1]
        return qx, qy


# --------------------------------------------------------------------------
# ESIM event generation
# --------------------------------------------------------------------------

def events_from_log_frames(l0, l1, t0, t1, ref, c_pos, c_neg):
    """Vectorized per-pixel threshold-crossing extraction over one substep.

    Emits one event each time the (linearly interpolated) log intensity
    departs from the per-pixel reference level ``ref`` by a full contrast
    threshold; ``ref`` is updated in place by n*C per pixel. Returns
    (t, x, y, p) arrays, p = 1 for brightening.
    """
    h, w = l0.shape
    diff = l1 - ref
    n = np.where(diff > 0, np.floor(diff / c_pos),
                 np.floor(-diff / c_neg)).astype(np.int64)
    n = np.maximum(n, 0)
    flat = np.flatnonzero(n.ravel())
    if flat.size == 0:
        return (np.empty(0), np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.int64))
    counts = n.ravel()[flat]
    total = int(counts.sum())
    rep = np.repeat(flat, counts)                       # flat pixel index per event
    k = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts) + 1
    pos = (diff.ravel()[rep] > 0)
    step = np.where(pos, c_pos, -c_neg)
    lev = ref.ravel()[rep] + k * step                   # crossed level per event
    slope = l1.ravel()[rep] - l0.ravel()[rep]
    frac = np.clip((lev - l0.ravel()[rep]) / np.where(
        np.abs(slope) < 1e-12, np.inf, slope), 0.0, 1.0)
    t = t0 + (t1 - t0) * frac
    ref.ravel()[flat] += counts * np.where(diff.ravel()[flat] > 0,
                                           c_pos, -c_neg)
    return t, rep % w, rep // w, pos.astype(np.int64)


def simulate_sequence(seed: int, n_frames: int, h: int, w: int,
                      fps: float = 25.0, substeps: int = 10,
                      c_pos: float = 0.18, c_neg: float = 0.18,
                      speed: float = 60.0, omega: float = 0.25,
                      log_eps: float = 1e-2):
    """Render one sequence. Returns a dict with:
    frames (n, h, w) float in [0,1], timestamps (n,), events (n-1 lists of
    (t, x, y, p)), flow01 / flow10 (n-1, 2, h, w) float32.
    ``speed`` is texture px/s; ``omega`` rad/s about the image center."""
    rng = np.random.default_rng(seed)
    margin = int(np.ceil(speed * n_frames / fps + 0.3 * max(h, w))) + 4
    tex = smooth_texture(rng, h + 2 * margin, w + 2 * margin)

    ang = rng.uniform(0, 2 * np.pi)
    motion = AffineMotion(center=((w - 1) / 2.0, (h - 1) / 2.0),
                          vx=speed * np.cos(ang), vy=speed * np.sin(ang),
                          ax=-0.15 * speed * np.cos(ang),
                          ay=-0.15 * speed * np.sin(ang),
                          omega=omega * rng.choice([-1.0, 1.0]))

    px, py = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))

    def render(t):
        ux, uy = motion.scene_coords(px, py, t)
        return _sample_bilinear(tex, ux + margin, uy + margin)

    ts = np.arange(n_frames, dtype=np.float64) / fps
    frames = np.stack([render(t) for t in ts])

    events, flow01, flow10 = [], [], []
    ref = np.log(log_eps + frames[0])
    for i in range(n_frames - 1):
        # GT flow (exact, from the analytic motion)
        qx, qy = motion.transport(px, py, ts[i], ts[i + 1])
        flow01.append(np.stack([qx - px, qy - py]).astype(np.float32))
        bx, by = motion.transport(px, py, ts[i + 1], ts[i])
        flow10.append(np.stack([bx - px, by - py]).astype(np.float32))
        # events over `substeps` exact render points
        taus = np.linspace(ts[i], ts[i + 1], substeps + 1)
        lprev = np.log(log_eps + frames[i])
        parts = []
        for k in range(substeps):
            lcur = (np.log(log_eps + frames[i + 1]) if k == substeps - 1
                    else np.log(log_eps + render(taus[k + 1])))
            parts.append(events_from_log_frames(
                lprev, lcur, taus[k], taus[k + 1], ref, c_pos, c_neg))
            lprev = lcur
        t = np.concatenate([p[0] for p in parts])
        order = np.argsort(t, kind="stable")
        events.append((t[order],
                       np.concatenate([p[1] for p in parts])[order],
                       np.concatenate([p[2] for p in parts])[order],
                       np.concatenate([p[3] for p in parts])[order]))
    return {"frames": frames.astype(np.float32), "timestamps": ts,
            "events": events,
            "flow01": np.stack(flow01), "flow10": np.stack(flow10)}


def write_eval_sequence(outdir: str, sim: dict):
    """Eval-CLI layout: frames + timestamps.txt + per-interval events/flow
    (consumed by ImageReader, ref: video_readers.py:343-457)."""
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "timestamps.txt"), "w") as f:
        for i, t in enumerate(sim["timestamps"]):
            f.write(f"frame_{i:04d} {t:.9f}\n")
    for i, frame in enumerate(sim["frames"]):
        write_png(os.path.join(outdir, f"frame_{i:04d}.png"),
                  np.round(frame * 255).astype(np.uint8))
    for i, (t, x, y, p) in enumerate(sim["events"]):
        np.savez(os.path.join(outdir, f"events_{i:06d}.npz"),
                 t=t, x=x, y=y, p=p)
        np.savez(os.path.join(outdir, f"flow_{i:06d}.npz"),
                 flow01=sim["flow01"][i], flow10=sim["flow10"][i])


def write_train_dataset(outroot: str, n_videos: int, n_frames: int,
                        h: int, w: int, seed: int = 0,
                        speed_range=None, omega_range=None, **sim_kw) -> str:
    """Training layout: a folder per video and the index the training
    loader reads (ref: train_data_loaders.py:15-17: ``seq_id num_events ts0
    ts1 img0 img1 events flow`` per line; video ids from 1). Returns the
    index path. ``speed_range``/``omega_range``: optional (lo, hi) from
    which each video's texture speed and angular rate are drawn."""
    mrng = np.random.default_rng(seed + 31337)
    lines = []
    for vid in range(n_videos):
        vdir = os.path.join(outroot, f"v{vid:03d}")
        os.makedirs(vdir, exist_ok=True)
        kw = dict(sim_kw)
        if speed_range is not None:
            kw["speed"] = float(mrng.uniform(*speed_range))
        if omega_range is not None:
            kw["omega"] = float(mrng.uniform(*omega_range))
        sim = simulate_sequence(seed + 1000 * vid + 1, n_frames, h, w, **kw)
        for i, frame in enumerate(sim["frames"]):
            write_png(os.path.join(vdir, f"frame_{i:04d}.png"),
                      np.round(frame * 255).astype(np.uint8))
        for i, (t, x, y, p) in enumerate(sim["events"]):
            np.savez(os.path.join(vdir, f"events_{i:06d}.npz"), t=t, x=x, y=y, p=p)
            np.savez(os.path.join(vdir, f"flow_{i:06d}.npz"),
                     flow01=sim["flow01"][i], flow10=sim["flow10"][i])
            ts0, ts1 = sim["timestamps"][i], sim["timestamps"][i + 1]
            lines.append(
                f"{vid + 1} {len(t)} {ts0:.9f} {ts1:.9f} "
                f"v{vid:03d}/frame_{i:04d}.png v{vid:03d}/frame_{i + 1:04d}.png "
                f"v{vid:03d}/events_{i:06d}.npz v{vid:03d}/flow_{i:06d}.npz")
    path = os.path.join(outroot, "train_e2v_estflow.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def ensure_eval_data(workdir: str, h: int, w: int, eval_frames: int,
                     seed: int) -> str:
    """The held-out eval sequences of the quality gate: ``sim_00`` and
    ``sim_01`` under ``workdir/eval``, from seeds ``seed + 777_000 + s``
    (the JAX package's sim_quality.ensure_eval_data, which the committed
    gate targets were recorded on). A sequence already written is kept.
    Returns the eval directory."""
    eval_dir = os.path.join(workdir, "eval")
    for s in range(2):
        sdir = os.path.join(eval_dir, f"sim_{s:02d}")
        if not os.path.exists(os.path.join(sdir, "timestamps.txt")):
            write_eval_sequence(sdir, simulate_sequence(
                seed + 777_000 + s, eval_frames, h, w))
    return eval_dir


def write_mvsec_hdf5(outdir: str, split: str = "indoor_flying4", n_real: int = 16,
                     h: int = 260, w: int = 346, seed: int = 0, fps: float = 25.0,
                     **sim_kw) -> tuple:
    """An MVSEC-layout pair of HDF5 files from the simulator, the rehearsal
    recording of the MVSEC eval path: ``<outdir>/<split>_data.hdf5``
    (``davis/left/{events, image_raw, image_raw_ts, image_raw_event_inds}``,
    events as [x, y, t, p] rows with p in {-1, +1}) and ``<split>_gt.hdf5``
    (``davis/left/{flow_dist, flow_dist_ts}``). Only the ``n_real`` frames
    from the split's first valid raw index on carry simulated content (every
    other frame is zeros and is never read), so items 0 .. n_real - 3 of the
    split are backed by consistent events, frames and GT flow. Eight pad
    events after the last real frame keep every pair's end index inside the
    events (the reader asserts it); a zero GT map before the first real
    frame and two after the last keep the flow search inside the maps.
    Returns (data path, GT path)."""
    from .mvsec import VALID_TIME_INDEX

    shift, maxi = VALID_TIME_INDEX[split]
    n_total = maxi + 2
    sim = simulate_sequence(seed, n_real, h, w, fps=fps, **sim_kw)

    ts_global = np.arange(n_total, dtype=np.float64) / fps
    images = np.zeros((n_total, h, w), np.uint8)
    for k, frame in enumerate(sim["frames"]):
        images[shift + k] = np.round(frame * 255).astype(np.uint8)

    off = ts_global[shift]
    ev_rows = [np.stack([x.astype(np.float64), y.astype(np.float64), t + off,
                         (2 * p - 1).astype(np.float64)], axis=1)
               for (t, x, y, p) in sim["events"]]
    t_last = ts_global[shift + n_real - 1] + 1e-4
    pad = np.array([[0.0, 0.0, t_last + 1e-6 * i, 1.0] for i in range(8)])
    events = np.concatenate(ev_rows + [pad], axis=0)
    inds = np.searchsorted(events[:, 2], ts_global, side="left")

    zero = np.zeros((1, 2, h, w), np.float32)
    flow = np.concatenate([zero, sim["flow01"].astype(np.float32), zero, zero], axis=0)
    flow_ts = np.concatenate([
        [ts_global[shift] - 1.0 / fps],
        ts_global[shift:shift + n_real - 1],
        [ts_global[shift + n_real - 1], ts_global[shift + n_real]]])

    os.makedirs(outdir, exist_ok=True)
    data_path = os.path.join(outdir, f"{split}_data.hdf5")
    gt_path = os.path.join(outdir, f"{split}_gt.hdf5")
    hdf5.write_h5(data_path, {"davis/left/events": events, "davis/left/image_raw": images,
                              "davis/left/image_raw_ts": ts_global,
                              "davis/left/image_raw_event_inds": inds.astype(np.int64)})
    hdf5.write_h5(gt_path, {"davis/left/flow_dist": flow,
                            "davis/left/flow_dist_ts": flow_ts.astype(np.float64)})
    return data_path, gt_path


def chairs2_rgb(frame: np.ndarray) -> np.ndarray:
    """A simulated grey frame in [0, 1] as an RGB uint8 frame whose hue
    varies with the intensity (R = f, G = f^0.7, B = 1 - 0.8 f)."""
    rgb = np.stack([frame, frame ** 0.7, 1.0 - 0.8 * frame], axis=-1)
    return np.round(np.clip(rgb, 0, 1) * 255).astype(np.uint8)


def write_chairs2_dataset(outroot: str, n_samples: int, h: int = 384, w: int = 512,
                          seed: int = 0, split: str = "train", **sim_kw) -> list:
    """A FlyingChairs2-layout folder from the simulator: per sample the
    pair of a 2-frame simulated sequence (seed ``seed + i``) as RGB PNGs
    (``chairs2_rgb``) ``<split>/<id>-img_0.png``, ``-img_1.png`` with every
    row Paeth-filtered (an adaptive encoder may pick Paeth for any row;
    it is the slowest filter to decode), its flows
    both ways as ``-flow_01.flo``/``-flow_10.flo``, and its events as
    ``events_<split>/<id>-event.hdf5`` (x, y, t in seconds, p in {-1, +1})
    through the port's HDF5 writer; ids ``%07d``. Returns the ids."""
    from .file_io import write_flo

    img_dir = os.path.join(outroot, split)
    ev_dir = os.path.join(outroot, "events_" + split)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ev_dir, exist_ok=True)
    ids = []
    for i in range(n_samples):
        sq = simulate_sequence(seed + i, 2, h, w, **sim_kw)
        sid = f"{i:07d}"
        for k in range(2):                               # write_png takes BGR
            write_png(os.path.join(img_dir, f"{sid}-img_{k}.png"),
                      chairs2_rgb(sq["frames"][k])[:, :, ::-1], row_filter=4)
        write_flo(os.path.join(img_dir, f"{sid}-flow_01.flo"), sq["flow01"][0].transpose(1, 2, 0))
        write_flo(os.path.join(img_dir, f"{sid}-flow_10.flo"), sq["flow10"][0].transpose(1, 2, 0))
        t, x, y, p = sq["events"][0]
        hdf5.write_h5(os.path.join(ev_dir, f"{sid}-event.hdf5"),
                      {"x": x.astype(np.int64), "y": y.astype(np.int64), "t": t,
                       "p": (2 * p - 1).astype(np.int64)})
        ids.append(sid)
    return ids


class SimFlowPairs:
    """Independent (events, I0, I1, flow01) samples of the simulated
    training layout, the flow-pretraining set of ``pretrain_flow --data_kind
    sim`` (counterpart of cista_flow_tpu/data/sim.py:357-423): each line of
    the index is one item of CHW float32 arrays, voxelized and normalised
    as the composite's training loader does it, so a flow net pretrained
    here drops into the composite's schedule. Item keys: ``event_voxel``,
    ``gt_img0``/``gt_img1`` (1, H, W), ``gt_flow`` (the generator's forward
    ``flow01``, no warp-mode sign), ``valid``; with ``is_bi`` also
    ``gt_flow_bw`` (``flow10``) and, with reversed events, ``event_voxel_bw``;
    for cista-eraft ``event_voxel_old``. ``aug`` flips each item
    horizontally and vertically with probability 1/2 each (negating the
    matching flow component), drawn from ``default_rng(seed + 9173)`` in
    the JAX class's order."""

    def __init__(self, cfgs, train_data_txt: str | None = None, aug: bool = False):
        from .train_loader import TrainSequenceDataset
        txt = train_data_txt or os.path.join(cfgs.path_to_train_data, "train_e2v_estflow.txt")
        self.ds = TrainSequenceDataset(txt, cfgs)
        self.is_bi = cfgs.is_bi
        self.aug = aug
        self._rng = np.random.default_rng(getattr(cfgs, "seed", 0) + 9173)

    def __len__(self):
        return len(self.ds.event_paths)

    def __getitem__(self, i):
        bd, bt = self.ds.get_step(i, load_flow=False)
        f = np.load(os.path.join(self.ds.root, self.ds.flow_paths[i]))
        h, w = bt["gt_img0"].shape[-2:]
        item = {"event_voxel": bd["event_voxel"].astype(np.float32),
                "gt_img0": bt["gt_img0"].astype(np.float32),
                "gt_img1": bt["gt_img1"].astype(np.float32),
                "gt_flow": f["flow01"].astype(np.float32),
                "valid": np.ones((1, h, w), np.float32)}
        if self.is_bi:
            item["gt_flow_bw"] = f["flow10"].astype(np.float32)
            if "event_voxel_bw" in bd:
                item["event_voxel_bw"] = bd["event_voxel_bw"].astype(np.float32)
        if "event_voxel_old" in bd:
            item["event_voxel_old"] = bd["event_voxel_old"].astype(np.float32)
        if self.aug:
            for axis, comp in ((-1, 0), (-2, 1)):        # horizontal, then vertical
                if self._rng.random() < 0.5:
                    item = {k: np.ascontiguousarray(np.flip(v, axis)) for k, v in item.items()}
                    for k in ("gt_flow", "gt_flow_bw"):
                        if k in item:
                            item[k][comp] = -item[k][comp]
        return item


def main(argv=None) -> int:
    """Write simulated eval sequences (``--mode eval``: ``--n_sequences``
    folders ``sim_NN`` from seeds ``seed + NN``) or a training set
    (``--mode train``: ``--n_videos`` videos and their index)."""
    ap = argparse.ArgumentParser(description="ESIM-style simulated event data")
    ap.add_argument("--out", required=True)
    ap.add_argument("--mode", choices=("eval", "train"), default="eval")
    ap.add_argument("--image_dim", nargs=2, type=int, default=(180, 240))
    ap.add_argument("--n_frames", type=int, default=30)
    ap.add_argument("--n_videos", type=int, default=8, help="training mode: number of sequences")
    ap.add_argument("--n_sequences", type=int, default=1,
                    help="eval mode: number of sequence folders")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fps", type=float, default=25.0)
    ap.add_argument("--substeps", type=int, default=10)
    ap.add_argument("--contrast", type=float, default=0.18)
    ap.add_argument("--speed", type=float, default=60.0, help="texture translation, px/s")
    ap.add_argument("--omega", type=float, default=0.25, help="rotation rad/s")
    args = ap.parse_args(argv)

    h, w = args.image_dim
    kw = dict(fps=args.fps, substeps=args.substeps, c_pos=args.contrast, c_neg=args.contrast,
              speed=args.speed, omega=args.omega)
    if args.mode == "train":
        path = write_train_dataset(args.out, args.n_videos, args.n_frames, h, w, seed=args.seed,
                                   **kw)
        print(f"wrote {path}")
    else:
        for s in range(args.n_sequences):
            sd = os.path.join(args.out, f"sim_{s:02d}")
            write_eval_sequence(sd, simulate_sequence(args.seed + s, args.n_frames, h, w, **kw))
            print(f"wrote {sd}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
