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

Eval layout (ref: data_readers/video_readers.py:343-457):
  - frames ``frame_%04d.png`` (uint8 grayscale), ``timestamps.txt`` lines
    ``<name> <t_seconds>``
  - per-interval events ``events_%06d.npz`` with t (s), x, y, p (0/1;
    1 = brightening), time-sorted
  - per-interval flow ``flow_%06d.npz`` with ``flow01``/``flow10`` arrays
    of shape (2, H, W), channel 0 = x-displacement, channel 1 = y
"""
from __future__ import annotations

import os

import numpy as np

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
