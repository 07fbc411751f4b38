"""The traffic of a cell: event voxels of simulated camera streams.

A frozen transcription, in torch float64 so that it runs on the card in
set-up, of the port's ESIM-style simulator (``cista_flow_torch/data/sim.py``:
a multi-octave texture under a time-varying affine motion, events at every
log-intensity threshold crossing over ``substeps`` render points per frame
interval) and of its std-normalised voxel grid
(``cista_flow_torch/events/voxel.py``: bilinear split of each event between
two time bins, then the nonzero entries to zero mean and unit variance).
The event list is never built: every crossing of a substep is one dense
plane, so the voxels are the same on every run of a seed.

Each stream has its own texture and motion, drawn from the run's seed and
its index. A stream is ``frames - 1`` voxels played forward, then the
time-reversed voxels back (bins in reverse order, polarity negated), and
so on: one continuous sequence of any length from a pool of
``2 * (frames - 1)`` voxels, which set-up makes once.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """sim._bilinear_resize: half-pixel centres, edges clamped."""
    ih, iw = img.shape
    ys = (torch.arange(h, dtype=img.dtype, device=img.device) + 0.5) * ih / h - 0.5
    xs = (torch.arange(w, dtype=img.dtype, device=img.device) + 0.5) * iw / w - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return _sample_bilinear(img[None], gx[None], gy[None])[0]


def _sample_bilinear(img, gx, gy):
    """sim._sample_bilinear of each image of ``img`` (N, ih, iw) at its
    coordinates (N, H, W), edges clamped."""
    n, ih, iw = img.shape
    gx = gx.clamp(0.0, iw - 1.0)
    gy = gy.clamp(0.0, ih - 1.0)
    x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
    x1, y1 = (x0 + 1).clamp(max=iw - 1), (y0 + 1).clamp(max=ih - 1)
    fx, fy = gx - x0, gy - y0
    flat = img.reshape(n, ih * iw)

    def at(yi, xi):
        return torch.gather(flat, 1, (yi * iw + xi).reshape(n, -1)).reshape(gx.shape)
    return (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x1) * fx * (1 - fy)
            + at(y1, x0) * (1 - fx) * fy + at(y1, x1) * fx * fy)


def smooth_texture(rng: np.random.Generator, h, w, device, octaves=4, lo=0.08, hi=1.0):
    """sim.smooth_texture: the coarse grids drawn on the host, in its order."""
    tex = torch.zeros((h, w), dtype=torch.float64, device=device)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        ch, cw = max(2, h >> (octaves - 1 - o)), max(2, w >> (octaves - 1 - o))
        coarse = torch.from_numpy(rng.random((ch, cw))).to(device)
        tex += amp * _resize_bilinear(coarse, h, w)
        total += amp
        amp *= 0.55
    tex /= total
    tex = (tex - tex.min()) / (tex.max() - tex.min()).clamp(min=1e-9)
    return lo + (hi - lo) * tex


def streams_voxels(seeds: list, p: dict, device) -> torch.Tensor:
    """(streams, frames - 1, bins, H, W) float32 voxels of simulated
    streams, one a seed, all computed together; ``p`` holds the traffic
    file's simulator parameters. Per stream: sim.simulate_sequence's
    texture and sim.AffineMotion (rotation about the centre, translation
    with a constant acceleration), then the voxels of its events."""
    h, w, n = p["height"], p["width"], p["frames"]
    fps, speed, substeps = p["fps"], p["speed"], p["substeps"]
    c_pos, c_neg, log_eps, bins = p["c_pos"], p["c_neg"], p["log_eps"], p["bins"]
    margin = int(math.ceil(speed * n / fps + 0.3 * max(h, w))) + 4
    tex, motion = [], []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        tex.append(smooth_texture(rng, h + 2 * margin, w + 2 * margin, device))
        ang = rng.uniform(0, 2 * np.pi)
        motion.append((speed * math.cos(ang), speed * math.sin(ang),
                       -0.15 * speed * math.cos(ang), -0.15 * speed * math.sin(ang),
                       p["omega"] * rng.choice([-1.0, 1.0])))
    tex = torch.stack(tex)
    vx, vy, ax, ay = (torch.tensor(c, dtype=torch.float64, device=device)[:, None, None]
                      for c in list(zip(*motion))[:4])
    omegas = [m[4] for m in motion]
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    py, px = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    dx, dy = px - cx, py - cy

    def log_frame(t):
        cos, sin = (torch.tensor([f(om * t) for om in omegas], dtype=torch.float64,
                                 device=device)[:, None, None] for f in (math.cos, math.sin))
        ux = cos * dx - sin * dy + cx + (vx * t + 0.5 * ax * t * t)
        uy = sin * dx + cos * dy + cy + (vy * t + 0.5 * ay * t * t)
        return torch.log(log_eps + _sample_bilinear(tex, ux + margin, uy + margin))

    ts = [i / fps for i in range(n)]
    ref = log_frame(ts[0])
    out = []
    for i in range(n - 1):
        taus = np.linspace(ts[i], ts[i + 1], substeps + 1)
        l0 = log_frame(taus[0])
        crossings = []                       # (t, polarity, present) planes
        for k in range(substeps):
            l1 = log_frame(taus[k + 1])
            diff = l1 - ref
            pos = diff > 0
            count = torch.where(pos, torch.floor(diff / c_pos), torch.floor(-diff / c_neg))
            count = count.clamp(min=0)
            step = torch.where(pos, torch.full_like(diff, c_pos), torch.full_like(diff, -c_neg))
            slope = l1 - l0
            slope = torch.where(slope.abs() < 1e-12, torch.full_like(slope, math.inf), slope)
            pol = torch.where(pos, 1.0, -1.0).to(torch.float64)
            for j in range(1, int(count.max()) + 1):
                frac = ((ref + j * step - l0) / slope).clamp(0.0, 1.0)
                crossings.append((taus[k] + (taus[k + 1] - taus[k]) * frac, pol, count >= j))
            ref = ref + count * step
            l0 = l1
        out.append(_voxels(crossings, bins, (len(seeds), h, w), device))
    return torch.stack(out, 1)


def _voxels(crossings, bins, shape, device) -> torch.Tensor:
    """events_to_voxel_grid then event_preprocess('std') of each stream's
    events over the interval, given as dense crossing planes (N, H, W)."""
    vox = torch.zeros((shape[0], bins, *shape[1:]), dtype=torch.float64, device=device)
    if not crossings:
        return vox.float()
    inf = torch.tensor(math.inf, dtype=torch.float64, device=device)
    t_first = torch.stack([torch.where(m, t, inf).amin(dim=(1, 2)) for t, _, m in crossings])
    t_last = torch.stack([torch.where(m, t, -inf).amax(dim=(1, 2)) for t, _, m in crossings])
    t_first, t_last = t_first.amin(0)[:, None, None], t_last.amax(0)[:, None, None]
    dt = torch.where(t_last > t_first, t_last - t_first, torch.ones_like(t_last))
    for t, pol, m in crossings:
        ts = (bins - 1) * (t - t_first) / dt
        ti = torch.floor(ts)
        frac = ts - ti
        left = torch.where(m, pol * (1.0 - frac), 0.0)
        right = torch.where(m & (ti + 1 < bins), pol * frac, 0.0)
        # one bin a pixel each: no two writes meet, so the sums are exact in order
        ti = torch.where(m, ti, 0.0).long()
        vox.scatter_add_(1, ti[:, None], left[:, None])
        vox.scatter_add_(1, (ti + 1).clamp(max=bins - 1)[:, None], right[:, None])
    vox = vox.float()
    nonzero = vox != 0
    num = nonzero.sum(dim=(1, 2, 3), keepdim=True)
    v64 = vox.double()
    mean = v64.sum(dim=(1, 2, 3), keepdim=True) / num.clamp(min=1)
    std = torch.sqrt((v64 ** 2).sum(dim=(1, 2, 3), keepdim=True) / num.clamp(min=1) - mean ** 2)
    return torch.where(num > 0, nonzero * (v64 - mean) / (std + 1e-8), v64).float()


def reversed_voxels(v: torch.Tensor) -> torch.Tensor:
    """The voxels of the same interval played backwards: bins reversed,
    polarities negated (the std normalisation commutes with both)."""
    return -torch.flip(v, dims=(-3,))


def stream_seed(seed: int, stream: int) -> int:
    return int(np.random.SeedSequence([seed % 2 ** 63, stream]).generate_state(1)[0])


def make_pool(seed: int, traffic: dict, device) -> list:
    """The host pool a cell's window walks through in order: a list of
    float32 arrays in the layout of one call, (B, bins, H, W) for a call
    of one step, (T, B, bins, H, W) for a window of T. Its length is the
    period of the forward-and-back sequence, in calls."""
    b, steps = traffic["streams"], traffic["steps_per_call"]
    fwd = streams_voxels([stream_seed(seed, s) for s in range(b)], traffic, device)
    seq = torch.cat([fwd, reversed_voxels(fwd.flip(1))], 1).transpose(0, 1)
    seq = seq.cpu().numpy()                               # (period, B, bins, H, W)
    period = seq.shape[0]
    if period % steps:
        raise ValueError(f"a period of {period} voxels is not whole calls of {steps} steps")
    if steps == 1:
        return [np.ascontiguousarray(seq[i]) for i in range(period)]
    return [np.ascontiguousarray(seq[i:i + steps]) for i in range(0, period, steps)]
