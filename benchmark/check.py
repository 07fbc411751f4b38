"""The comparison that decides ``correct``.

Once the window has closed and the program is freed, the plain reference
(``reference.make_streams``, f32 with TF32 off) runs the closed recurrence
again from the same voxels, and each frame and flow that the timed path
returned for a compared stream is held against the reference's:

* every stream over the window's first ``all_streams_calls`` calls;
* ``SAMPLED_STREAMS`` streams, drawn from the seed, over the whole window.

Per compared frame: the RMSE of the frame (intensities in [0, 1]) and the
mean end-point error of the flow (pixels). The readings are the largest
frame RMSE and flow EPE over everything compared, and the largest frame
RMSE over the first calls alone (``frame_rmse_first``: before the loop's
drift builds up). A reading whose limit in the cell's file is null is
reported and not compared.
"""
from __future__ import annotations

import numpy as np
import torch

import reference

READINGS = ("frame_rmse", "frame_rmse_first", "flow_epe")
SAMPLED_STREAMS = 1       # followed over the whole window: the reference's time grows with it


def sample_streams(seed: int, streams: int, k: int) -> list:
    rng = np.random.default_rng([seed % 2 ** 63, 2])
    return sorted(int(s) for s in rng.choice(streams, size=min(k, streams), replace=False))


class Plan:
    """Which streams are compared in each call of a window."""

    def __init__(self, seed: int, streams: int, check: dict):
        self.everyone = list(range(streams))
        self.sampled = sample_streams(seed, streams, SAMPLED_STREAMS)
        self.prefix = check["all_streams_calls"]

    def streams(self, call: int) -> list:
        return self.everyone if call < self.prefix else self.sampled

    def keep(self, call: int, frames, flows):
        """What the check needs of a call's host output: all of it in the
        first calls, a copy of the sampled streams' slices after them (so
        the program's own arrays are freed, as a client's would be)."""
        if call < self.prefix:
            return frames, flows
        s = self.sampled
        return np.ascontiguousarray(frames[:, s]), np.ascontiguousarray(flows[:, s])


class Worst:
    """The largest frame RMSE and flow EPE seen, and where."""

    def __init__(self):
        self.value = dict.fromkeys(READINGS, 0.0)
        self.at = dict.fromkeys(READINGS, None)
        self.frames = 0

    def add(self, call, first, streams, frames, flows, ref_frames, ref_flows):
        """frames (T, S, H, W) and flows (T, S, 2, H, W) against the
        reference's, on one device, f32; ``first``: a call of the prefix."""
        rmse = (frames - ref_frames).square().mean(dim=(2, 3)).sqrt()
        epe = (flows - ref_flows).square().sum(dim=2).sqrt().mean(dim=(2, 3))
        readings = [("frame_rmse", rmse), ("flow_epe", epe)]
        if first:
            readings.append(("frame_rmse_first", rmse))
        for key, err in readings:
            v = float(err.max())
            if not np.isfinite(v):
                v = float("inf")
            if v > self.value[key] or self.at[key] is None:
                t, s = divmod(int(torch.argmax(torch.nan_to_num(err, nan=float("inf")))),
                              err.shape[1])
                self.value[key], self.at[key] = v, (call, t, streams[s])
        self.frames += frames.shape[0] * frames.shape[1]


def compare(outputs, pool, seed: int, cfg: dict, mix: dict, check: dict, params: dict,
            device, rounding=None, calls: int | None = None) -> Worst:
    """Hold the program's ``outputs`` [(frames (T, S, H, W), flows (T, S,
    2, H, W)) of the compared streams of each call, ``Plan.keep``] against
    the reference run over the same calls of ``pool``. ``outputs`` None
    compares the reference computed with ``rounding`` (the control)
    instead of the program, over ``calls`` calls."""
    hw = (mix["height"], mix["width"])
    b = mix["streams"]
    calls = calls if outputs is None else len(outputs)
    plan = Plan(seed, b, check)
    chunk = mix["steps_per_call"]
    ref = reference.make_streams(params, cfg, b, hw, device, flow_chunk=chunk)
    other = None
    if outputs is None:
        other = reference.make_streams(params, cfg, b, hw, device, rounding=rounding,
                                       flow_chunk=chunk)
    worst = Worst()
    kept = plan.everyone
    for c in range(calls):
        streams = plan.streams(c)
        if streams != kept:
            ref.keep([kept.index(s) for s in streams])
            if other is not None:
                other.keep([kept.index(s) for s in streams])
            kept = streams
        vox = torch.from_numpy(pool[c % len(pool)]).to(device)
        if mix["steps_per_call"] == 1:
            vox = vox[None]
        vox = vox[:, streams]
        ref_frames, ref_flows = ref.steps(vox)
        if other is None:
            frames, flows = outputs[c]
            if frames.shape[1] != len(streams):
                frames, flows = frames[:, streams], flows[:, streams]
            frames = torch.from_numpy(np.ascontiguousarray(frames)).to(device)
            flows = torch.from_numpy(np.ascontiguousarray(flows)).to(device)
        else:
            frames, flows = other.steps(vox)
        worst.add(c, c < plan.prefix, streams, frames.float(), flows.float(), ref_frames,
                  ref_flows)
    return worst
