"""Streaming reconstructor for the cista-eiflow and cista-eraft serving steps.

Counterpart of cista_flow_tpu/runner.py ``Reconstructor`` (ref:
test_with_flow.py:24-88): build the composite, load
``cfg.path_to_test_model`` (reference key layout), then step it in a closed
loop. ``step_window`` runs a whole window on the device and copies to the
host once at the end: a Python loop over the steps for cista-eiflow, the
time-parallel window (all flows in one call, then the recurrence) for
cista-eraft, whose flow needs the previous voxel and no reconstruction.
"""
from __future__ import annotations

import numpy as np
import torch

from . import weights
from .device import DTYPES, resolve_device
from .models import composite


class Reconstructor:
    """Closed-loop reconstructor over a batch of ``batch`` streams."""

    def __init__(self, cfg, device=None, batch: int = 1):
        self.cfgs = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.batch = batch
        self.image_dim = tuple(cfg.image_dim)
        self.model = composite.init(cfg, device="cpu")
        if cfg.path_to_test_model:
            self.model.load_reference_state(
                weights.load_state_dict(cfg.path_to_test_model))
        self.model.to(self.device, self.dtype)
        self.iters = cfg.default_flow_iters()
        self.eraft = cfg.model_mode == "cista-eraft"
        self.reset()

    def reset(self):
        """New sequence: zero state, zero previous frame and, for
        cista-eraft, a zero previous voxel (``extra``)."""
        h, w = self.image_dim
        self.state = composite.zero_state(self.batch, self.cfgs, self.dtype,
                                          self.device)
        self.prev_image = torch.zeros((self.batch, 1, h, w), dtype=self.dtype,
                                      device=self.device)
        self.extra = torch.zeros((self.batch, self.cfgs.num_bins, h, w),
                                 dtype=self.dtype, device=self.device) if self.eraft else None

    @torch.no_grad()
    def run_step(self, events: torch.Tensor):
        """One step on the device: events (B, bins, H, W) in the compute
        dtype -> (rec (B, 1, H, W), flow (B, 2, H, W)); carries the state,
        the frame and the previous voxel."""
        if self.eraft:
            rec, batch_flow, self.state = self.model(
                events, self.prev_image, self.state, self.extra, iters=self.iters)
            self.extra = events
        else:
            rec, batch_flow, self.state = self.model(
                events, self.prev_image, self.state, iters=self.iters)
        self.prev_image = rec
        return rec, batch_flow["flow_final"]

    @torch.no_grad()
    def run_window(self, events: torch.Tensor):
        """events: (T, B, bins, H, W) on the device in the compute dtype.
        Returns recs (T, B, 1, H, W) and flows (T, B, 2, H, W) on the device,
        and carries the state, the last frame and (cista-eraft) the last
        voxel to the next call."""
        if self.eraft:
            recs, flows, self.state = self.model.forward_window(
                torch.cat([self.extra[None], events]), self.prev_image,
                self.state, iters=self.iters)
            self.prev_image, self.extra = recs[-1], events[-1]
            return recs, flows
        out = [self.run_step(ev) for ev in events]
        return torch.stack([r for r, _ in out]), torch.stack([f for _, f in out])

    def device_events(self, voxels) -> torch.Tensor:
        v = np.asarray(voxels, np.float32)
        if v.ndim == 4:                  # (T, bins, H, W): one stream
            v = v[:, None]
        if v.shape[1] != self.batch:
            raise ValueError(f"voxels for {v.shape[1]} streams, reconstructor "
                             f"has {self.batch}")
        return torch.from_numpy(v).to(self.device, self.dtype)

    def step(self, voxel_chw: np.ndarray):
        """One reconstruction. voxel: (bins, H, W) (or (B, bins, H, W)).
        Returns (rec (H, W), flow (2, H, W)) as f32 numpy, batch axis kept
        when B > 1. For cista-eraft this is the stepwise path (fnet on the
        previous and the current voxel); ``step_window`` is the
        time-parallel one."""
        rec, flow = self.run_step(self.device_events(np.asarray(voxel_chw)[None])[0])
        return self._to_host(rec[None], flow[None], return_all=False)

    def step_window(self, voxels, return_all: bool = False):
        """T reconstructions, one host transfer. ``voxels``: a list or array
        of (bins, H, W) voxels (or (T, B, bins, H, W)). Returns the last
        step's (rec (H, W), flow (2, H, W)), or with ``return_all`` every
        step's (recs (T, H, W), flows (T, 2, H, W)); a batch axis follows T
        when B > 1."""
        if len(voxels) == 0:
            raise ValueError("empty window")
        recs, flows = self.run_window(self.device_events(voxels))
        return self._to_host(recs, flows, return_all)

    def _to_host(self, recs, flows, return_all: bool):
        recs = recs[:, :, 0].float().cpu().numpy()
        flows = flows.float().cpu().numpy()
        if self.batch == 1:
            recs, flows = recs[:, 0], flows[:, 0]
        if return_all:
            return recs, flows
        return recs[-1], flows[-1]
