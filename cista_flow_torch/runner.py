"""Streaming reconstructor for the cista-eiflow serving step.

Counterpart of cista_flow_tpu/runner.py ``Reconstructor`` (ref:
test_with_flow.py:24-88) for ``cista-eiflow``: build the composite, load
``cfg.path_to_test_model`` (reference key layout), then step it in a closed
loop. ``step_window`` runs a whole window on the device as a Python loop
and copies to the host once at the end.
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
        self.reset()

    def reset(self):
        """New sequence: zero state and zero previous frame."""
        h, w = self.image_dim
        self.state = composite.zero_state(self.batch, self.cfgs, self.dtype,
                                          self.device)
        self.prev_image = torch.zeros((self.batch, 1, h, w), dtype=self.dtype,
                                      device=self.device)

    @torch.no_grad()
    def run_window(self, events: torch.Tensor):
        """events: (T, B, bins, H, W) on the device in the compute dtype.
        Returns recs (T, B, 1, H, W) and flows (T, B, 2, H, W) on the device,
        and carries the state and the last frame to the next call."""
        recs, flows = [], []
        rec, state = self.prev_image, self.state
        for ev in events:
            rec, batch_flow, state = self.model(ev, rec, state, iters=self.iters)
            recs.append(rec)
            flows.append(batch_flow["flow_final"])
        self.prev_image, self.state = rec, state
        return torch.stack(recs), torch.stack(flows)

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
        when B > 1."""
        return self.step_window(np.asarray(voxel_chw)[None])

    def step_window(self, voxels, return_all: bool = False):
        """T reconstructions, one host transfer. ``voxels``: a list or array
        of (bins, H, W) voxels (or (T, B, bins, H, W)). Returns the last
        step's (rec (H, W), flow (2, H, W)), or with ``return_all`` every
        step's (recs (T, H, W), flows (T, 2, H, W)); a batch axis follows T
        when B > 1."""
        if len(voxels) == 0:
            raise ValueError("empty window")
        recs, flows = self.run_window(self.device_events(voxels))
        recs = recs[:, :, 0].float().cpu().numpy()
        flows = flows.float().cpu().numpy()
        if self.batch == 1:
            recs, flows = recs[:, 0], flows[:, 0]
        if return_all:
            return recs, flows
        return recs[-1], flows[-1]
