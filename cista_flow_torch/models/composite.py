"""The cista-eiflow composite step (NCHW).

Counterpart of cista_flow_tpu/models/composite.py for ``cista-eiflow``
(ref: e2v/e2v_model.py:138-308): estimate flow with DCEIFlow from the
events and the previous reconstruction, warp the previous frame and the
recurrent sparse code along it (kernel K2), then reconstruct with
CISTA-LSTC.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .. import weights
from ..config import Config
from ..device import resolve_device
from ..ops.resize import interpolate_scale
from ..ops.warp import frame_warp
from .cista_lstc import CistaLSTC, CistaState
from .cista_lstc import zero_state as _cista_zero_state
from .dceiflow import DCEIFlow


class CistaEIFlow(nn.Module):
    """Module names match the reference checkpoint: ``cista_net.*`` and
    ``event_flownet.*``."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.model_mode != "cista-eiflow":
            raise ValueError(f"model_mode {cfg.model_mode!r} is not ported yet; "
                             "only cista-eiflow is")
        self.cfg = cfg
        self.cista_net = CistaLSTC(cfg.num_bins, cfg.base_channels, cfg.depth)
        self.event_flownet = DCEIFlow(cfg.num_bins, cfg.ds)

    def load_reference_state(self, sd: dict) -> None:
        """Strict load of a reference-layout state dict (numpy or tensors);
        the tied ISTA block's keys are matched to this model's depth."""
        sd = weights.tie_ista_blocks(sd, self.cfg.depth)
        self.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                             strict=True)

    def _warp_inputs(self, rec_img0, state: CistaState, flow_final):
        """Warp the previous frame (full res) and the sparse code (half res)
        along the flow, keeping the reference's zero-flow short-circuit
        (ref: e2v_model.py:184-185) as a device-side select: no host sync."""
        cfg = self.cfg
        warped_i = frame_warp(rec_img0, flow_final, mode=cfg.warp_mode)
        half_flow = interpolate_scale(flow_final, cfg.scale_factor,
                                      align_corners=True)
        warped_z = frame_warp(state.sparse_code, half_flow, mode=cfg.warp_mode)
        any_flow = torch.any(flow_final != 0)
        warped_i = torch.where(any_flow, warped_i, rec_img0)
        warped_z = torch.where(any_flow, warped_z, state.sparse_code)
        return warped_i, state._replace(sparse_code=warped_z)

    def forward(self, events, rec_img0, state: CistaState, iters=None,
                collect_preds: bool = False):
        """One reconstruction step. events (B, bins, H, W), rec_img0
        (B, 1, H, W) in the compute dtype. Returns (rec, batch_flow,
        new_state)."""
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        batch_flow = self.event_flownet(events, rec_img0, iters=iters,
                                        collect_preds=collect_preds)
        warped_i, state = self._warp_inputs(rec_img0, state,
                                            batch_flow["flow_final"])
        rec, new_state = self.cista_net(events, warped_i, state)
        return rec, batch_flow, new_state


def init(cfg: Config, device=None, seed: int | None = None) -> CistaEIFlow:
    """A composite with random weights made from ``seed`` (default
    ``cfg.seed``), on ``device`` (default: the GPU; raises without one)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        model = CistaEIFlow(cfg)
    return model.to(dev).eval()


def zero_state(batch: int, cfg: Config, dtype=torch.float32,
               device=None) -> CistaState:
    return _cista_zero_state(batch, cfg.image_dim, cfg.base_channels, dtype,
                             resolve_device(device))
