"""The cista-eiflow and cista-eraft composite steps (NCHW).

Counterpart of cista_flow_tpu/models/composite.py (ref:
e2v/e2v_model.py:138-308): estimate flow (DCEIFlow from the events and the
previous reconstruction, or E-RAFT from two consecutive voxels), warp the
previous frame and the recurrent sparse code along it (kernel K2), then
reconstruct with CISTA-LSTC. For cista-eraft there is also the
time-parallel window, the twin of ``apply_sequence_eraft``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn as nn

from .. import weights
from ..config import Config
from ..device import resolve_device
from ..ops.pad import ImagePadder
from ..ops.resize import interpolate_scale
from ..ops.warp import frame_warp
from .cista_lstc import CistaLSTC, CistaState
from .cista_lstc import zero_state as _cista_zero_state
from .dceiflow import DCEIFlow
from .eraft import ERAFT


class _Composite(nn.Module):
    """What the composites share: the CISTA-LSTC reconstructor under the
    reference's name ``cista_net``, the strict load, and the warps."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        self.cista_net = CistaLSTC(cfg.num_bins, cfg.base_channels, cfg.depth)

    def load_reference_state(self, sd: dict) -> None:
        """Strict load of a reference-layout state dict (numpy or tensors);
        the tied ISTA block's keys are matched to this model's depth."""
        sd = weights.tie_ista_blocks(sd, self.cfg.depth)
        self.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                             strict=True)

    def _warp_inputs(self, rec_img0, state: CistaState, flow_final):
        """Warp the previous frame (full res) and the sparse code (half res)
        along the flow, keeping the reference's zero-flow short-circuit
        (ref: e2v_model.py:184-185): both warps take the device-side gate
        ``any(flow != 0)`` and select inside the kernel, with no host sync."""
        cfg = self.cfg
        any_flow = torch.any(flow_final)        # nonzero, as flow != 0
        warped_i = frame_warp(rec_img0, flow_final, mode=cfg.warp_mode, gate=any_flow)
        half_flow = interpolate_scale(flow_final, cfg.scale_factor,
                                      align_corners=True)
        warped_z = frame_warp(state.sparse_code, half_flow, mode=cfg.warp_mode,
                              gate=any_flow)
        return warped_i, state._replace(sparse_code=warped_z)

    def reconstruct(self, events, rec_img0, state: CistaState, flow_final):
        """Warp along ``flow_final``, then CISTA-LSTC: (rec, new_state)."""
        warped_i, state = self._warp_inputs(rec_img0, state, flow_final)
        return self.cista_net(events, warped_i, state)


class CistaEIFlow(_Composite):
    """cista-eiflow (ref: e2v/e2v_model.py DCEIFlowCistaNet): the flow comes
    from the events and the previous reconstruction. Module names match the
    reference checkpoint: ``cista_net.*`` and ``event_flownet.*``."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.event_flownet = DCEIFlow(cfg.num_bins, cfg.ds)

    def forward(self, events, rec_img0, state: CistaState, iters=None,
                collect_preds: bool = False):
        """One reconstruction step. events (B, bins, H, W), rec_img0
        (B, 1, H, W) in the compute dtype. Returns (rec, batch_flow,
        new_state)."""
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        batch_flow = self.event_flownet(events, rec_img0, iters=iters,
                                        collect_preds=collect_preds)
        rec, new_state = self.reconstruct(events, rec_img0, state,
                                          batch_flow["flow_final"])
        return rec, batch_flow, new_state


class CistaERAFT(_Composite):
    """cista-eraft (ref: e2v/e2v_model.py ERAFTCistaNet): the flow comes
    from the previous and the current voxel alone, never from a
    reconstruction, so a window's flows need not wait for its frames."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.event_flownet = ERAFT(cfg.num_bins)

    def forward(self, events, rec_img0, state: CistaState, event_voxel_old,
                iters=None, collect_preds: bool = False):
        """One reconstruction step; ``event_voxel_old`` is the previous
        step's voxel (zeros at the start of a stream). Returns (rec,
        batch_flow, new_state)."""
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        batch_flow = self.event_flownet(event_voxel_old, events, iters=iters,
                                        collect_preds=collect_preds)
        rec, new_state = self.reconstruct(events, rec_img0, state,
                                          batch_flow["flow_final"])
        return rec, batch_flow, new_state

    def window_flows(self, voxel_seq, iters: int):
        """Flows of a whole window, (T, B, 2, H, W), from voxel_seq
        (T+1, B, bins, H, W): each voxel's fnet features are computed once
        ((T+1)*B samples in one call; stepping encodes every interior voxel
        twice), cnet runs on the T newer voxels, and the GRU iterations run
        over all T*B pairs at once, or over ``cfg.eraft_tchunk`` time steps
        at a time, which bounds the live correlation volume."""
        t1, b = voxel_seq.shape[:2]
        t_len = t1 - 1
        net = self.event_flownet
        padder = ImagePadder(voxel_seq.shape[3:], min_size=32)
        padded = padder.pad(voxel_seq.reshape(t1 * b, *voxel_seq.shape[2:]))
        fmaps = net.fnet(padded)
        fmap1, fmap2 = fmaps[:t_len * b], fmaps[b:]
        cnet = net.cnet(padded[b:])
        old = voxel_seq[:-1].reshape(t_len * b, *voxel_seq.shape[2:])
        new = voxel_seq[1:].reshape(t_len * b, *voxel_seq.shape[2:])

        tchunk = int(self.cfg.eraft_tchunk or 0)
        chunked = 0 < tchunk < t_len and t_len % tchunk == 0
        if tchunk and not chunked:
            warnings.warn(
                f"eraft_tchunk={tchunk} does not divide the window t_len="
                f"{t_len}; falling back to the single flow call over the "
                "whole window")
        n = tchunk * b if chunked else t_len * b
        flows = torch.cat([
            net(old[i:i + n], new[i:i + n], iters=iters,
                encoded=(fmap1[i:i + n], fmap2[i:i + n], cnet[i:i + n]))["flow_final"]
            for i in range(0, t_len * b, n)])
        return flows.reshape(t_len, b, *flows.shape[1:])

    def forward_window(self, voxel_seq, rec0, state: CistaState, iters=None):
        """Time-parallel serving (counterpart of the JAX package's
        ``apply_sequence_eraft``): all flows first, then the sequential warp
        + CISTA recurrence. voxel_seq[t], voxel_seq[t+1] feed step t. Equal
        to T calls of ``forward``. Returns (recs (T, B, 1, H, W), flows
        (T, B, 2, H, W), state)."""
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        flows = self.window_flows(voxel_seq, iters)
        recs, rec = [], rec0
        for events, flow in zip(voxel_seq[1:], flows):
            rec, state = self.reconstruct(events, rec, state, flow)
            recs.append(rec)
        return torch.stack(recs), flows, state


MODELS = {"cista-eiflow": CistaEIFlow, "cista-eraft": CistaERAFT}


def init(cfg: Config, device=None, seed: int | None = None) -> _Composite:
    """A composite with random weights made from ``seed`` (default
    ``cfg.seed``), on ``device`` (default: the GPU; raises without one)."""
    dev = resolve_device(device)
    if cfg.model_mode not in MODELS:
        raise ValueError(f"model_mode {cfg.model_mode!r} is not ported yet; "
                         f"only {sorted(MODELS)} are")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        model = MODELS[cfg.model_mode](cfg)
    return model.to(dev).eval()


def zero_state(batch: int, cfg: Config, dtype=torch.float32,
               device=None) -> CistaState:
    return _cista_zero_state(batch, cfg.image_dim, cfg.base_channels, dtype,
                             resolve_device(device))
