"""The composite steps of every model mode (NCHW).

Counterpart of cista_flow_tpu/models/composite.py (ref:
e2v/e2v_model.py:138-308): estimate flow (DCEIFlow from the events and the
previous reconstruction, E-RAFT from two consecutive voxels, or IDNet from
the voxel and the previous step's predicted flow; cista-lstc and
cista-gtflow have no flow net and take zero flow or the GT flow), warp the
previous frame and the recurrent sparse code along it (kernel K2), then
reconstruct with CISTA-LSTC. Every mode takes ``batch_gt={'gt_flow'}``,
which the warps then follow. For cista-eraft there is also the
time-parallel window, the twin of ``apply_sequence_eraft``; for
cista-eiflow the ``flow_half`` serving reduction. On a row band of a
sharded step (every mode) each rank warps its own rows of the frame and of
the code, sampling the whole previous frame and the whole code, gathered
from the ranks, under the zero-flow gate of the whole flow; under
``flow_half`` the flow net runs on the band's rows of the half frame.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn as nn

from .. import weights
from ..config import Config
from ..device import resolve_device
from ..ops import bands
from ..ops.pad import padder_for
from ..ops.resize import interpolate_scale
from ..ops.warp import frame_warp
from ..utils.profiling import annotate
from .cista_lstc import CistaLSTC, CistaState
from .cista_lstc import zero_state as _cista_zero_state
from .dceiflow import DCEIFlow
from .eraft import ERAFT
from .idnet import IDNet


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

    def _warp_inputs(self, rec_img0, state: CistaState, flow_final, half_flow=None):
        """Warp the previous frame (full res) and the sparse code (half res)
        along the flow, keeping the reference's zero-flow short-circuit
        (ref: e2v_model.py:184-185): both warps take the device-side gate
        ``any(flow != 0)`` and select inside the kernel, with no host sync.
        ``half_flow``: the code's flow when the flow net already gives it
        (``flow_half``); else ``flow_final`` resized by ``scale_factor``."""
        cfg = self.cfg
        band = bands.active()
        if band is not None:
            return self._warp_rows(band, rec_img0, state, flow_final, half_flow)
        any_flow = torch.any(flow_final)        # nonzero, as flow != 0
        warped_i = frame_warp(rec_img0, flow_final, mode=cfg.warp_mode, gate=any_flow)
        if half_flow is None:
            half_flow = interpolate_scale(flow_final, cfg.scale_factor, align_corners=True)
        warped_z = frame_warp(state.sparse_code, half_flow, mode=cfg.warp_mode,
                              gate=any_flow)
        return warped_i, state._replace(sparse_code=warped_z)

    def _warp_rows(self, band, rec_img0, state: CistaState, flow_final, half_flow=None):
        """``_warp_inputs`` of a row band: the gate is the flow's over every
        rank (a max), each warp writes the band's rows (K2's output row
        offset) from the whole source, and the code's flow is the band's
        rows of ``half_flow`` where it is given, else of the frame's x0.5
        resize."""
        cfg = self.cfg
        if cfg.scale_factor != 0.5:
            raise ValueError("a row band's code is at half resolution: scale_factor 0.5")
        any_flow = band.any(torch.any(flow_final))
        frame = band.gather_rows(rec_img0, 1, padded=False)
        warped_i = frame_warp(frame, flow_final, mode=cfg.warp_mode, gate=any_flow,
                              row0=band.rows(1, padded=False)[0])
        if half_flow is None:
            half_flow = bands.resize(flow_final, 1, 2, padded=False, align_corners=True)
        code = band.gather_rows(state.sparse_code, 2, padded=False)
        warped_z = frame_warp(code, half_flow, mode=cfg.warp_mode, gate=any_flow,
                              row0=band.rows(2, padded=False)[0])
        return warped_i, state._replace(sparse_code=warped_z)

    def reconstruct(self, events, rec_img0, state: CistaState, flow_final, half_flow=None):
        """Warp along ``flow_final``, then CISTA-LSTC: (rec, new_state); the
        span ``reconstruct`` while a profiler records."""
        with annotate("reconstruct"):
            warped_i, state = self._warp_inputs(rec_img0, state, flow_final, half_flow)
            return self.cista_net(events, warped_i, state)


def _warp_flow(batch_flow: dict, batch_gt, fix_net_name):
    """The flow the warps follow: ``batch_gt['gt_flow']`` where it is given,
    else the flow net's final flow, detached when the flow net is frozen
    (cista_flow_tpu/models/composite.py:201-205)."""
    if batch_gt and "gt_flow" in batch_gt:
        return batch_gt["gt_flow"]
    flow = batch_flow["flow_final"]
    return flow.detach() if fix_net_name == "flow" else flow


class CistaEIFlow(_Composite):
    """cista-eiflow (ref: e2v/e2v_model.py DCEIFlowCistaNet): the flow comes
    from the events and the previous reconstruction. Module names match the
    reference checkpoint: ``cista_net.*`` and ``event_flownet.*``."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.event_flownet = DCEIFlow(cfg.num_bins, cfg.ds)

    def forward(self, events, rec_img0, state: CistaState, iters=None,
                collect_preds: bool = False, batch_gt=None, fix_net_name=None,
                event_voxel_bw=None):
        """One reconstruction step. events (B, bins, H, W), rec_img0
        (B, 1, H, W) in the compute dtype. Returns (rec, batch_flow,
        new_state).

        Training (cista_flow_tpu/models/composite.py ``apply``, ref:
        e2v_model.py:138-224): ``batch_gt`` may hold 'gt_img0' (the flow
        net's first frame instead of ``rec_img0``), 'gt_img1' (its second
        frame, for the pseudo-feature loss) and 'gt_flow' (the warps take it
        instead of the predicted flow); ``event_voxel_bw`` runs the
        backward direction. ``fix_net_name`` names the frozen subnet ('rec'
        or 'flow'): with 'flow' the predicted flow reaches the warps
        detached. The flow net's BatchNorm runs in train mode exactly when
        this module is in train mode and the flow net is not frozen.

        ``cfg.flow_half`` (serving; composite.py:147-171 of the JAX
        package): the flow net runs on the events and the frame at half
        size; the code's warp takes its flow as it is, the frame's warp its
        x2 upsample with x2 magnitudes, which is ``batch_flow['flow_final']``.
        On a row band the flow net's frame is the band's rows of the half
        frame (``parallel.spatial.partition(half=True)``)."""
        batch_gt = batch_gt or {}
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        self.event_flownet.train(self.training and fix_net_name != "flow")
        image1 = batch_gt.get("gt_img0", rec_img0)
        half = None
        if self.cfg.flow_half:
            if batch_gt.get("gt_img1") is not None or event_voxel_bw is not None:
                raise ValueError("flow_half serves and runs rec-phase graphs only: it takes "
                                 "no gt_img1 and no event_voxel_bw")
            with annotate("flownet"):
                batch_flow = dict(self.event_flownet(
                    bands.rescale(events, 1, 2, align_corners=False),
                    bands.rescale(image1, 1, 2, align_corners=False), iters=iters,
                    collect_preds=collect_preds))
                half = batch_flow["flow_final"]
                batch_flow["flow_final"] = 2.0 * bands.rescale(half, 2, 1, align_corners=True)
        else:
            with annotate("flownet"):
                batch_flow = self.event_flownet(
                    events, image1, iters=iters, collect_preds=collect_preds,
                    image2=batch_gt.get("gt_img1"), reversed_event_voxel=event_voxel_bw)
        flow_final = _warp_flow(batch_flow, batch_gt, fix_net_name)
        half_flow = None
        if half is not None and "gt_flow" not in batch_gt and self.cfg.scale_factor == 0.5:
            half_flow = half.detach() if fix_net_name == "flow" else half
        rec, new_state = self.reconstruct(events, rec_img0, state, flow_final, half_flow)
        return rec, batch_flow, new_state


class CistaERAFT(_Composite):
    """cista-eraft (ref: e2v/e2v_model.py ERAFTCistaNet): the flow comes
    from the previous and the current voxel alone, never from a
    reconstruction, so a window's flows need not wait for its frames."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.event_flownet = ERAFT(cfg.num_bins)

    def forward(self, events, rec_img0, state: CistaState, event_voxel_old,
                iters=None, collect_preds: bool = False, batch_gt=None,
                fix_net_name=None):
        """One reconstruction step; ``event_voxel_old`` is the previous
        step's voxel (zeros at the start of a stream); the warps follow
        ``batch_gt['gt_flow']`` where it is given. Returns (rec, batch_flow,
        new_state). Training: with ``fix_net_name='flow'`` the predicted
        flow reaches the warps detached; cnet's BatchNorm runs in train mode
        exactly when this module trains and the flow net is not frozen
        (cista_flow_tpu/models/composite.py:183-192)."""
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        self.event_flownet.train(self.training and fix_net_name != "flow")
        with annotate("flownet"):
            batch_flow = self.event_flownet(event_voxel_old, events, iters=iters,
                                            collect_preds=collect_preds)
        rec, new_state = self.reconstruct(
            events, rec_img0, state, _warp_flow(batch_flow, batch_gt, fix_net_name))
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
        padder = padder_for(voxel_seq.shape[3:], min_size=32)
        padded = padder.pad(voxel_seq.reshape(t1 * b, *voxel_seq.shape[2:]))
        with annotate("flownet.encode"):
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
        with annotate("flownet"):
            flows = self.window_flows(voxel_seq, iters)
        recs, rec = [], rec0
        for events, flow in zip(voxel_seq[1:], flows):
            rec, state = self.reconstruct(events, rec, state, flow)
            recs.append(rec)
        return torch.stack(recs), flows, state


class CistaIDNet(_Composite):
    """cista-idnet (ref: e2v/e2v_model.py IDCistaNet): the flow comes from
    the voxel alone, warm-started from the previous step's predicted flow
    (``flow_init``, at the padded resolution); ``batch_flow['next_flow']``
    is the next step's. The flow net keeps the reference's module names
    ``event_flownet.fnet.*`` and ``event_flownet.update_net.*``."""

    def __init__(self, cfg: Config):
        super().__init__(cfg)
        self.event_flownet = IDNet()

    def forward(self, events, rec_img0, state: CistaState, iters=None,
                flow_init=None, collect_preds: bool = False, batch_gt=None,
                fix_net_name=None):
        """One reconstruction step; ``iters`` deblur iterations (default 1);
        the warps follow ``batch_gt['gt_flow']`` where it is given, and the
        predicted flow reaches them detached under ``fix_net_name='flow'``.
        Returns (rec, batch_flow, new_state)."""
        iters = iters if iters is not None else self.cfg.default_flow_iters()
        with annotate("flownet"):
            batch_flow = self.event_flownet(events, flow_init=flow_init, iters=iters,
                                            collect_preds=collect_preds)
        # the warps take an f32 flow; in bf16 the flow net's is bf16
        flow_final = _warp_flow(batch_flow, batch_gt, fix_net_name).float()
        rec, new_state = self.reconstruct(events, rec_img0, state, flow_final)
        return rec, batch_flow, new_state


class CistaLSTCOnly(_Composite):
    """cista-lstc and cista-gtflow (ref: e2v/e2v_model.py CistaLSTCNet): no
    flow net. The warps follow ``batch_gt['gt_flow']`` (cista-gtflow) or a
    zero flow (cista-lstc, whose warps' gate then passes the inputs
    through); ``batch_flow['flow_final']`` is that flow."""

    def forward(self, events, rec_img0, state: CistaState, iters=None,
                collect_preds: bool = False, batch_gt=None, fix_net_name=None):
        """One step; ``fix_net_name`` is taken for the trainer's sake (these
        modes train the reconstructor alone, under None)."""
        flow = (batch_gt or {}).get("gt_flow")
        if flow is None:
            b, _, h, w = rec_img0.shape
            flow = torch.zeros((b, 2, h, w), dtype=torch.float32, device=rec_img0.device)
        rec, new_state = self.reconstruct(events, rec_img0, state, flow)
        return rec, {"flow_final": flow, "flow_preds": []}, new_state

    def load_reference_state(self, sd: dict) -> None:
        """A full checkpoint loads too: its flow net's ``event_flownet.*``
        keys are dropped (as the JAX package's ``composite_params`` reads
        only ``cista_net.*`` for these modes) and every other key is held
        strictly."""
        super().load_reference_state(
            {k: v for k, v in sd.items() if not k.startswith("event_flownet.")})


MODELS = {"cista-eiflow": CistaEIFlow, "cista-eraft": CistaERAFT,
          "cista-idnet": CistaIDNet, "cista-lstc": CistaLSTCOnly,
          "cista-gtflow": CistaLSTCOnly}


def init(cfg: Config, device=None, seed: int | None = None) -> _Composite:
    """A composite with random weights made from ``seed`` (default
    ``cfg.seed``), on ``device`` (default: the GPU; raises without one)."""
    dev = resolve_device(device)
    if cfg.model_mode not in MODELS:
        raise ValueError(f"unknown model_mode {cfg.model_mode!r}; "
                         f"only {sorted(MODELS)} are")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed if seed is None else seed)
        model = MODELS[cfg.model_mode](cfg)
    return model.to(dev).eval()


def zero_state(batch: int, cfg: Config, dtype=torch.float32,
               device=None) -> CistaState:
    return _cista_zero_state(batch, cfg.image_dim, cfg.base_channels, dtype,
                             resolve_device(device))
