"""What every model mode's closed recurrence shares: the CISTA-LSTC state,
the previous frame and voxel, the warps and the reconstruction of each
step. A mode's file (``reference/<model_mode>.py``) subclasses
``Recurrence`` as ``Streams`` and gives its flows."""
from __future__ import annotations

import contextlib

import torch

from . import nets


@contextlib.contextmanager
def full_f32():
    """f32 products in full f32: TF32 off for matmuls and cuDNN convs, and
    cuDNN's choice of algorithm timed once per shape (the recurrence
    repeats its shapes); the caller's settings restored after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32, cudnn.benchmark
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    cudnn.benchmark = True
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32, cudnn.benchmark = saved


class Recurrence:
    """The closed recurrence of ``batch`` streams: call ``steps`` with
    consecutive voxels; it returns their frames and flows and carries the
    state, the previous frame and the previous voxel to the next call."""

    def __init__(self, ops, model: dict, batch: int, hw, device, flow_chunk: int):
        self.ops = ops
        self.iters, self.depth = model["flow_iters"], model["depth"]
        self.hw = tuple(hw)
        self.flow_chunk = flow_chunk
        self.state = nets.zero_state(batch, hw, device, model["base_channels"])
        self.prev_frame = torch.zeros((batch, 1, *hw), device=device)
        self.prev_voxel = torch.zeros((batch, model["num_bins"], *hw), device=device)

    def keep(self, index: list) -> None:
        """Follow only the streams at ``index`` of those followed so far."""
        self.state = [s[index] for s in self.state]
        self.prev_frame = self.prev_frame[index]
        self.prev_voxel = self.prev_voxel[index]

    def flows(self, voxels):
        """The flow of each step of ``voxels``, in order; drawn one step at
        a time, after the previous step's frame is ``prev_frame``."""
        raise NotImplementedError

    @torch.no_grad()
    def steps(self, voxels: torch.Tensor):
        """voxels (T, B, bins, H, W) f32 on the device -> frames (T, B, H, W)
        and flows (T, B, 2, H, W)."""
        with full_f32():
            frames, out_flows = [], []
            for ev, flow in zip(voxels, self.flows(voxels)):
                frame, self.state = nets.warp_and_reconstruct(
                    self.ops, ev, self.prev_frame, self.state, flow, self.depth)
                self.prev_frame = frame
                frames.append(frame[:, 0])
                out_flows.append(flow)
            return torch.stack(frames), torch.stack(out_flows)
