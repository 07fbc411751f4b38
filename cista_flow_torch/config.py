"""The configuration fields the serving step reads.

A copy of the subset of ``cista_flow_tpu.configs.Config`` (same names, same
defaults) that the cista-eiflow and cista-eraft serving paths consume; the port imports
nothing of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    image_dim: tuple = (180, 240)
    model_mode: str = "cista-eiflow"
    num_bins: int = 5
    depth: int = 5
    base_channels: int = 64
    ds: int = 8
    warp_mode: str = "forward"
    scale_factor: float = 0.5
    dtype: str = "float32"           # float32 | bfloat16
    flow_iters: int | None = None    # override of the flow GRU iterations
    path_to_test_model: str | None = None
    eraft_tchunk: int = 0            # cista-eraft window: time steps per flow call (0 = all)
    seed: int = 1234

    def default_flow_iters(self) -> int:
        if self.flow_iters is not None:
            return self.flow_iters
        return {"cista-eiflow": 6, "cista-eraft": 12, "cista-idnet": 1}.get(
            self.model_mode, 6)
