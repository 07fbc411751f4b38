"""The benchmark's plain reference of the served model modes.

Plain PyTorch in f32, with TF32 off where it runs on the card, and a
frozen copy of the published models (``nets.py``, ``ops.py``; a model
mode's recurrence in ``<model_mode>.py``, ``-`` as ``_``). It loads the
weights file itself, and runs the closed recurrence of a batch of streams
from their voxels: it takes no state, flow or frame from the program
under test, and imports nothing of it.
"""
from __future__ import annotations

import importlib
from pathlib import Path

import numpy as np
import torch

from .ops import Ops


def load_params(path: str, device) -> dict:
    """{key: f32 tensor} of a published checkpoint in ``.npz`` form, any
    ``module.`` prefix dropped."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            key = k[7:] if k.startswith("module.") else k
            out[key] = torch.from_numpy(z[k].astype(np.float32)).to(device)
    return out


def make_streams(params: dict, model: dict, batch: int, hw, device, rounding=None,
                 flow_chunk: int = 8):
    """The closed recurrence of ``batch`` streams of ``model``: the
    ``Streams`` of ``reference/<model_mode>.py``, found by name, so that
    another model mode is a file of its own."""
    name = model["model_mode"].replace("-", "_")
    if not (Path(__file__).parent / f"{name}.py").exists():
        raise ValueError(f"no reference for {model['model_mode']}")
    mode = importlib.import_module(f"{__name__}.{name}")
    return mode.Streams(Ops(params, rounding), model, batch, hw, device, flow_chunk)


def flops_per_frame(params: dict, model: dict, mix: dict) -> float:
    """The model operations of one frame, as the cell's path runs it (one
    call: a step, or a time-parallel window of ``steps_per_call``),
    counted by ``FlopCounterMode`` over the reference on meta tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    meta = {k: torch.empty(v.shape, device="meta") for k, v in params.items()}
    b, t = mix["streams"], mix["steps_per_call"]
    hw = (mix["height"], mix["width"])
    streams = make_streams(meta, model, b, hw, "meta", flow_chunk=t)
    with FlopCounterMode(display=False) as counter:
        streams.steps(torch.empty((t, b, model["num_bins"], *hw), device="meta"))
    return counter.get_total_flops() / (b * t)
