"""Full-state training checkpoints: the exact resume.

Counterpart of cista_flow_tpu/ckpt/orbax_io.py. The reference's ``.pth.tar``
saves (``weights.save_checkpoint``) hold the weights alone, so a resume from
one restarts Adam; these hold everything a step depends on: the model's
``state_dict`` (parameters and BatchNorm buffers), the optimizer's (Adam's
moments and each parameter's ``step``) and a small ``meta`` dict of ints
(epoch, global_step). One file per step, ``{directory}/{step}.pt``, written
by ``torch.save`` to a temporary name and renamed, so a cut run leaves no
half-written step; the oldest beyond ``max_to_keep`` are deleted. Files
load with ``weights_only=True``: tensors and plain containers, no pickled
code.
"""
from __future__ import annotations

import os

import torch


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{step}.pt")


def steps(directory: str) -> list[int]:
    """The saved steps under ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(directory)
                  if f.endswith(".pt") and f[:-3].isdigit())


def latest_step(directory: str) -> int | None:
    found = steps(directory)
    return found[-1] if found else None


def save_checkpoint(directory: str, step: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer | None = None,
                    max_to_keep: int = 5, meta: dict | None = None) -> str:
    """Write step ``step``'s full state; returns its path."""
    os.makedirs(directory, exist_ok=True)
    state = {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "meta": {k: int(v) for k, v in (meta or {}).items()}}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    path = _path(directory, step)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return path


def restore_checkpoint(directory: str, step: int | None = None,
                       model: torch.nn.Module | None = None,
                       optimizer: torch.optim.Optimizer | None = None):
    """Load step ``step`` (default: the latest) into ``model`` (strictly)
    and ``optimizer``, where given. Returns (the loaded dict, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    state = torch.load(_path(directory, step), map_location="cpu", weights_only=True)
    if model is not None:
        model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    return state, step


def read_meta(directory: str, step: int) -> dict:
    return dict(restore_checkpoint(directory, step)[0]["meta"])
