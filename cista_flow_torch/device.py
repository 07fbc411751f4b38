"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
GPU present they raise instead of quietly running elsewhere.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
