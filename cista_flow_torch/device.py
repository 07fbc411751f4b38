"""Device selection for the port's entry points, and f32 without TF32.

Entry points run on the card unless the caller asks for the CPU: with no
GPU present they raise instead of quietly running elsewhere.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def cudnn_fp32():
    """cuDNN convolutions in full f32 (no TF32) inside the block; the
    caller's settings are restored after it.

    PyTorch runs f32 cuDNN convolutions in TF32 (a 10-bit mantissa) by
    default, which moves an f32 reconstruction by ~1e-3 from the JAX f32
    reference. Both switches are set: the legacy ``cudnn.allow_tf32`` (the
    only one older PyTorch has) and, where it exists, the per-operator
    ``cudnn.conv.fp32_precision``. ``torch.backends.cudnn.flags()`` is not
    used: its arguments default to ``enabled=False``, which would turn
    cuDNN off altogether. A caller whose flags mix the two APIs (the legacy
    getter then raises) keeps its legacy flag untouched."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    rnn = getattr(cudnn, "rnn", None)
    new_api = conv is not None and hasattr(conv, "fp32_precision")
    try:
        legacy = cudnn.allow_tf32
    except RuntimeError:             # the legacy getter refuses mixed flags
        legacy = None
    precision = (conv.fp32_precision, rnn.fp32_precision) if new_api else None
    try:
        if legacy is not None:
            cudnn.allow_tf32 = False
        if new_api:
            conv.fp32_precision = "ieee"
        yield
    finally:
        # the legacy setter rewrites the per-operator precisions, so it goes
        # first and the saved precisions are put back over it
        if legacy is not None:
            cudnn.allow_tf32 = legacy
        if new_api:
            conv.fp32_precision, rnn.fp32_precision = precision
