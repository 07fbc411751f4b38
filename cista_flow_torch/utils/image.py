"""Image utilities (host side, numpy).

A copy of ``normalize_image`` of cista_flow_tpu/utils/image.py (ref:
utils/image_process.py:11-18); the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def normalize_image(image: np.ndarray, low: float = 1, high: float = 99) -> np.ndarray:
    """Percentile-robust normalization to [0, 1]: the ``low`` and ``high``
    percentiles map to 0 and 1 (ECD's GT frames use 0 and 100, ref:
    test_wo_flow.py:157-158)."""
    image = np.asarray(image)
    mini = np.percentile(image.ravel(), low)
    maxi = np.percentile(image.ravel(), high)
    out = (image - mini) / (maxi - mini + 1e-5)
    return np.clip(out, 0.0, 1.0)
