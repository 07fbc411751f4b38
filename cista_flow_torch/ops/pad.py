"""``ImagePadder``: left/top-only zero padding to multiples of ``min_size``
(NCHW; counterpart of cista_flow_tpu/ops/pad.py, ref:
utils/image_process.py:60-107)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import bands


class ImagePadder:
    def __init__(self, image_dim, min_size: int = 32):
        self.height, self.width = int(image_dim[0]), int(image_dim[1])
        self.min_size = min_size
        self.pad_height = (min_size - self.height % min_size) % min_size
        self.pad_width = (min_size - self.width % min_size) % min_size

    @property
    def padded_dim(self):
        return (self.height + self.pad_height, self.width + self.pad_width)

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        if self.pad_height == 0 and self.pad_width == 0:
            return x
        return F.pad(x, (self.pad_width, 0, self.pad_height, 0))

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, :, self.pad_height:, self.pad_width:]


def padder_for(image_dim, min_size: int = 32) -> ImagePadder:
    """The padder of a frame, or of a row band of one (``bands.active()``):
    the rows are padded at the frame's top only, so rank 0's band carries
    them and no other band is padded in height."""
    padder = ImagePadder(image_dim, min_size)
    band = bands.active()
    if band is not None:
        padder.pad_height = band.pad_rows
    return padder
