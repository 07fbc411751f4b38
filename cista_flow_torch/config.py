"""The configuration fields the serving step, the with-flow eval and the
trainer read.

A copy of the subset of ``cista_flow_tpu.configs.Config`` (same names, same
defaults) that the cista-eiflow, cista-eraft and cista-idnet serving paths,
``evaluate.py`` and ``train.py`` consume; the port imports nothing of the
JAX package.
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

    # training (ref: utils/configs.py; cista_flow_tpu/configs.py:48-70)
    path_to_model: str = "models"
    model_name: str = ""
    path_to_train_data: str | None = None
    path_to_e2v: str | None = None
    path_to_flownet: str | None = None
    path_to_e2vflow: str | None = None
    len_sequence: int = 10
    shuffle: bool = True
    epochs: int = 1
    flow_epoch: int = 20
    rec_epoch: int = 5
    lr: float = 1e-4
    batch_size: int = 1
    load_epoch_for_train: int = 0
    is_reverse_events: bool = False
    is_bi: bool = False
    num_events: int = 15000

    # testing (ref: utils/configs.py; cista_flow_tpu/configs.py)
    path_to_test_data: str | None = None
    test_data_mode: str = "real"
    test_data_name: str | None = None
    test_img_num: int = 50
    is_forward_flow: bool = False
    time_unit: str = "s"
    dataset: str = "SIM"

    # output
    output_folder: str = "test_images"
    is_write_image: bool = True

    def default_flow_iters(self) -> int:
        if self.flow_iters is not None:
            return self.flow_iters
        return {"cista-eiflow": 6, "cista-eraft": 12, "cista-idnet": 1}.get(
            self.model_mode, 6)
