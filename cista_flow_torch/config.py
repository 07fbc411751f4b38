"""The configuration fields the serving step, the eval CLIs and the trainer
read, and the reference's flag surface.

A copy of ``cista_flow_tpu.configs.Config`` (same names, same defaults,
``model_mode`` ``cista-lstc`` among them) without the TPU knobs; the port
imports nothing of the JAX package. ``add_args``/``from_args`` keep the
reference's flag names and short forms (ref: utils/configs.py:4-165) and
add ``--device``. The JAX package's TPU-only flags (``TPU_ONLY_FLAGS``, the
Pallas routings and the encoder merge, with their ``--no-`` forms) are
refused by name. Its mesh flags (``MESH_FLAGS``) are the trainer's (data
and spatial axes) and, through ``add_mesh_args``, the serving CLIs' (a
spatial axis).
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass

# the JAX package's mesh flags: the trainer's own parser takes them (a data
# axis over cards, ``train.py``), the serving CLIs ``add_mesh_args`` (one
# stream's rows over cards, ``parallel/spatial.py``). The serving CLIs
# refuse the Pallas-routing flags, which have no meaning on the card
# (cista_flow_tpu/configs.py:242-262)
MESH_FLAGS = ("--mesh_shape", "--mesh_axes")
TPU_ONLY_FLAGS = ("--serve_pallas", "--train_pallas", "--encoder_merge",
                               "--corr_fuse_proj", "--eraft_pair_tower")


@dataclass
class Config:
    image_dim: tuple = (180, 240)
    model_mode: str = "cista-lstc"   # or cista-eiflow, cista-eraft, cista-idnet, cista-gtflow
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
    flow_half: bool = False          # cista-eiflow serving: the flow net on the half domain
    seed: int = 1234
    orbax_ckpt: bool = False         # also write full-state saves at every epoch save
    save_every_steps: int = 0        # > 0: a full-state save every N optimizer steps
    remat: bool = False              # recompute each unroll step in the backward

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
    is_SummaryWriter: bool = False
    load_epoch_for_train: int = 0
    load_lr: float = 1e-4
    train_all: bool = False
    is_load_flow: bool = False
    no_warp: bool = False
    is_gt_flow: bool = False
    is_reverse_events: bool = False
    is_bi: bool = False
    distributed: bool = False        # the trainer: data-parallel over every local card
    mesh_shape: str = "1"            # N ranks: the trainer's data axis, serving's spatial one
    mesh_axes: str = "data"          # data (the trainer) | spatial (serving)
    num_events: int = 15000

    # testing (ref: utils/configs.py; cista_flow_tpu/configs.py:72-86)
    path_to_test_data: str | None = None
    load_epoch_for_test: int | None = None
    reader_type: str = "image_reader"
    test_data_mode: str = "real"
    test_data_name: str | None = None
    test_img_num: int = 50
    is_forward_flow: bool = False
    time_unit: str = "s"
    dataset: str = "SIM"
    k_shift: int = -1
    n_event_skip: int = 0
    dvs: str | None = None
    mvsec_sensor_size: tuple | None = None   # MVSEC_NE's sensor (H, W); None: DAVIS346's (260, 346)

    # output
    output_folder: str = "test_images"
    is_write_image: bool = True
    is_write_event: bool = False
    is_write_video: bool = False
    is_write_flow: bool = False
    is_write_emap: bool = False

    # display (kept for the flag surface; nothing is shown headless)
    display_train: bool = False
    display_test: bool = False
    show_events: bool = True
    event_display_mode: str = "grayscale"
    num_bins_to_show: int = -1

    def default_flow_iters(self) -> int:
        if self.flow_iters is not None:
            return self.flow_iters
        return {"cista-eiflow": 6, "cista-eraft": 12, "cista-idnet": 1}.get(
            self.model_mode, 6)


class _RefuseTPUOnly(argparse.Action):
    """A TPU-only flag of the JAX package: refused by name."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: a TPU-only kernel routing or formulation of the JAX "
                     "package; the port has none (its kernels are hand-written CUDA)")


def add_args(parser: argparse.ArgumentParser) -> None:
    """The reference's flags (cista_flow_tpu/configs.py:160-240), the port's
    extensions ``--dtype``, ``--flow_iters``, ``--seed``,
    ``--eraft_tchunk``, ``--flow_half`` / ``--no-flow_half``, the JAX
    trainer's ``--orbax_ckpt``, ``--remat`` and ``--save_every_steps``
    (configs.py:228-230), and ``--device`` (``cuda``, the default, or
    ``cpu``). ``TPU_ONLY_FLAGS`` parse only to be refused by name."""
    a = parser.add_argument
    a("--image_dim", nargs=2, default=[180, 240], type=int)
    a("--path_to_model", default="models", type=str)
    a("--path_to_test_model", type=str)
    a("--model_name", default="", type=str)
    a("--model_mode", default="cista-lstc", type=str)
    a("-b", "--num_bins", default=5, type=int)
    a("-d", "--depth", default=5, type=int)
    a("-c", "--base_channels", default=64, type=int)
    a("--ds", default=8, type=int)

    a("--path_to_e2v", type=str)
    a("--path_to_e2vflow", type=str)
    a("--path_to_flownet", type=str)
    a("--path_to_train_data", type=str)
    a("-s", "--len_sequence", default=10, type=int)
    a("--no_shuffle", dest="shuffle", action="store_false")
    a("--epochs", default=1, type=int)
    a("--flow_epoch", default=20, type=int)
    a("--rec_epoch", default=5, type=int)
    a("--lr", default=1e-4, type=float)
    a("--batch_size", default=1, type=int)
    a("--is_SummaryWriter", action="store_true")
    a("--load_epoch_for_train", default=0, type=int)
    a("--load_lr", default=1e-4, type=float)
    a("--train_all", action="store_true")
    a("--is_load_flow", action="store_true")
    a("--is_forward_flow", action="store_true")
    a("--no_warp", action="store_true")
    a("--is_gt_flow", action="store_true")
    a("--warp_mode", type=str, default="forward")
    a("--is_reverse_events", action="store_true")
    a("--is_bi", action="store_true")
    a("--distributed", action="store_true")

    a("--path_to_test_data", type=str)
    a("--load_epoch_for_test", default=None, type=int)
    a("--reader_type", default="image_reader", type=str)
    a("--test_data_name", default=None, type=str)
    a("--dataset", default="SIM", type=str)
    a("--time_unit", default="s", type=str)
    a("--test_img_num", default=50, type=int)
    a("--num_events", default=15000, type=int)
    a("--test_data_mode", default="real", type=str)
    a("--k_shift", default=-1, type=int)
    a("--n_event_skip", default=0, type=int)
    a("--dvs", default=None, type=str)

    a("-o", "--output_folder", default="test_images", type=str)
    a("--no_write_image", dest="is_write_image", action="store_false")
    a("--is_write_event", action="store_true")
    a("--is_write_video", action="store_true")
    a("--is_write_flow", action="store_true")
    a("--is_write_emap", action="store_true")

    a("--display_train", action="store_true")
    a("--display_test", action="store_true")
    a("--show_events", action="store_true", default=True)
    a("--event_display_mode", default="grayscale", type=str)
    a("--num_bins_to_show", default=-1, type=int)

    a("--dtype", default="float32", choices=["float32", "bfloat16"])
    a("--flow_iters", default=None, type=int)
    a("--seed", default=1234, type=int)
    a("--eraft_tchunk", default=0, type=int)
    a("--flow_half", default=False, action=argparse.BooleanOptionalAction)
    a("--orbax_ckpt", action="store_true",
      help="also write the full training state at every epoch save (the port's "
           "torch.save files, not orbax), for --load_epoch_for_train -1")
    a("--remat", action="store_true", help="recompute each unroll step in the backward")
    a("--save_every_steps", default=0, type=int,
      help="> 0: a full-state save every N optimizer steps")
    a("--device", default="cuda", help="cuda (default) or cpu")
    for flag in TPU_ONLY_FLAGS:
        forms = (flag,) if flag == "--encoder_merge" else (flag, "--no-" + flag[2:])
        a(*forms, nargs="?" if flag == "--encoder_merge" else 0, action=_RefuseTPUOnly,
          default=argparse.SUPPRESS, help=argparse.SUPPRESS)


def add_mesh_args(parser: argparse.ArgumentParser) -> None:
    """The serving CLIs' mesh flags, with the JAX CLIs' defaults
    (cista_flow_tpu/configs.py:224-225): ``--mesh_shape N --mesh_axes
    spatial`` serves one stream's rows over N ranks
    (``parallel.spatial.serving_world`` says what it refuses)."""
    parser.add_argument("--mesh_shape", default="1", type=str,
                        help="N > 1 with --mesh_axes spatial: one stream's rows over N ranks")
    parser.add_argument("--mesh_axes", default="data", type=str,
                        help="spatial: shard the rows (serving has no data axis)")


def from_args(args: argparse.Namespace) -> Config:
    """The Config of a parsed namespace; keys that are not fields
    (``--device``, a harness's own flags) are left out."""
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if kw.get("image_dim") is not None:
        kw["image_dim"] = tuple(kw["image_dim"])
    return Config(**kw)
