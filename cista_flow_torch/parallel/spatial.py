"""Row-sharded serving: one stream's rows over N ranks, one process each.

Counterpart of the spatial mesh axis of the JAX runner
(cista_flow_tpu/runner.py:74-86, 96-103, 140-148): there ``--mesh_shape N
--mesh_axes spatial`` constrains the step's 4-D activations to
``P(None, "spatial", None, None)`` and XLA inserts the exchanges; here each
rank is a process (``parallel.mesh.launch``: a card per rank over NCCL, or
gloo processes on the CPU and for ranks sharing one card) that steps on its
band of rows of every activation and of the recurrent state, and the
exchanges are explicit:

* ``halo``: the rows next to a band from its neighbours, before a conv
  (``ops/bands.py`` holds the rule); NCCL's batched point-to-point, or on
  gloo (whose point-to-point takes host tensors only) through the host;
* ``gather_rows``: the whole frame from the ranks' uneven bands (the
  correlation's target, the warps' sources, the outputs);
* ``all_gather`` (the instance norms' statistics) and ``any`` (the
  zero-flow gate over the whole flow, a max).

``partition`` cuts the frame: band boundaries are multiples of 8 rows of
the flow net's padded frame, which ``ImagePadder`` pads at the top only, so
rank 0's band carries the padding; the boundaries are then even rows of the
unpadded frame, the CISTA half-resolution maps' too. A band needs 3 rows at
1/8 of the padded frame (the motion encoder's 7x7 ``convf1``) and 2*depth+1
rows at half resolution (the ISTA loop's one halo).
"""
from __future__ import annotations

import dataclasses
import importlib

import torch
import torch.distributed as dist

from . import mesh as data_mesh

ALIGN = 8              # band boundaries: rows of the padded frame, the encoders' stride
PAD_MULTIPLE = 32      # ImagePadder's min_size for the flow nets
MIN_ROWS_8 = 3         # a band's rows at 1/8: the 7x7 convf1's halo
MODES = ("cista-eiflow", "cista-eraft", "cista-lstc", "cista-gtflow")
NEXT_ITEM = "ROADMAP.md, Queue 1, item 9.2"


@dataclasses.dataclass(frozen=True)
class Partition:
    """The rows of a frame of ``height`` rows over the ranks: ``cuts`` are
    the band boundaries in the flow net's frame padded by ``pad`` rows at
    the top (0 and height + pad at the ends)."""
    height: int
    pad: int
    cuts: tuple

    @property
    def world(self) -> int:
        return len(self.cuts) - 1

    def sizes(self, scale: int = 1, padded: bool = False) -> list:
        """Every band's rows at 1/``scale``, in rank order."""
        return [b - a for a, b, _ in (self.rows(r, scale, padded) for r in range(self.world))]

    def rows(self, rank: int, scale: int = 1, padded: bool = False) -> tuple:
        """(first, stop, frame rows) of ``rank``'s band at 1/``scale`` of the
        padded frame or of the unpadded one."""
        lo, hi = self.cuts[rank], self.cuts[rank + 1]
        total = self.height + self.pad
        if not padded:
            lo, hi, total = max(lo - self.pad, 0), hi - self.pad, self.height
        return lo // scale, hi // scale, total // scale


def _even_cuts(height: int, world: int) -> Partition:
    pad = (PAD_MULTIPLE - height % PAD_MULTIPLE) % PAD_MULTIPLE
    inner = [ALIGN * int((pad + r * height / world) / ALIGN + 0.5) for r in range(1, world)]
    return Partition(height, pad, (0, *inner, height + pad))


def _thick_enough(part: Partition, depth: int) -> bool:
    return (all(n >= MIN_ROWS_8 for n in part.sizes(ALIGN, padded=True))
            and all(n >= 2 * depth + 1 for n in part.sizes(2)))


def max_world(image_dim, depth: int) -> int:
    """The most ranks whose bands ``partition`` accepts."""
    world = 1
    while _thick_enough(_even_cuts(int(image_dim[0]), world + 1), depth):
        world += 1
    return world


def partition(image_dim, world: int, depth: int) -> Partition:
    """Bands as even as the rule lets them be in the unpadded frame; raises
    ValueError where a band would be too thin, naming the largest rank
    count the frame allows."""
    height = int(image_dim[0])
    if height % 2:
        raise ValueError(f"a frame of {height} rows: the row bands need an even height")
    part = _even_cuts(height, world)
    if not _thick_enough(part, depth):
        raise ValueError(
            f"{world} ranks: a frame of {height} rows gives bands thinner than the "
            f"encoders and the ISTA loop take ({MIN_ROWS_8} rows at 1/8 of the "
            f"padded frame, {2 * depth + 1} at half resolution); at most "
            f"{max_world(image_dim, depth)} ranks for this frame")
    return part


def serving_world(cfg) -> int | None:
    """The ranks the serving flags ask for: None for one process, else N of
    ``--mesh_shape N --mesh_axes spatial``. Raises ValueError for what the
    row bands do not serve, with the reason."""
    shape, axes = str(cfg.mesh_shape), str(cfg.mesh_axes)
    sizes = shape.split(",")
    if not all(s.isdigit() and int(s) >= 1 for s in sizes):
        raise ValueError(f"--mesh_shape {shape}: positive rank counts")
    names = axes.split(",")
    if "data" in names and any(int(s) > 1 for s in sizes):
        raise ValueError(
            f"--mesh_axes {axes}: serving has no data axis; the JAX runner replicates the "
            "stream over it (cista_flow_tpu/runner.py:96-103 constrains only 'spatial'). "
            "Serve streams side by side with one process per card, or shard one "
            "stream's rows with --mesh_axes spatial")
    if len(sizes) != 1 or names != ["spatial"]:
        if all(s == "1" for s in sizes):
            return None
        raise ValueError(f"--mesh_shape {shape} --mesh_axes {axes}: serving shards one "
                         "axis, 'spatial'")
    world = int(sizes[0])
    if world == 1:
        return None
    check_model(cfg)
    partition(cfg.image_dim, world, cfg.depth)
    return world


def serving_ranks(parser, cfg) -> int | None:
    """``serving_world`` for a CLI: its refusals end the parse with their
    message."""
    try:
        return serving_world(cfg)
    except ValueError as e:
        parser.error(str(e))


def check_model(cfg) -> None:
    """Raise ValueError for a model the row bands do not serve yet."""
    if cfg.model_mode not in MODES:
        raise ValueError(f"{cfg.model_mode} does not serve on row bands yet ({NEXT_ITEM}: "
                         "cista-idnet and flow_half sharded); it serves on one process")
    if cfg.flow_half:
        raise ValueError(f"--flow_half does not serve on row bands yet ({NEXT_ITEM}: "
                         "cista-idnet and flow_half sharded); it serves on one process")


# ------------------------------- the ranks -----------------------------------

@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One rank of the spatial axis: its rank, the world, its device and the
    default process group's backend. On gloo with a CUDA device (ranks
    sharing one card) every exchange goes through the host."""
    world: int
    rank: int
    device: torch.device
    backend: str

    @classmethod
    def of(cls, mesh: data_mesh.DataMesh) -> "RowMesh":
        """The rank ``parallel.mesh.init_mesh`` (or ``launch``) joined."""
        return cls(mesh.world, mesh.rank, mesh.device, dist.get_backend())

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"


def _host(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.staged else t


def _back(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def halo(mesh: RowMesh, x: torch.Tensor, above: int, below: int):
    """(top, bottom): the last ``above`` rows (dim -2) of the band above and
    the first ``below`` rows of the band below; None at the frame's edge
    (and for a count of 0). Every rank calls it with the same counts."""
    rows = x.shape[-2]
    if rows < max(above, below):
        raise ValueError(f"a band of {rows} rows cannot give a halo of {max(above, below)}")
    r, n = mesh.rank, mesh.world
    ops, top, bottom = [], None, None
    src = _host(mesh, x)

    def shape(k):
        return (*x.shape[:-2], k, x.shape[-1])
    if r > 0 and below:               # my first rows are the bottom halo of rank r - 1
        ops.append(dist.P2POp(dist.isend, src[..., :below, :].contiguous(), r - 1))
    if r < n - 1 and above:           # my last rows are the top halo of rank r + 1
        ops.append(dist.P2POp(dist.isend, src[..., rows - above:, :].contiguous(), r + 1))
    if r > 0 and above:
        top = torch.empty(shape(above), dtype=x.dtype, device=src.device)
        ops.append(dist.P2POp(dist.irecv, top, r - 1))
    if r < n - 1 and below:
        bottom = torch.empty(shape(below), dtype=x.dtype, device=src.device)
        ops.append(dist.P2POp(dist.irecv, bottom, r + 1))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return (None if top is None else _back(mesh, top),
            None if bottom is None else _back(mesh, bottom))


def gather_rows(mesh: RowMesh, x: torch.Tensor, sizes) -> torch.Tensor:
    """The whole frame from every rank's band (dim -2), bands of ``sizes``
    rows in rank order: an all-gather of the bands padded to the largest."""
    most = max(sizes)
    src = _host(mesh, x)
    if x.shape[-2] < most:
        fill = torch.zeros((*x.shape[:-2], most - x.shape[-2], x.shape[-1]),
                           dtype=x.dtype, device=src.device)
        src = torch.cat([src, fill], dim=-2)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src.contiguous())
    return _back(mesh, torch.cat([p[..., :k, :] for p, k in zip(parts, sizes)], dim=-2))


def all_gather(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order (N, ...)."""
    src = _host(mesh, t).contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src)
    return _back(mesh, torch.stack(parts))


def all_reduce(mesh: RowMesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over the ranks, a new tensor."""
    y = _host(mesh, t).clone()
    dist.all_reduce(y, op=op)
    return _back(mesh, y)


def broadcast(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (``t`` of the same shape and dtype
    everywhere; its values matter on rank 0 only)."""
    y = _host(mesh, t).contiguous()
    dist.broadcast(y, 0)
    return _back(mesh, y)


class RowBand:
    """The band one rank holds while it steps (``ops.bands.rows``): its rows
    at every scale of both frames and the exchanges, which count the bytes
    they send (``sent``: per kind, this rank's)."""

    def __init__(self, mesh: RowMesh, part: Partition):
        if part.world != mesh.world:
            raise ValueError(f"a partition of {part.world} bands for {mesh.world} ranks")
        self.mesh, self.part = mesh, part
        self.pad_rows = part.pad if mesh.rank == 0 else 0
        self.sent = {"halo": 0, "gather": 0, "stats": 0}

    @property
    def rank(self) -> int:
        return self.mesh.rank

    def rows(self, scale: int = 1, padded: bool = False) -> tuple:
        return self.part.rows(self.mesh.rank, scale, padded)

    def take(self, frame: torch.Tensor, scale: int = 1, padded: bool = False) -> torch.Tensor:
        """This band's rows (dim -2) of a whole frame."""
        lo, hi, _ = self.rows(scale, padded)
        return frame[..., lo:hi, :].contiguous()

    def halo(self, x, above: int, below: int):
        top, bottom = halo(self.mesh, x, above, below)
        per_row = x[..., :1, :].numel() * x.element_size()
        r, n = self.mesh.rank, self.mesh.world
        self.sent["halo"] += per_row * ((below if r > 0 else 0) + (above if r < n - 1 else 0))
        return top, bottom

    def gather_rows(self, x, scale: int = 1, padded: bool = False) -> torch.Tensor:
        self.sent["gather"] += x.numel() * x.element_size()
        return gather_rows(self.mesh, x, self.part.sizes(scale, padded))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self.sent["stats"] += t.numel() * t.element_size()
        return all_gather(self.mesh, t)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool, true where ``flag`` is on some rank."""
        return all_reduce(self.mesh, flag.to(torch.int32), dist.ReduceOp.MAX).bool()


# ------------------------------ serving CLIs ---------------------------------

def serve(world: int, device, module: str, fn: str, cfg) -> None:
    """Run a serving CLI's body on ``world`` ranks (``parallel.mesh.launch``,
    or this process as one rank under ``torchrun``): rank 0 calls
    ``module.fn(cfg, recon=...)`` with a row-sharded ``Reconstructor`` and
    alone reads and writes; the others follow it. ``device`` 'cuda' is a
    card per rank over NCCL; 'cuda:K' puts every rank on card K over gloo
    (a correctness setup); 'cpu' runs gloo processes."""
    dev = torch.device(device)
    backend = "gloo" if dev.type == "cpu" or dev.index is not None else None
    data_mesh.launch(serve_rank, world, device, module, fn, cfg, backend=backend)


def serve_rank(mesh: data_mesh.DataMesh, module: str, fn: str, cfg) -> None:
    """One rank of ``serve``: the kernels built once per host (by its rank
    0, the others waiting), then rank 0 runs the body and the others follow
    its ``Reconstructor`` until it closes."""
    from ..ops import cuda_build
    from ..runner import Reconstructor
    if mesh.device.type == "cuda":
        if mesh.local_rank == 0:
            cuda_build.build_all(cuda_build.kernel_counters().values())
        mesh.barrier()
    recon = Reconstructor(cfg, batch=1, mesh=RowMesh.of(mesh))
    if not mesh.is_main:
        recon.follow()
        return
    try:
        getattr(importlib.import_module(module), fn)(cfg, recon=recon)
    finally:
        recon.close()
