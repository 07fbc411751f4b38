"""Row sharding: one stream's rows (serving) or one batch slice's rows
(training) over N ranks, one process each.

Counterpart of the spatial mesh axis of the JAX runner
(cista_flow_tpu/runner.py:74-86, 96-103, 140-148) and train step
(cista_flow_tpu/parallel/train_step.py:113-133): there ``--mesh_axes
spatial`` constrains the step's 4-D activations to ``P(..., "spatial",
None, None)`` and XLA inserts the exchanges; here each
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

In training the first three are ``torch.autograd.Function``s: a halo's
gradient goes back to the band that sent it, and a gathered frame's (or
the stacked statistics') is summed over the ranks, each band taking its
rows. The ranks of one batch slice form the axis's process group
(``RowMesh.group``, from ``parallel.mesh.Grid``).

``partition`` cuts the frame: band boundaries are multiples of 8 rows of
the flow net's padded frame, which ``ImagePadder`` pads at the top only, so
rank 0's band carries the padding; the boundaries are then even rows of the
unpadded frame, the CISTA half-resolution maps' too. A band needs 3 rows at
1/8 of the padded frame (the motion encoder's 7x7 ``convf1``) and 2*depth+1
rows at half resolution (the ISTA loop's one halo). Under ``flow_half`` the
flow net's frame is the x0.5 resize of the frame, and the cuts are
multiples of 8 rows of it padded.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import torch
import torch.distributed as dist

from ..ops.autograd import wants_grad
from . import mesh as data_mesh

ALIGN = 8              # band boundaries: rows of the padded frame, the encoders' stride
PAD_MULTIPLE = 32      # ImagePadder's min_size for the flow nets
MIN_ROWS_8 = 3         # a band's rows at 1/8: the 7x7 convf1's halo


@dataclasses.dataclass(frozen=True)
class Partition:
    """The rows of a frame of ``height`` rows over the ranks: ``cuts`` are
    the band boundaries in the flow net's frame padded by ``pad`` rows at
    the top (0 and the padded height at the ends). The flow net's frame is
    the frame at 1/``down``: 1, or 2 under ``flow_half``, whose flow net
    runs on the x0.5 resize of the frame."""
    height: int
    pad: int
    cuts: tuple
    down: int = 1

    @property
    def world(self) -> int:
        return len(self.cuts) - 1

    def sizes(self, scale: int = 1, padded: bool = False) -> list:
        """Every band's rows at 1/``scale``, in rank order."""
        return [b - a for a, b, _ in (self.rows(r, scale, padded) for r in range(self.world))]

    def rows(self, rank: int, scale: int = 1, padded: bool = False) -> tuple:
        """(first, stop, frame rows) of ``rank``'s band at 1/``scale`` of the
        flow net's padded frame or of the unpadded frame."""
        lo, hi = self.cuts[rank], self.cuts[rank + 1]
        total = self.height // self.down + self.pad
        if not padded:
            lo, hi = max(lo - self.pad, 0) * self.down, (hi - self.pad) * self.down
            total = self.height
        return lo // scale, hi // scale, total // scale


def _even_cuts(height: int, world: int, down: int) -> Partition:
    rows = height // down
    pad = (PAD_MULTIPLE - rows % PAD_MULTIPLE) % PAD_MULTIPLE
    inner = [ALIGN * int((pad + r * rows / world) / ALIGN + 0.5) for r in range(1, world)]
    return Partition(height, pad, (0, *inner, rows + pad), down)


def _thick_enough(part: Partition, depth: int) -> bool:
    return (all(n >= MIN_ROWS_8 for n in part.sizes(ALIGN, padded=True))
            and all(n >= 2 * depth + 1 for n in part.sizes(2)))


def max_world(image_dim, depth: int, half: bool = False) -> int:
    """The most ranks whose bands ``partition`` accepts."""
    world = 1
    while _thick_enough(_even_cuts(int(image_dim[0]), world + 1, 1 + half), depth):
        world += 1
    return world


def partition(image_dim, world: int, depth: int, half: bool = False) -> Partition:
    """Bands as even as the rule lets them be in the unpadded frame; raises
    ValueError where a band would be too thin, naming the largest rank
    count the frame allows. ``half``: the flow net runs on the frame's x0.5
    resize (``flow_half``): the cuts are multiples of 8 rows of that
    frame padded, so even rows of the frame."""
    height = int(image_dim[0])
    if height % 2:
        raise ValueError(f"a frame of {height} rows: the row bands need an even height")
    part = _even_cuts(height, world, 1 + half)
    if not _thick_enough(part, depth):
        frame = "the half frame's padded rows" if half else "the padded frame"
        raise ValueError(
            f"{world} ranks: a frame of {height} rows gives bands thinner than the "
            f"encoders and the ISTA loop take ({MIN_ROWS_8} rows at 1/8 of {frame}, "
            f"{2 * depth + 1} at half resolution); at most "
            f"{max_world(image_dim, depth, half)} ranks for this frame")
    return part


def partition_for(cfg, world: int) -> Partition:
    """``partition`` of a config's frame: the half frame's under ``flow_half``."""
    return partition(cfg.image_dim, world, cfg.depth, half=bool(cfg.flow_half))


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
    partition_for(cfg, world)
    return world


def serving_ranks(parser, cfg) -> int | None:
    """``serving_world`` for a CLI: its refusals end the parse with their
    message."""
    try:
        return serving_world(cfg)
    except ValueError as e:
        parser.error(str(e))


# ------------------------------- the ranks -----------------------------------

@dataclasses.dataclass(frozen=True)
class RowMesh:
    """One rank of the spatial axis: its index on the axis, the axis's
    size, its device, the backend, and the axis's process group (None: the
    default group) with its members' global ranks in band order (empty:
    0 to world - 1). On gloo with a CUDA device (ranks sharing one card)
    every exchange goes through the host."""
    world: int
    rank: int
    device: torch.device
    backend: str
    group: object = None
    peers: tuple = ()

    @classmethod
    def of(cls, mesh: data_mesh.DataMesh) -> "RowMesh":
        """The rank ``parallel.mesh.init_mesh`` (or ``launch``) joined, every
        rank on the spatial axis."""
        return cls(mesh.world, mesh.rank, mesh.device, dist.get_backend())

    @classmethod
    def of_grid(cls, grid: data_mesh.Grid) -> "RowMesh":
        """The spatial axis of a (data, spatial) mesh: the ranks of this
        rank's data index."""
        return cls(grid.spatial, grid.spatial_index, grid.mesh.device, dist.get_backend(),
                   grid.spatial_group, grid.spatial_peers)

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def peer(self, r: int) -> int:
        """The global rank of band ``r``."""
        return self.peers[r] if self.peers else r


def _host(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    return t.cpu() if mesh.staged else t


def _back(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def _swap(mesh: RowMesh, up, down, from_up: tuple | None, from_down: tuple | None, like):
    """Send ``up`` to the band above and ``down`` to the band below (None:
    nothing), and receive tensors of shapes ``from_up`` and ``from_down``
    from them (None: nothing); returns what arrived, on the device."""
    r = mesh.rank
    ops, got = [], [None, None]
    for t, peer in ((up, r - 1), (down, r + 1)):
        if t is not None:
            ops.append(dist.P2POp(dist.isend, _host(mesh, t).contiguous(), mesh.peer(peer),
                                  mesh.group))
    for i, (shape, peer) in enumerate(((from_up, r - 1), (from_down, r + 1))):
        if shape is not None:
            got[i] = torch.empty(shape, dtype=like.dtype,
                                 device="cpu" if mesh.staged else like.device)
            ops.append(dist.P2POp(dist.irecv, got[i], mesh.peer(peer), mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(None if t is None else _back(mesh, t) for t in got)


def _rows_shape(x: torch.Tensor, k: int) -> tuple:
    return (*x.shape[:-2], k, x.shape[-1])


def _halo(mesh: RowMesh, x: torch.Tensor, above: int, below: int):
    rows = x.shape[-2]
    if rows < max(above, below):
        raise ValueError(f"a band of {rows} rows cannot give a halo of {max(above, below)}")
    first, last = mesh.rank == 0, mesh.rank == mesh.world - 1
    return _swap(mesh,
                 None if first or not below else x[..., :below, :],   # rank r-1's bottom halo
                 None if last or not above else x[..., rows - above:, :],  # rank r+1's top
                 None if first or not above else _rows_shape(x, above),
                 None if last or not below else _rows_shape(x, below), x)


class _Halo(torch.autograd.Function):
    """``halo`` under autograd: the halo rows' gradient goes back to the
    neighbour that owns them and is added to its rows there. The frame's
    edges give 0-row outputs (None to the caller)."""

    @staticmethod
    def forward(ctx, mesh, sent, x, above, below):
        ctx.mesh, ctx.sent, ctx.above, ctx.below = mesh, sent, above, below
        ctx.shape = x.shape
        top, bottom = _halo(mesh, x, above, below)
        empty = x.new_empty(_rows_shape(x, 0))
        return (empty if top is None else top), (empty.clone() if bottom is None else bottom)

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        mesh, above, below = ctx.mesh, ctx.above, ctx.below
        first, last = mesh.rank == 0, mesh.rank == mesh.world - 1
        shape = ctx.shape
        rows_of = (lambda k: (*shape[:-2], k, shape[-1]))
        g_first, g_last = _swap(mesh, None if first or not above else g_top,
                                None if last or not below else g_bottom,
                                None if first or not below else rows_of(below),
                                None if last or not above else rows_of(above), g_top)
        if ctx.sent is not None:
            per_row = g_top.element_size() * math.prod(shape[:-2]) * shape[-1]
            ctx.sent["halo_grad"] = ctx.sent.get("halo_grad", 0) + per_row * (
                (0 if first else above) + (0 if last else below))
        grad = g_top.new_zeros(shape)
        if g_first is not None:
            grad[..., :below, :] += g_first
        if g_last is not None:
            grad[..., shape[-2] - above:, :] += g_last
        return None, None, grad, None, None


def halo(mesh: RowMesh, x: torch.Tensor, above: int, below: int, sent: dict | None = None):
    """(top, bottom): the last ``above`` rows (dim -2) of the band above and
    the first ``below`` rows of the band below; None at the frame's edge
    (and for a count of 0). Every rank calls it with the same counts.
    Differentiable where ``x`` requires a gradient (``sent`` then counts
    the backward's bytes under 'halo_grad')."""
    if not wants_grad(x):
        return _halo(mesh, x, above, below)
    top, bottom = _Halo.apply(mesh, sent, x, above, below)
    return (None if top.shape[-2] == 0 else top, None if bottom.shape[-2] == 0 else bottom)


def _all_gather(mesh: RowMesh, src: torch.Tensor) -> list:
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src.contiguous(), group=mesh.group)
    return parts


def _gather_rows(mesh: RowMesh, x: torch.Tensor, sizes) -> torch.Tensor:
    most = max(sizes)
    src = _host(mesh, x)
    if x.shape[-2] < most:
        fill = torch.zeros((*x.shape[:-2], most - x.shape[-2], x.shape[-1]),
                           dtype=x.dtype, device=src.device)
        src = torch.cat([src, fill], dim=-2)
    parts = _all_gather(mesh, src)
    return _back(mesh, torch.cat([p[..., :k, :] for p, k in zip(parts, sizes)], dim=-2))


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` under autograd. Each rank's frame feeds its own
    consumers (a band's correlation, its warps, a loss), so a band's
    gradient is the sum over the ranks of their frame's gradient at its
    rows: an all-reduce of the frame's gradient, then the band's rows."""

    @staticmethod
    def forward(ctx, mesh, sent, x, sizes):
        ctx.mesh, ctx.sent = mesh, sent
        ctx.first, ctx.rows = sum(sizes[:mesh.rank]), x.shape[-2]
        return _gather_rows(mesh, x, sizes)

    @staticmethod
    def backward(ctx, grad):
        if ctx.sent is not None:
            ctx.sent["gather_grad"] = (ctx.sent.get("gather_grad", 0)
                                       + grad.numel() * grad.element_size())
        total = all_reduce(ctx.mesh, grad)
        return None, None, total[..., ctx.first:ctx.first + ctx.rows, :].contiguous(), None


def gather_rows(mesh: RowMesh, x: torch.Tensor, sizes, sent: dict | None = None) -> torch.Tensor:
    """The whole frame from every rank's band (dim -2), bands of ``sizes``
    rows in rank order: an all-gather of the bands padded to the largest.
    Differentiable where ``x`` requires a gradient (``_GatherRows``)."""
    if not wants_grad(x):
        return _gather_rows(mesh, x, sizes)
    return _GatherRows.apply(mesh, sent, x, list(sizes))


class _AllGather(torch.autograd.Function):
    """``all_gather`` under autograd: the gradient of this rank's entry is
    the sum over the ranks of theirs."""

    @staticmethod
    def forward(ctx, mesh, sent, t):
        ctx.mesh, ctx.sent = mesh, sent
        return _back(mesh, torch.stack(_all_gather(mesh, _host(mesh, t))))

    @staticmethod
    def backward(ctx, grad):
        if ctx.sent is not None:
            ctx.sent["stats_grad"] = (ctx.sent.get("stats_grad", 0)
                                      + grad.numel() * grad.element_size())
        return None, None, all_reduce(ctx.mesh, grad)[ctx.mesh.rank]


def all_gather(mesh: RowMesh, t: torch.Tensor, sent: dict | None = None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order (N, ...); differentiable
    where ``t`` requires a gradient."""
    if wants_grad(t):
        return _AllGather.apply(mesh, sent, t)
    return _back(mesh, torch.stack(_all_gather(mesh, _host(mesh, t))))


def all_reduce(mesh: RowMesh, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The sum (or ``op``) of ``t`` over the ranks, a new tensor."""
    y = _host(mesh, t).clone()
    dist.all_reduce(y, op=op, group=mesh.group)
    return _back(mesh, y)


def broadcast(mesh: RowMesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (``t`` of the same shape and dtype
    everywhere; its values matter on rank 0 only)."""
    y = _host(mesh, t).contiguous()
    dist.broadcast(y, mesh.peer(0), group=mesh.group)
    return _back(mesh, y)


class RowBand:
    """The band one rank holds while it steps (``ops.bands.rows``): its rows
    at every scale of both frames and the exchanges, which count the bytes
    they send (``sent``: per kind, this rank's; a backward's under
    '<kind>_grad')."""

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
        top, bottom = halo(self.mesh, x, above, below, self.sent)
        per_row = x[..., :1, :].numel() * x.element_size()
        r, n = self.mesh.rank, self.mesh.world
        self.sent["halo"] += per_row * ((below if r > 0 else 0) + (above if r < n - 1 else 0))
        return top, bottom

    def gather_rows(self, x, scale: int = 1, padded: bool = False) -> torch.Tensor:
        self.sent["gather"] += x.numel() * x.element_size()
        return gather_rows(self.mesh, x, self.part.sizes(scale, padded), self.sent)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        self.sent["stats"] += t.numel() * t.element_size()
        return all_gather(self.mesh, t, self.sent)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-dim bool, true where ``flag`` is on some rank; no gradient."""
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
