"""The data-parallel mesh over ``torch.distributed``: one process per card.

Counterpart of the data axis of cista_flow_tpu/parallel/mesh.py. There one
program steps over a ``jax.sharding.Mesh`` with the batch sharded on
'data' and XLA inserting the gradient all-reduce; here each rank is a
process that steps on its slice of the batch, and the collectives are
explicit: ``replicate_`` (``replicate_tree``), ``all_reduce_mean_`` (the
gradient all-reduce) and ``all_reduce_sum`` (the differentiable sum that
gives BatchNorm its global batch statistics, ``ops.conv.global_bn_stats``).

Ranks come from ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` and its rendezvous address) or, with no such
environment, from ``launch``, which spawns them on this host on a free
local port, as the JAX trainer uses every local device from one command
line. The backend follows the device: NCCL for CUDA (each rank on
``cuda:{local_rank}``), gloo for the CPU. ``backend="gloo"`` with a CUDA
device is for two ranks on one card, which NCCL refuses; nothing falls back
from one backend to the other.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket

import torch
import torch.distributed as dist

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
TIMEOUT = datetime.timedelta(minutes=10)


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank of the data axis. ``host`` and ``n_hosts`` index the hosts
    (ranks ``host * local_world`` to ``(host + 1) * local_world - 1``
    share one), ``local_rank`` the rank on its host, ``device`` its card
    (or the CPU)."""
    world: int
    rank: int
    local_rank: int
    local_world: int
    host: int
    n_hosts: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def barrier(self) -> None:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def under_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, local_rank: int, backend: str) -> torch.device:
    """The card of ``local_rank``: ``cuda:{local_rank}`` for a device with
    no index; a device with an index (``cuda:0``) holds every rank of the
    host, which only gloo allows."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"no data-parallel ranks on {device}")
    if device.index is not None:
        if backend == "nccl" and local_rank > 0:
            raise ValueError(f"NCCL needs one card per rank, not every rank on {device}")
        return device
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} has no card: "
                           f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", local_rank)


def init_mesh(device, rank: int | None = None, world: int | None = None,
              local_world: int | None = None, init_method: str = "env://",
              backend: str | None = None) -> DataMesh:
    """Join the process group and return this rank's ``DataMesh``. With no
    ranks given they come from ``torchrun``'s environment (its rendezvous
    through ``env://``); ``launch`` gives them and a ``tcp://`` address.
    A CUDA rank's card is made the current device before the first
    collective."""
    if rank is None:
        if not under_torchrun():
            raise RuntimeError("no ranks given and no torchrun environment "
                               f"({', '.join(TORCHRUN_VARS)})")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local_world = int(os.environ["LOCAL_WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
    else:
        local_world = world if local_world is None else local_world
        local_rank = rank % local_world
    if world % local_world:
        raise ValueError(f"world {world} is not a whole number of hosts of {local_world}")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    device = rank_device(device, local_rank, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    return DataMesh(world=world, rank=rank, local_rank=local_rank, local_world=local_world,
                    host=rank // local_world, n_hosts=world // local_world, device=device)


def _spawned(rank: int, fn, world: int, port: int, device, backend, args) -> None:
    """One spawned rank: join the group, run ``fn(mesh, *args)``, leave."""
    if torch.device(device).type == "cpu":
        # the host's cores are shared by its ranks
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    mesh = init_mesh(device, rank, world, init_method=f"tcp://127.0.0.1:{port}",
                     backend=backend)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, device, *args, backend: str | None = None) -> None:
    """Run ``fn(mesh, *args)`` on ``world`` data-parallel ranks. Under
    ``torchrun`` this process is one of them; else ``world`` processes are
    spawned on this host (``fn`` and ``args`` must pickle: ``fn`` lives in
    a package module, since spawn re-imports ``__main__``) and joined. A
    rank that raises ends the run: the others are terminated and the error
    is raised here."""
    if under_torchrun():
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"torchrun's WORLD_SIZE {os.environ['WORLD_SIZE']} is not the "
                             f"mesh's {world}")
        mesh = init_mesh(device, backend=backend)
        try:
            fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        return
    if world == 1:
        _spawned(0, fn, 1, free_port(), device, backend, args)
        return
    torch.multiprocessing.spawn(_spawned, args=(fn, world, free_port(), device, backend, args),
                                nprocs=world, join=True)


# ----------------------------- the 2-D mesh --------------------------------

@dataclasses.dataclass(frozen=True)
class Grid:
    """One rank of a (data, spatial) mesh of ``data`` x ``spatial`` ranks,
    numbered ``d * spatial + s`` (the row-major order of the JAX package's
    ``make_mesh``): the ranks of one data index hold the bands of one slice
    of the batch (``spatial_group``, members ``spatial_peers``; None: the
    default group). The gradients need no group of the data axis: summed
    over every rank and divided by ``data`` they are the sum over the bands
    averaged over the slices."""
    mesh: DataMesh
    data: int
    spatial: int
    spatial_group: object
    spatial_peers: tuple

    @property
    def data_index(self) -> int:
        return self.mesh.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.mesh.rank % self.spatial

    @property
    def is_main(self) -> bool:
        return self.mesh.is_main

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def barrier(self) -> None:
        self.mesh.barrier()

    def loader_shard(self) -> dict:
        """The loader's shard of this rank: its data index's slice of the
        host batch (every band of a slice reads the same sequences). A host
        holds whole spatial groups."""
        m = self.mesh
        if m.local_world % self.spatial:
            raise ValueError(f"{m.local_world} ranks a host do not hold whole spatial groups "
                             f"of {self.spatial}")
        return dict(process_index=m.host, process_count=m.n_hosts,
                    local_index=m.local_rank // self.spatial,
                    local_count=m.local_world // self.spatial)


def make_grid(mesh: DataMesh, data: int, spatial: int) -> Grid:
    """The (data, spatial) mesh over every rank of ``mesh``. With more than
    one data index each rank makes every spatial group (``dist.new_group``
    is collective, in one order on all ranks) and keeps its own; with one,
    the spatial axis is the default group."""
    if data * spatial != mesh.world:
        raise ValueError(f"a {data}x{spatial} mesh over {mesh.world} ranks")
    d = mesh.rank // spatial
    group = None
    if data > 1 and spatial > 1:
        for i in range(data):
            g = dist.new_group(list(range(i * spatial, (i + 1) * spatial)))
            group = g if i == d else group
    return Grid(mesh, data, spatial, group, tuple(range(d * spatial, (d + 1) * spatial)))


# ----------------------------- collectives ---------------------------------

def replicate_(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` broadcast from rank 0
    (``replicate_tree``)."""
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, 0)


def all_reduce_mean_(tensors, divisor: int | None = None) -> None:
    """Each tensor replaced by its mean over the ranks, in place: one
    flattened bucket per dtype, summed (gloo has no AVG) and divided by the
    world size (or by ``divisor``: the data axis's size, where the ranks of
    a spatial axis hold partial sums)."""
    world = dist.get_world_size() if divisor is None else divisor
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat /= world
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """A SUM all-reduce whose backward is a SUM all-reduce of the incoming
    gradient (``SyncBatchNorm``'s rule): each rank's gradient is then that
    of the sum of every rank's loss, so the mean of the ranks' parameter
    gradients is the gradient of the mean loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable."""
    return _AllReduceSum.apply(x)
