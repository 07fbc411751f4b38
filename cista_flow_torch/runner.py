"""Streaming reconstructor for every model mode's serving step.

Counterpart of cista_flow_tpu/runner.py ``Reconstructor`` (ref:
test_with_flow.py:24-88): build the composite, load
``cfg.path_to_test_model`` (reference key layout; with
``load_epoch_for_test`` the checkpoint of that epoch in the folder), then
step it in a closed loop. ``step_window`` runs a whole window on the device
and copies to the host once at the end: a Python loop over the steps, or
for cista-eraft the time-parallel window (all flows in one call, then the
recurrence), whose flow needs the previous voxel and no reconstruction.
With ``use_gt_flow`` every mode's warps follow the given GT flows (and
cista-eraft's window steps). In f32 the steps run with cuDNN's TF32 off
(``device.cudnn_fp32``), and the caller's flags are left as they were.

With a ``mesh`` (``parallel.spatial.RowMesh``: ``--mesh_shape N
--mesh_axes spatial``) one stream's rows are split over N ranks, a process
each (cista_flow_tpu/runner.py:74-86, 96-103): every rank keeps its band of
the state, the previous frame and ``extra``; ``step``, ``step_window`` and
``run_window`` take the whole frame on rank 0, which broadcasts it, and
return the whole frame on rank 0 alone (None elsewhere). The other ranks
either make the same calls, or ``follow()`` rank 0's until it ``close()``s.

While a torch profiler records, a call of ``step`` or ``step_window`` is
the span ``cista.runner.call`` around ``runner.upload`` (host arrays to
the device), ``runner.issue`` (the step or window issued), ``runner.wait``
(an explicit wait for the issued work, made only then) and
``runner.download`` (frames and flows to the host), and counts
``runner.bytes_up``, ``runner.bytes_down`` and, on the card,
``runner.device_allocs`` (the call's new device allocations). Otherwise
none of this runs (``utils.profiling``).
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from . import weights
from .device import DTYPES, cudnn_fp32, resolve_device
from .models import composite
from .models.cista_lstc import zero_state as cista_zero_state
from .ops import bands
from .utils import profiling

# what rank 0 tells the other ranks of a row-sharded Reconstructor
CLOSE, RESET, STEP, WINDOW = range(4)


def model_name_from_cfg(cfg) -> str:
    """The output folder's name of a model built from the config alone
    (cista_flow_tpu/runner.py:21-26)."""
    base = f"{cfg.model_mode}_b{cfg.num_bins}_d{cfg.depth}_c{cfg.base_channels}"
    return f"{cfg.model_name}_{base}" if cfg.model_name else base


def checkpoint_and_name(cfg) -> tuple:
    """(checkpoint path or None, model name), as the JAX runner names them
    (cista_flow_tpu/runner.py:38-52): with ``load_epoch_for_test`` the
    checkpoint ``<folder>/<folder name>_<epoch>.pth.tar`` under the name
    ``<folder name>/<epoch>``; else the file's name without its extension."""
    path = cfg.path_to_test_model
    if not path:
        return None, model_name_from_cfg(cfg)
    if cfg.load_epoch_for_test:
        name = path.rstrip("/").split("/")[-1]
        return (os.path.join(path, f"{name}_{cfg.load_epoch_for_test}.pth.tar"),
                f"{name}/{cfg.load_epoch_for_test}")
    return path, os.path.splitext(os.path.basename(path))[0]


class Reconstructor:
    """Closed-loop reconstructor over a batch of ``batch`` streams; with a
    ``mesh``, this rank's band of their rows."""

    def __init__(self, cfg, device=None, batch: int = 1, mesh=None):
        self.cfgs = cfg
        self.band = None
        if mesh is not None and mesh.world > 1:
            from .parallel import spatial
            self.band = spatial.RowBand(mesh, spatial.partition_for(cfg, mesh.world))
            device = mesh.device
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        self.batch = batch
        self.image_dim = tuple(cfg.image_dim)
        self.model = composite.init(cfg, device="cpu")
        path, self.model_name = checkpoint_and_name(cfg)
        if path:
            self.model.load_reference_state(weights.load_state_dict(path))
        if cfg.path_to_e2v:
            # a CISTA-LSTC checkpoint over the composite's (ref: test_with_flow.py:70-72)
            sd = weights.tie_ista_blocks(weights.load_state_dict(cfg.path_to_e2v), cfg.depth)
            self.model.cista_net.load_state_dict(
                {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, strict=True)
        self.model.to(self.device, self.dtype)
        self.iters = cfg.default_flow_iters()
        self.mode = cfg.model_mode
        self._zero()

    def reset(self):
        """New sequence: zero state, zero previous frame and zero ``extra``:
        the previous voxel for cista-eraft, the chained next-step flow at
        the padded resolution (a multiple of 32) for cista-idnet. On a mesh
        every rank zeroes its band (rank 0 tells the others); cista-idnet's
        is the band's rows of the padded frame, rank 0's with the padding."""
        if self.band is not None:
            self._command(RESET)
        self._zero()

    def _zero(self):
        h, w = self.image_dim
        hp = (h + 31) // 32 * 32
        if self.band is not None:
            first, stop, _ = self.band.rows()
            h = stop - first
            first, stop, _ = self.band.rows(padded=True)
            hp = stop - first
        b, dt, dev = self.batch, self.dtype, self.device
        self.state = cista_zero_state(b, (h, w), self.cfgs.base_channels, dt, dev)
        self.prev_image = torch.zeros((b, 1, h, w), dtype=dt, device=dev)
        self.extra = None
        if self.mode == "cista-eraft":
            self.extra = torch.zeros((b, self.cfgs.num_bins, h, w), dtype=dt, device=dev)
        elif self.mode == "cista-idnet":
            self.extra = torch.zeros((b, 2, hp, (w + 31) // 32 * 32), dtype=dt, device=dev)

    def _precision(self):
        """f32: cuDNN without TF32 for the call; bf16: the caller's flags."""
        return cudnn_fp32() if self.dtype == torch.float32 else contextlib.nullcontext()

    @torch.no_grad()
    def run_step(self, events: torch.Tensor, gt_flow: torch.Tensor | None = None):
        """One step on the device: events (B, bins, H, W) in the compute
        dtype (and, to have the warps follow it, ``gt_flow`` (B, 2, H, W)
        in f32) -> (rec (B, 1, H, W), flow (B, 2, H, W)); carries the state,
        the frame and ``extra``. The flow returned is the flow net's (the
        GT flow in the no-flow modes), as the JAX runner returns it."""
        with profiling.annotate("runner.issue"):
            if self.band is not None:
                recs, flows = self._on_bands(
                    STEP, None if events is None else events[None],
                    None if gt_flow is None else gt_flow[None])
                return (None, None) if recs is None else (recs[0], flows[0])
            return self._step(events, gt_flow)

    def _step(self, events, gt_flow):
        batch_gt = {} if gt_flow is None else {"gt_flow": gt_flow}
        with self._precision():
            if self.mode == "cista-eraft":
                rec, batch_flow, self.state = self.model(
                    events, self.prev_image, self.state, self.extra, iters=self.iters,
                    batch_gt=batch_gt)
                self.extra = events
            elif self.mode == "cista-idnet":
                rec, batch_flow, self.state = self.model(
                    events, self.prev_image, self.state, iters=self.iters,
                    flow_init=self.extra, batch_gt=batch_gt)
                self.extra = batch_flow["next_flow"]
            else:
                rec, batch_flow, self.state = self.model(
                    events, self.prev_image, self.state, iters=self.iters, batch_gt=batch_gt)
        self.prev_image = rec
        return rec, batch_flow["flow_final"]

    @torch.no_grad()
    def run_window(self, events: torch.Tensor, gt_flows: torch.Tensor | None = None):
        """events: (T, B, bins, H, W) on the device in the compute dtype;
        ``gt_flows`` (T, B, 2, H, W) in f32 or None. Returns recs
        (T, B, 1, H, W) and flows (T, B, 2, H, W) on the device, and carries
        the state, the last frame and ``extra`` to the next call. cista-eraft
        without GT flows takes the time-parallel window; with them it steps,
        as the JAX runner does (cista_flow_tpu/runner.py:152)."""
        with profiling.annotate("runner.issue"):
            if self.band is not None:
                return self._on_bands(WINDOW, events, gt_flows)
            return self._window(events, gt_flows)

    def _window(self, events, gt_flows):
        if self.mode == "cista-eraft" and gt_flows is None:
            with self._precision():
                recs, flows, self.state = self.model.forward_window(
                    torch.cat([self.extra[None], events]), self.prev_image,
                    self.state, iters=self.iters)
            self.prev_image, self.extra = recs[-1], events[-1]
            return recs, flows
        out = [self._step(ev, None if gt_flows is None else gt_flows[t])
               for t, ev in enumerate(events)]
        return torch.stack([r for r, _ in out]), torch.stack([f for _, f in out])

    # ---- a row-sharded stream (``mesh``) ----

    def _command(self, op, steps: int = 0, has_gt: bool = False) -> list:
        """[op, steps, has_gt] as rank 0 sends it to every rank; ``op`` None
        takes whatever rank 0 sends, else it must be rank 0's."""
        from .parallel import spatial
        head = torch.tensor([-1 if op is None else op, steps, int(has_gt)], dtype=torch.int64,
                            device=self.device)
        got = spatial.broadcast(self.band.mesh, head).tolist()
        if op is not None and got[0] != op:
            raise RuntimeError(f"rank {self.band.rank} called {op} where rank 0 called {got[0]}")
        return got

    def _on_bands(self, op, events, gt_flows, head=None):
        """A step or a window on this rank's band: rank 0's whole-frame
        ``events`` (and ``gt_flows``) broadcast, the band's rows run, the
        whole frame's (recs, flows) gathered back to rank 0 ((None, None)
        elsewhere)."""
        from .parallel import spatial
        band = self.band
        if head is None:
            lead = band.rank == 0
            head = self._command(op, events.shape[0] if lead else 0,
                                 lead and gt_flows is not None)
        _, steps, has_gt = head
        h, w = self.image_dim
        if band.rank != 0:
            events = torch.empty((steps, self.batch, self.cfgs.num_bins, h, w),
                                 dtype=self.dtype, device=self.device)
            gt_flows = (torch.empty((steps, self.batch, 2, h, w), device=self.device)
                        if has_gt else None)
        events = band.take(spatial.broadcast(band.mesh, events))
        if has_gt:
            gt_flows = band.take(spatial.broadcast(band.mesh, gt_flows))
        with bands.rows(band):
            if op == STEP:
                rec, flow = self._step(events[0], gt_flows[0] if has_gt else None)
                recs, flows = rec[None], flow[None]
            else:
                recs, flows = self._window(events, gt_flows)
        recs, flows = band.gather_rows(recs), band.gather_rows(flows)
        return (recs, flows) if band.rank == 0 else (None, None)

    @torch.no_grad()
    def follow(self) -> None:
        """A rank other than 0 of a row-sharded stream: make rank 0's calls
        (``reset``, ``run_step``, ``run_window`` and those through them)
        until it calls ``close``."""
        while True:
            head = self._command(None)
            if head[0] == CLOSE:
                return
            if head[0] == RESET:
                self._zero()
            else:
                self._on_bands(head[0], None, None, head)

    def close(self) -> None:
        """End a row-sharded stream: the ranks in ``follow`` return."""
        if self.band is not None:
            self._command(CLOSE)

    def device_events(self, voxels) -> torch.Tensor:
        v = np.asarray(voxels, np.float32)
        if v.ndim == 4:                  # (T, bins, H, W): one stream
            v = v[:, None]
        if v.shape[1] != self.batch:
            raise ValueError(f"voxels for {v.shape[1]} streams, reconstructor "
                             f"has {self.batch}")
        profiling.count("runner.bytes_up", v.nbytes)
        with profiling.annotate("runner.upload"):
            return torch.from_numpy(v).to(self.device, self.dtype)

    def device_flows(self, flows, steps: int, use_gt_flow: bool):
        """GT flows (T, 2, H, W) (or (T, B, 2, H, W)) as f32 on the device
        when ``use_gt_flow``, zeros where none are given (as the JAX runner
        passes zeros); None otherwise."""
        if not use_gt_flow:
            return None
        h, w = self.image_dim
        if flows is None:
            return torch.zeros((steps, self.batch, 2, h, w), device=self.device)
        f = np.asarray(flows, np.float32)
        if f.ndim == 4:
            f = f[:, None]
        profiling.count("runner.bytes_up", f.nbytes)
        with profiling.annotate("runner.upload"):
            return torch.from_numpy(f).to(self.device)

    def step(self, voxel_chw: np.ndarray, gt_flow_chw: np.ndarray | None = None,
             use_gt_flow: bool = False):
        """One reconstruction. voxel: (bins, H, W) (or (B, bins, H, W));
        with ``use_gt_flow`` the warps follow ``gt_flow_chw`` (2, H, W).
        Returns (rec (H, W), flow (2, H, W)) as f32 numpy, batch axis kept
        when B > 1. For cista-eraft this is the stepwise path (fnet on the
        previous and the current voxel); ``step_window`` is the
        time-parallel one."""
        with profiling.annotate("runner.call"):
            if self.band is not None and self.band.rank != 0:
                self.run_step(None)      # rank 0's step, on this rank's band
                return None
            allocs = self._device_allocs()
            gt = self.device_flows(
                None if gt_flow_chw is None else np.asarray(gt_flow_chw)[None], 1, use_gt_flow)
            rec, flow = self.run_step(self.device_events(np.asarray(voxel_chw)[None])[0],
                                      None if gt is None else gt[0])
            out = self._to_host(rec[None], flow[None], return_all=False)
            self._count_allocs(allocs)
            return out

    def step_window(self, voxels, gt_flows_chw=None, use_gt_flow: bool = False,
                    return_all: bool = False):
        """T reconstructions, one host transfer. ``voxels``: a list or array
        of (bins, H, W) voxels (or (T, B, bins, H, W)); with ``use_gt_flow``
        the warps follow ``gt_flows_chw``, T flows (2, H, W). Returns the
        last step's (rec (H, W), flow (2, H, W)), or with ``return_all``
        every step's (recs (T, H, W), flows (T, 2, H, W)); a batch axis
        follows T when B > 1. On a mesh, rank 0's; None elsewhere."""
        with profiling.annotate("runner.call"):
            if self.band is not None and self.band.rank != 0:
                self.run_window(None)    # rank 0's window, on this rank's band
                return None
            if len(voxels) == 0:
                raise ValueError("empty window")
            allocs = self._device_allocs()
            recs, flows = self.run_window(
                self.device_events(voxels),
                self.device_flows(gt_flows_chw, len(voxels), use_gt_flow))
            out = self._to_host(recs, flows, return_all)
            self._count_allocs(allocs)
            return out

    def _device_allocs(self):
        """The card's count of device allocations so far, while a profiler
        records; None otherwise, and off the card."""
        if self.device.type != "cuda" or not profiling.enabled():
            return None
        return torch.cuda.memory_stats(self.device)["num_device_alloc"]

    def _count_allocs(self, allocs_before) -> None:
        """Counts the call's new device allocations (``allocs_before``: the
        call's ``_device_allocs()`` at its start; None counts nothing)."""
        if allocs_before is not None:
            profiling.count("runner.device_allocs", self._device_allocs() - allocs_before)

    def _to_host(self, recs, flows, return_all: bool):
        if profiling.enabled():
            with profiling.annotate("runner.wait"):
                if recs.is_cuda:         # the work issued so far, waited for here
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(recs.device))
                    done.synchronize()
        with profiling.annotate("runner.download"):
            recs = recs[:, :, 0].float().cpu().numpy()
            flows = flows.float().cpu().numpy()
        profiling.count("runner.bytes_down", recs.nbytes + flows.nbytes)
        if self.batch == 1:
            recs, flows = recs[:, 0], flows[:, 0]
        if return_all:
            return recs, flows
        return recs[-1], flows[-1]


def discover_sequences(path_to_test_data: str) -> list[str]:
    """Sorted sequence sub-folders (ref: test_with_flow.py:39-43)."""
    out = [os.path.join(path_to_test_data, d)
           for d in os.listdir(path_to_test_data)
           if os.path.isdir(os.path.join(path_to_test_data, d))]
    return sorted(out)
