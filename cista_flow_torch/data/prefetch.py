"""Host-to-device prefetching for the training loop.

Counterpart of cista_flow_tpu/data/prefetch.py: keep ``size`` batches in
flight, so that the copies of the next batches overlap the current step.
JAX's transfers are asynchronous by themselves; here each batch goes
through pinned host memory into ``non_blocking`` copies on a side stream,
with an event that the consumer's stream waits on before it reads the
batch, and ``record_stream`` on what the consumer receives, so that the
allocator does not hand its memory to the side stream while the consumer's
work on it is still queued.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def to_tensors(batch: dict) -> dict:
    """A host batch (dict of numpy arrays) as f32 CPU tensors."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).float() for k, v in batch.items()}


def device_prefetch(iterator: Iterable, size: int = 2, put: Callable | None = None,
                    device=None) -> Iterator[dict]:
    """Yield ``put(batch)`` (default ``to_tensors``: a dict of CPU tensors)
    for each batch of ``iterator``, in order, on ``device``, with up to
    ``size`` further batches read and their copies started before a batch
    is handed out (``size`` 0: each batch is read and copied when it is
    asked for). On the CPU (``device`` None or a CPU device) the tensors
    are yielded as ``put`` made them."""
    put = to_tensors if put is None else put
    device = None if device is None else torch.device(device)
    if device is None or device.type == "cpu":
        def move(batch):
            return put(batch)

        def ready(out):
            return out
    elif device.type == "cuda":
        side = torch.cuda.Stream(device)

        def move(batch):
            host = {k: t.pin_memory() for k, t in put(batch).items()}
            with torch.cuda.stream(side):
                out = {k: t.to(device, non_blocking=True) for k, t in host.items()}
                done = torch.cuda.Event()
                done.record(side)
            return out, done

        def ready(item):
            out, done = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in out.values():
                t.record_stream(consumer)
            return out
    else:
        raise ValueError(f"no prefetching onto {device}")

    it = iter(iterator)
    queue = collections.deque()

    def fill(n: int) -> None:
        while len(queue) < n:
            try:
                queue.append(move(next(it)))
            except StopIteration:
                return

    fill(size)
    while True:
        fill(1)
        if not queue:
            return
        item = queue.popleft()
        fill(size)
        yield ready(item)
