"""Gradients of the kernels: the kernel forward, autograd of its plain version
backward.

Counterpart of the JAX package's ``custom_vjp`` rules on its Pallas kernels
(pallas_conv.py:180-207, pallas_ista2.py:346-407, pallas_corr.py:344-372,
pallas_aug.py:84-113, pallas_norm.py:102-130 and :206-223): each backward there is
``jax.vjp`` of the plain XLA function, so no backward is a kernel. Here
``KernelFunction`` runs a given forward (the CUDA kernel's wrapper, or on the
CPU in a test the plain version itself), saves the inputs, and in backward
recomputes the plain version from them under ``enable_grad`` and returns
``torch.autograd.grad`` of it to every input that wants one.

A wrapper calls ``apply_kernel``: where grad mode is off or no input requires
a gradient, the forward runs directly and nothing is saved, so serving
launches exactly as before.

While a profiler records, each backward is the span ``backward.<kernel>``
(``utils.profiling``), which ``profile_step --train`` reads.
"""
from __future__ import annotations

import torch

from ..utils.profiling import annotate


def wants_grad(*tensors) -> bool:
    """Grad mode is on and some input requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or in f64 where it is f64: the plain versions compute
    in f32 and keep f64 for ``gradcheck``."""
    return t if t.dtype == torch.float64 else t.float()


def refuse_grad(name: str, *tensors) -> None:
    """A function the JAX package cannot differentiate either (K6, whose
    Pallas call has no ``custom_vjp``; K4s's statistics on their own): raise
    where a gradient is wanted rather than return an output cut out of the
    graph."""
    if wants_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward (nor has it in the JAX package); call it under "
            "torch.no_grad() or train on a route that has one")


class KernelFunction(torch.autograd.Function):
    """``apply(name, forward, plain, *inputs)``: ``forward(*inputs)`` in
    forward, the vector-Jacobian product of ``plain(*inputs)`` in backward.
    Inputs may be None (an absent bias or gate); ``forward`` and ``plain``
    return a tensor or a tuple of tensors, the same for both. ``name`` (the
    kernel's, e.g. "K5") stays on the node as ``kernel`` for a profile to read."""

    @staticmethod
    def forward(ctx, name, forward, plain, *inputs):
        ctx.kernel = name
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        from . import bands
        with annotate(f"backward.{ctx.kernel}"):
            inputs = ctx.saved_tensors       # a remat recompute runs here, on the step's band
            wanted = ctx.needs_input_grad[3:]
            # the plain version runs on the inputs as they were given: a row
            # band's kernels take a band already widened, with no exchange
            with torch.enable_grad(), bands.local():
                xs = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(inputs, wanted)]
                outs = ctx.plain(*xs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad and g is not None]
            leaves = [x for x, need in zip(xs, wanted) if need]
            got = iter(torch.autograd.grad([o for o, _ in pairs], leaves,
                                           [g for _, g in pairs], allow_unused=True)
                       if pairs and leaves else [None] * len(leaves))
            return (None, None, None, *[next(got) if need else None for need in wanted])


def apply_kernel(name: str, forward, plain, *inputs):
    """``forward(*inputs)``, differentiable as ``plain`` where a gradient is
    wanted (``KernelFunction``); a direct call otherwise."""
    if wants_grad(*inputs):
        return KernelFunction.apply(name, forward, plain, *inputs)
    return forward(*inputs)
