"""Autograd for the kernel wrappers: the forward launches the kernel, the
backward recomputes through a plain PyTorch function on the saved inputs.

The port of the JAX package's rule for every Pallas kernel: each has a
``jax.custom_vjp`` whose forward saves the inputs and whose backward
differentiates the plain reference (``attention_pallas.py:92-106``,
``ffn_pallas.py:177-201`` and ``:253-274``, ``shuffle_pallas.py:156-177`` and
``:239-266``, ``pixelweight.py:177-197``, ``norm_pallas.py:98-114``,
``winograd_pallas.py:273-289`` and ``:339-361``). No backward kernel exists:
the gradients are exactly the plain path's. Launch counts are the forward's.

:func:`checkpoint` rematerializes a whole region (the JAX ``nn.remat`` and
``jax.checkpoint``): its activations are dropped after the forward and the
region runs again in the backward, kernels included (a kernel launched
inside it launches again then).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Sequence

import torch
import torch.utils.checkpoint

from ..utils import profiling


class _Recompute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return run(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            outs = ctx.plain(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad and g is not None]
        wanted = [t for t in inputs if t.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                  allow_unused=True) if pairs and wanted else [None] * len(wanted)
        it = iter(got)
        return (None, None, *[next(it) if t.requires_grad else None for t in inputs])


def recompute(run: Callable, plain: Callable, *inputs: torch.Tensor):
    """``run(*inputs)`` (the kernel launch), differentiable: the backward
    differentiates ``plain(*inputs)`` on the saved inputs. Where no gradient
    is recorded (inference), ``run`` is called directly: the
    ``autograd.Function`` costs host time at every one of the ~150 kernel
    calls of a CTUNet chunk."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in inputs)):
        return run(*inputs)
    return _Recompute.apply(run, plain, *inputs)


_LOCAL = threading.local()  # the backward's recompute runs on autograd's thread


def recomputing() -> bool:
    """True while a :func:`checkpoint` region runs again in the backward.
    State that a forward updates once (BatchNorm's running buffers) is left
    as it is then, as the JAX package keeps the forward's ``batch_stats``
    and drops the recompute's."""
    return getattr(_LOCAL, "depth", 0) > 0


@contextlib.contextmanager
def _replay(generators: Sequence[torch.Generator], states):
    """The recompute's context: each generator set back to its state at the
    region's entry, so that the region draws its forward's dropout masks
    again, and returned after to the state it had. Counted in
    ``checkpoint.recomputes``; under a profiler the span
    ``remat.recompute``, in the train step's ``step.backward``."""
    now = [g.get_state() for g in generators]
    for g, s in zip(generators, states):
        g.set_state(s)
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    checkpoint.recomputes += 1
    try:
        with profiling.span("remat.recompute", within="step.backward"):
            yield
    finally:
        _LOCAL.depth -= 1
        for g, s in zip(generators, now):
            g.set_state(s)


def checkpoint(fn: Callable, *args, generators: Sequence[torch.Generator] = ()):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept. Non-reentrant ``torch.utils.checkpoint``: the reentrant form breaks
    DDP with ``find_unused_parameters``. ``generators``: the explicit
    ``torch.Generator``s that ``fn`` draws from (its dropout sites'), which
    ``preserve_rng_state`` would not restore: their states at the entry are
    replayed in the recompute. Nothing here draws from the global RNG."""
    states = [g.get_state() for g in generators]
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), _replay(generators, states)))


checkpoint.recomputes = 0  # regions run again in a backward (kernels.reset_launch_counts)
