"""Autograd for the kernel wrappers: the forward launches the kernel, the
backward recomputes through a plain PyTorch function on the saved inputs.

The port of the JAX package's rule for every Pallas kernel: each has a
``jax.custom_vjp`` whose forward saves the inputs and whose backward
differentiates the plain reference (``attention_pallas.py:92-106``,
``ffn_pallas.py:177-201`` and ``:253-274``, ``shuffle_pallas.py:156-177`` and
``:239-266``, ``pixelweight.py:177-197``, ``norm_pallas.py:98-114``,
``winograd_pallas.py:273-289`` and ``:339-361``). No backward kernel exists:
the gradients are exactly the plain path's. Launch counts are the forward's.
"""
from __future__ import annotations

from typing import Callable

import torch


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
