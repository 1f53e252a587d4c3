"""Useful FLOPs of a chunk: the port of ``tools/mfu_accounting.py``'s count.

"Useful" is the JAX tool's definition: 2 x the multiply-adds of every
matmul-class product of the plain reference math, nothing for norms,
softmax, activations, adds and copies. Here every kernel site takes its
plain version (``kernels.gates_off``), so K9's sites count as the direct 3^3
conv (not Winograd transforms), K6's k==s transposed conv as its product
over the input voxels, and window attention, the ViT attention, the FFNs
and the pixelweight projections as their matmuls. The forward runs on the
meta device: shapes only, no weights, no card.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from typing import Dict, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .. import kernels

aten = torch.ops.aten


def _op_flops(func, args, out) -> int:
    op = func.overloadpacket
    if op in (aten.mm, aten.bmm):
        return 2 * args[0].numel() * args[1].shape[-1]
    if op in (aten.addmm, aten.baddbmm):
        return 2 * args[1].numel() * args[2].shape[-1]
    if op is aten.convolution:
        x, w, transposed = args[0], args[1], args[6]
        # w is (Cout, Cin/groups, k...) and each output voxel meets every tap;
        # transposed, (Cin, Cout/groups, k...) and each input voxel does
        return 2 * (x if transposed else out).numel() * math.prod(w.shape[1:])
    if op in flop_registry:  # a matmul-class product this count does not know
        raise NotImplementedError(f"count_model_flops: no FLOP rule for {op}")
    return 0


class _Counter(TorchDispatchMode):
    def __init__(self, scopes):
        super().__init__()
        self.scopes = scopes
        self.flops: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        f = _op_flops(func, args, out)
        if f:
            self.flops[self.scopes[-1]] += f
        return out


@contextlib.contextmanager
def _module_scopes(model):
    """A stack whose top is the module path (``named_modules``) of the
    innermost module of ``model`` that is running; "" for the model's own
    forward."""
    names = {id(m): n for n, m in model.named_modules()}
    stack = [""]

    def enter(module, args):
        stack.append(names.get(id(module), stack[-1]))

    def leave(module, args, out):
        stack.pop()

    pre = torch.nn.modules.module.register_module_forward_pre_hook(enter)
    post = torch.nn.modules.module.register_module_forward_hook(leave)
    try:
        yield stack
    finally:
        pre.remove()
        post.remove()


def count_model_flops(model: torch.nn.Module, windows: int, res_only: bool = False,
                      roi: Sequence[int] = (96, 96, 96)) -> Dict[str, int]:
    """{module path: useful FLOPs} of one chunk of ``windows`` windows of
    ``roi`` through ``model`` (a TUNet, CTUNet or CUNet built on the meta
    device); "" is the model's own forward. ``res_only`` (CTUNet): what the
    ensemble's predictor runs; otherwise the full forward, every head."""
    if any(p.device.type != "meta" for p in model.parameters()):
        raise ValueError("count_model_flops: build the model on the meta device")
    x = torch.empty((windows, *roi, 1), dtype=model.dtype, device="meta")
    kw = {"res_only": True} if res_only else {}
    with _module_scopes(model) as scopes, kernels.gates_off(), torch.no_grad():
        with _Counter(scopes) as counter:
            model(x, **kw)
    return dict(counter.flops)


def by_component(flops: Dict[str, int]) -> Dict[str, int]:
    """FLOPs per top-level component (``vit_encoder``, ``convnet``, ...;
    ``(top)`` for the model's own forward), as the JAX tool's ``_component``
    groups them."""
    out: Dict[str, int] = defaultdict(int)
    for path, f in flops.items():
        out[path.split(".")[0] or "(top)"] += f
    return dict(out)
