"""The yardstick's arithmetic: useful FLOPs of the reference models, the
bytes of the InstanceNorm sites, and the H100's published peaks.

Useful FLOPs are 2 x the multiply-adds of every matrix-class product (convs,
transposed convs, matmuls) of the plain reference forward, nothing for
norms, softmax, activations, adds and copies: counted on the meta device,
so shapes only. The K8 bound reads each InstanceNorm input once and writes
its output once, in the compute dtype, at the card's memory rate.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import models

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12

_aten = torch.ops.aten


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        op = func.overloadpacket
        if op in (_aten.mm, _aten.bmm):
            self.flops += 2 * args[0].numel() * args[1].shape[-1]
        elif op in (_aten.addmm, _aten.baddbmm):
            self.flops += 2 * args[1].numel() * args[2].shape[-1]
        elif op is _aten.convolution:
            x, w, transposed = args[0], args[1], args[6]
            self.flops += 2 * (x if transposed else out).numel() * math.prod(w.shape[1:])
        return out


def forward_cost(kind: str, sizes: dict, windows: int, res_only: bool):
    """(useful FLOPs, InstanceNorm site shapes) of one forward of ``windows``
    windows through the reference model ``kind`` at ``sizes``."""
    ar = models.Arith()
    model = models.build(kind, sizes, ar, device="meta")
    x = torch.empty((windows, *sizes["roi"], sizes["in_channels"]), device="meta")
    ar.recording = True
    with torch.no_grad(), _Count() as count:
        model(x, res_only=True) if res_only else model(x)
    return count.flops, list(ar.norm_sites)


def norm_bytes(sites: Sequence[Sequence[int]], item_bytes: int) -> int:
    """Each site's input read once and its output written once."""
    return sum(2 * math.prod(s) * item_bytes for s in sites)
