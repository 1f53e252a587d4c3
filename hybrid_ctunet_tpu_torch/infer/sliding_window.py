"""Sliding-window inference with gaussian blending (sigma 0.125 x ROI, the
blend every model path uses) or a constant one. Port of the single-device
"loop" strategy of ``hybrid_ctunet_tpu/infer/sliding_window.py``, with its
functional ``sliding_window_inference``.

The window grid is MONAI ``dense_patch_slices`` (interval
``int(roi*(1-overlap))``, starts clamped to the volume edge), computed on the
host. Windows run through the predictor in full chunks of
``sw_batch_size`` and one smaller trailing chunk (no dummy windows). Each
output has its own fp32 canvas (X, Y, Z, C+1) whose last channel is the
count map; ops.scatter adds importance-weighted predictions in window order.
Finalize divides by the count and crops the centred padding:
``out = sum w*p / sum w`` (reference trainer_CTUNet.py:417-581).

Rank-sharded (``world`` > 1, the JAX engine's mesh path,
``infer/sliding_window.py:96-100,301-356``): chunk c runs on rank
``c mod world`` into that rank's own canvas, and one ``all_reduce`` (sum) of
each canvas, count lane included, precedes the division. Ranks take unequal
chunk counts where the chunks do not divide evenly: no window is padded or
run twice (the JAX engine pads the chunk axis to a multiple of the
devices, VERDICT r5 #5).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.importance import gaussian_importance_map
from ..ops.scatter import scatter_add_windows
from ..utils import profiling


def get_scan_interval(
    image_size: Sequence[int], roi_size: Sequence[int], overlap: float
) -> Tuple[int, ...]:
    """Reference trainer_CUNet.py:403-424 (``_get_scan_interval``)."""
    if not 0 <= overlap < 1:
        raise ValueError("overlap must be >= 0 and < 1.")
    interval = []
    for i, r in zip(image_size, roi_size):
        if r == i:
            interval.append(int(r))
        else:
            interval.append(max(int(r * (1 - overlap)), 1))
    return tuple(interval)


def dense_patch_starts(
    image_size: Sequence[int], patch_size: Sequence[int], scan_interval: Sequence[int]
) -> np.ndarray:
    """MONAI 0.7 ``dense_patch_slices`` start grid (C-order meshgrid, starts
    clamped so every window fits). Returns (N, ndim) int32."""
    ndim = len(image_size)
    scan_num = []
    for i in range(ndim):
        if scan_interval[i] == 0:
            scan_num.append(1)
            continue
        num = int(math.ceil(float(image_size[i]) / scan_interval[i]))
        scan_dim = next(
            (d for d in range(num) if d * scan_interval[i] + patch_size[i] >= image_size[i]), None
        )
        scan_num.append(scan_dim + 1 if scan_dim is not None else 1)

    axis_starts = []
    for dim in range(ndim):
        starts = []
        for idx in range(scan_num[dim]):
            s = idx * scan_interval[dim]
            s -= max(s + patch_size[dim] - image_size[dim], 0)
            starts.append(s)
        axis_starts.append(starts)
    mesh = np.meshgrid(*axis_starts, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1).astype(np.int32)


def _pad_amounts(image_size: Sequence[int], roi_size: Sequence[int]):
    """Centred pad to at least roi per axis (reference trainer_CTUNet.py:495-500)."""
    lo, hi = [], []
    for i, r in zip(image_size, roi_size):
        diff = max(r - i, 0)
        half = diff // 2
        lo.append(half)
        hi.append(diff - half)
    return lo, hi


class SlidingWindowEngine:
    """``engine(volume, *pred_args)`` -> tuple of blended maps.

    ``predictor(windows, *pred_args)`` takes (n, rx, ry, rz, C) fp32 windows
    and returns one tensor or a tuple of ``num_outputs`` tensors
    (n, rx, ry, rz, c_k). Call it under ``torch.inference_mode()``.
    ``mode``: the blend's importance map, ``"gaussian"`` (sigma
    ``sigma_scale`` x ROI) or ``"constant"`` (ones). ``num_outputs`` None:
    as many as the predictor returns (one process only).
    ``rank`` / ``world``: this process's share of the chunks, summed over
    the default process group (every rank calls the engine on the same
    volume). Under a profiler each chunk's predictor call is the span
    ``engine.predict`` (unit: the call's number, ``self.calls`` before it;
    owner ``self.owner``).
    """

    def __init__(self, predictor: Callable, roi_size: Tuple[int, int, int], *,
                 sw_batch_size: int = 4, overlap: float = 0.5, mode: str = "gaussian",
                 sigma_scale: float = 0.125, num_outputs: Optional[int] = 1, rank: int = 0,
                 world: int = 1):
        if mode not in ("gaussian", "constant"):
            raise ValueError(f"unknown blend mode {mode!r}")
        if num_outputs is None and world > 1:
            raise ValueError("a rank-sharded engine needs num_outputs")
        self.predictor = predictor
        self.roi_size = tuple(int(r) for r in roi_size)
        self.sw_batch_size = int(sw_batch_size)
        self.overlap = float(overlap)
        self.mode, self.sigma_scale = mode, sigma_scale
        self.num_outputs = num_outputs
        self.rank, self.world = int(rank), int(world)
        self.calls = 0
        self.owner = profiling.new_owner()

    def importance(self) -> np.ndarray:
        """The blend's weight of each window voxel, (rx, ry, rz) fp32."""
        if self.mode == "gaussian":
            return gaussian_importance_map(self.roi_size, self.sigma_scale)
        return np.ones(self.roi_size, np.float32)

    def plan(self, image_size: Sequence[int]):
        """Pad amounts, padded size and window starts for a volume."""
        lo, hi = _pad_amounts(image_size, self.roi_size)
        padded = tuple(i + l + h for i, l, h in zip(image_size, lo, hi))
        interval = get_scan_interval(padded, self.roi_size, self.overlap)
        return lo, hi, padded, dense_patch_starts(padded, self.roi_size, interval)

    def __call__(self, volume: torch.Tensor, *pred_args) -> Tuple[torch.Tensor, ...]:
        """volume: (1, X, Y, Z, C) channels-last. Returns the blended maps,
        each (1, X, Y, Z, c) fp32, cropped to the input size."""
        if volume.ndim != 5 or volume.shape[0] != 1:
            raise ValueError(f"expected a (1, X, Y, Z, C) volume, got {tuple(volume.shape)}")
        image_size = tuple(volume.shape[1:4])
        lo, hi, padded_size, starts = self.plan(image_size)
        pad = []
        for l, h in zip(reversed(lo), reversed(hi)):
            pad += [l, h]
        padded = F.pad(volume.float(), [0, 0, *pad]) if any(lo + hi) else volume.float()
        importance = torch.tensor(self.importance(), device=volume.device)
        rx, ry, rz = self.roi_size
        sw = self.sw_batch_size
        accs = None
        for c0 in range(sw * self.rank, len(starts), sw * self.world):
            s = starts[c0 : c0 + sw]
            wins = torch.stack([
                padded[0, x0 : x0 + rx, y0 : y0 + ry, z0 : z0 + rz] for x0, y0, z0 in s.tolist()
            ])
            with profiling.span("engine.predict", self.calls, self.owner):
                preds = self.predictor(wins, *pred_args)
            preds = preds if isinstance(preds, (tuple, list)) else (preds,)
            if self.num_outputs is not None and len(preds) != self.num_outputs:
                raise ValueError(f"predictor gave {len(preds)} outputs, expected {self.num_outputs}")
            if accs is None:
                accs = [
                    torch.zeros((*padded_size, p.shape[-1] + 1), dtype=torch.float32,
                                device=volume.device)
                    for p in preds
                ]
            for acc, p in zip(accs, preds):
                scatter_add_windows(acc, p.contiguous(), importance, s)
        self.calls += 1
        if self.world > 1:
            accs = self._reduce(accs, padded_size, volume.device)
        crop = tuple(slice(l, l + i) for l, i in zip(lo, image_size))
        outs = []
        for acc in accs:
            c = acc.shape[-1] - 1
            out = acc[..., :c] / acc[..., c:]
            outs.append(out[crop[0], crop[1], crop[2]][None])
        return tuple(outs)

    def _reduce(self, accs, padded_size, device):
        """Sum the ranks' canvases. A rank that ran no chunk learns the
        canvases' channel counts from the others first."""
        import torch.distributed as dist

        lanes = torch.zeros(self.num_outputs, dtype=torch.int64, device=device)
        if accs is not None:
            lanes = torch.tensor([a.shape[-1] for a in accs], dtype=torch.int64, device=device)
        dist.all_reduce(lanes, op=dist.ReduceOp.MAX)
        if accs is None:
            accs = [torch.zeros((*padded_size, int(k)), dtype=torch.float32, device=device)
                    for k in lanes.tolist()]
        for acc in accs:
            dist.all_reduce(acc)
        return accs


def sliding_window_inference(inputs: torch.Tensor, roi_size: Tuple[int, int, int],
                             sw_batch_size: int, predictor: Callable, *,
                             overlap: float = 0.25, mode: str = "constant",
                             sigma_scale: float = 0.125):
    """One-shot functional form with the reference's signature and defaults
    (trainer_CUNet.py:268, trainer_CTUNet.py:417; the JAX
    ``infer/sliding_window.py:586``): one blended map, or a tuple of them
    when the predictor returns several."""
    engine = SlidingWindowEngine(predictor, tuple(roi_size), sw_batch_size=sw_batch_size,
                                 overlap=overlap, mode=mode, sigma_scale=sigma_scale,
                                 num_outputs=None)
    outs = engine(inputs)
    return outs if len(outs) > 1 else outs[0]
