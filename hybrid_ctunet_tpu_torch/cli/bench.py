"""Hybrid-CTUNet ensemble sliding-window inference benchmark on one CUDA
device.

The port's counterpart of the repository's ``bench.py`` (the ensemble of
``test_CTUNet_final.py``, ``cli/test_main.py test_final``): full-width CTUNet
(ResNet-101, pf 8, 174,109,542 params) at overlap 0.5 (50 windows), its res
head only, and the independent TUNet (pf 8, 109,904,124 params) at overlap
0.7 (147 windows); random weights from ``--seed``, bf16 compute with fp32
params, one 256 x 256 x 128 volume, ROI 96^3, gaussian blending,
``sw_batch_size`` 4; then the fp32 softmax of each map, their mean, argmax.

    python -m hybrid_ctunet_tpu_torch.cli.bench [--seed 0] [--reps 3] [--profile]

Prints one JSON line: {"metric": "hybrid_volumes/min", "value": ..., ...}
with the seconds per volume of each half and the peak memory. ``--profile``
first traces one warm volume of each half with ``torch.profiler`` and
prints their device time by kernel to stderr. The TUNet-only slice is the same
functions (``build_tunet``, ``make_engine``, ``segment``, ``time_volumes``).
It needs a CUDA device and fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict, Tuple

import torch

from ..infer.sliding_window import SlidingWindowEngine
from ..models import CTUNet, TUNet
from ..utils.params import random_init_

VOLUME_SHAPE = (256, 256, 128)
ROI = (96, 96, 96)
OVERLAP = 0.7  # TUNet
CT_OVERLAP = 0.5  # CTUNet
SW_BATCH = 4
OUT_CHANNELS = 14


def set_precision_flags() -> None:
    """fp32 matmuls and convs in full fp32, bf16 GEMMs without reduced-
    precision reductions: the plain versions then sum as the JAX oracle does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def build_tunet(seed: int, device, dtype=torch.bfloat16, **overrides) -> TUNet:
    """TUNet with random weights from ``seed`` (pf 8, 14 classes, full width
    unless ``overrides`` say otherwise)."""
    cfg = dict(out_channels=OUT_CHANNELS, patch_frame=8)
    cfg.update(overrides)
    model = TUNet(dtype=dtype, device=device, **cfg)
    random_init_(model, seed)
    return model.eval()


def build_ctunet(seed: int, device, dtype=torch.bfloat16, **overrides) -> CTUNet:
    """CTUNet with random weights from ``seed`` (ResNet-101, pf 8, 14
    classes, full width unless ``overrides`` say otherwise)."""
    cfg = dict(out_channels=OUT_CHANNELS, model_depth=101, patch_frame=8)
    cfg.update(overrides)
    model = CTUNet(dtype=dtype, device=device, **cfg)
    random_init_(model, seed)
    return model.eval()


def make_engine(model: TUNet, roi=ROI, overlap: float = OVERLAP,
                sw: int = SW_BATCH) -> SlidingWindowEngine:
    """The eval CLI's single-output engine: the predictor returns the
    vit_logits head (cli/test_main.py ``_single_engine``)."""
    def predictor(x):
        return model(x.to(model.dtype))[0]

    return SlidingWindowEngine(predictor, roi, sw_batch_size=sw, overlap=overlap)


def make_ctunet_engine(model: CTUNet, roi=ROI, overlap: float = CT_OVERLAP,
                       sw: int = SW_BATCH) -> SlidingWindowEngine:
    """The ensemble's CTUNet engine: the predictor returns the res head alone
    (cli/test_main.py ``test_final``, ``_ct_res_only``)."""
    def predictor(x):
        return model(x.to(model.dtype), res_only=True)

    return SlidingWindowEngine(predictor, roi, sw_batch_size=sw, overlap=overlap)


def make_volume(seed: int, shape=VOLUME_SHAPE, device="cuda") -> torch.Tensor:
    """(1, X, Y, Z, 1) fp32 standard-normal volume from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    return torch.randn((1, *shape, 1), generator=gen, device=device)


def segment(engine: SlidingWindowEngine, volume: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blended logits (1, X, Y, Z, C) fp32 and the argmax mask (1, X, Y, Z)."""
    with torch.inference_mode():
        (logits,) = engine(volume)
        mask = logits.argmax(-1).to(torch.int32)
    return logits, mask


def ensemble(res_map: torch.Tensor, tu_map: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ensemble of ``bench.py``/test_CTUNet_final.py: fp32 softmax of each
    blended map, their mean, argmax. Returns (probabilities, int32 mask)."""
    prob = (torch.softmax(res_map.float(), -1) + torch.softmax(tu_map.float(), -1)) / 2.0
    return prob, prob.argmax(-1).to(torch.int32)


def segment_hybrid(ct_engine: SlidingWindowEngine, tu_engine: SlidingWindowEngine,
                   volume: torch.Tensor):
    """(res map, TUNet map, ensemble probabilities, mask) of one volume."""
    with torch.inference_mode():
        (res_map,) = ct_engine(volume)
        (tu_map,) = tu_engine(volume)
        prob, mask = ensemble(res_map, tu_map)
    return res_map, tu_map, prob, mask


def time_volumes(engine: SlidingWindowEngine, volume: torch.Tensor, reps: int,
                 warmup: bool = True) -> Dict:
    """One warm-up volume (unless the caller ran one), then ``reps`` timed
    volumes (host clock around work that ends in ``torch.cuda.synchronize``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if warmup:
        segment(engine, volume)
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, mask = segment(engine, volume)
        mask[0, 0, 0, 0].item()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mean = sum(times) / len(times)
    return {
        "warmup_s": warmup_s,
        "seconds_per_volume": times,
        "mean_s": mean,
        "volumes_per_min": 60.0 / mean,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def time_hybrid(ct_engine: SlidingWindowEngine, tu_engine: SlidingWindowEngine,
                volume: torch.Tensor, reps: int, warmup: bool = True) -> Dict:
    """``time_volumes`` for the ensemble: per volume the seconds of the
    CTUNet half, the TUNet half and the whole (ensemble included), each
    boundary synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if warmup:
        segment_hybrid(ct_engine, tu_engine, volume)
        torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ct_s, tu_s, total = [], [], []
    for _ in range(reps):
        with torch.inference_mode():
            t0 = time.perf_counter()
            (res_map,) = ct_engine(volume)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (tu_map,) = tu_engine(volume)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            _, mask = ensemble(res_map, tu_map)
            mask[0, 0, 0, 0].item()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
        ct_s.append(t1 - t0)
        tu_s.append(t2 - t1)
        total.append(t3 - t0)
        del res_map, tu_map, mask
    mean = sum(total) / len(total)
    return {
        "warmup_s": warmup_s,
        "seconds_per_volume": total,
        "ctunet_seconds_per_volume": ct_s,
        "tunet_seconds_per_volume": tu_s,
        "mean_s": mean,
        "volumes_per_min": 60.0 / mean,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def profile_half(engine: SlidingWindowEngine, volume: torch.Tensor) -> Dict:
    """One warm volume of ``engine`` under ``torch.profiler``."""
    return profile_device(lambda: segment(engine, volume))


def profile_device(fn) -> Dict:
    """``fn()`` once to warm up, then once under ``torch.profiler``: wall
    seconds, summed device kernel time, and the 30 kernels with the most
    device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(ev, "device_type", None) is not None \
                and "CUDA" in str(ev.device_type):
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    kernel_ms = sum(r[1] for r in rows)
    return {"wall_s": wall, "kernel_ms": kernel_ms, "busy_share": kernel_ms / 1e3 / wall,
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:30]]}


def device_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm volume of each half first; kernel tables to stderr")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: this benchmark needs a CUDA device", file=sys.stderr)
        return 1
    set_precision_flags()
    device = torch.device("cuda", 0)
    ct_engine = make_ctunet_engine(build_ctunet(args.seed, device))
    tu_engine = make_engine(build_tunet(args.seed, device))
    volume = make_volume(args.seed, device=device)
    if args.profile:
        print(json.dumps({"profile_ctunet_half": profile_half(ct_engine, volume),
                          "profile_tunet_half": profile_half(tu_engine, volume)}),
              file=sys.stderr)
    stats = time_hybrid(ct_engine, tu_engine, volume, args.reps)
    print(json.dumps({
        "metric": "hybrid_volumes/min",
        "value": stats["volumes_per_min"],
        "unit": "vol/min",
        "seconds_per_volume": stats["seconds_per_volume"],
        "ctunet_seconds_per_volume": stats["ctunet_seconds_per_volume"],
        "tunet_seconds_per_volume": stats["tunet_seconds_per_volume"],
        "peak_mem_bytes": stats["peak_mem_bytes"],
        "device": device_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
