"""TUNet sliding-window inference benchmark on one CUDA device.

The port's counterpart of the TUNet half of the repository's ``bench.py``
(the independent TUNet of the Hybrid-CTUNet ensemble, ``test_C_TUNet.py
--model_name tunet``): full-width TUNet (pf 8, 109,904,124 params, random
weights from ``--seed``) in bf16 compute with fp32 params, one
256 x 256 x 128 volume, ROI 96^3, overlap 0.7 (147 windows), gaussian
blending, ``sw_batch_size`` 4, argmax mask at the end.

    python -m hybrid_ctunet_tpu_torch.cli.bench [--seed 0] [--reps 3]

Prints one JSON line: {"metric": "tunet_volumes/min", "value": ..., ...}.
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
from ..models import TUNet
from ..utils.params import random_init_

VOLUME_SHAPE = (256, 256, 128)
ROI = (96, 96, 96)
OVERLAP = 0.7
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


def make_engine(model: TUNet, roi=ROI, overlap: float = OVERLAP,
                sw: int = SW_BATCH) -> SlidingWindowEngine:
    """The eval CLI's single-output engine: the predictor returns the
    vit_logits head (cli/test_main.py ``_single_engine``)."""
    def predictor(x):
        return model(x.to(model.dtype))[0]

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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: this benchmark needs a CUDA device", file=sys.stderr)
        return 1
    set_precision_flags()
    device = torch.device("cuda", 0)
    model = build_tunet(args.seed, device)
    engine = make_engine(model)
    stats = time_volumes(engine, make_volume(args.seed, device=device), args.reps)
    print(json.dumps({
        "metric": "tunet_volumes/min",
        "value": stats["volumes_per_min"],
        "unit": "vol/min",
        "seconds_per_volume": stats["seconds_per_volume"],
        "peak_mem_bytes": stats["peak_mem_bytes"],
        "device": device_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
