"""Hybrid-CTUNet ensemble sliding-window inference benchmark on one CUDA
device.

The port's counterpart of the repository's ``bench.py`` (the ensemble of
``test_CTUNet_final.py``, ``cli/test_main.py test_final``): full-width CTUNet
(ResNet-101, pf 8, 174,109,542 params) at overlap 0.5 (50 windows), its res
head only, and the independent TUNet (pf 8, 109,904,124 params) at overlap
0.7 (147 windows); random weights from ``--seed``, bf16 compute with fp32
params, one 256 x 256 x 128 volume, ROI 96^3, gaussian blending, windows
in chunks of ``--sw_ct`` / ``--sw_tu`` (the JAX bench's ``BENCH_SW_CT`` /
``BENCH_SW_TU``; 4 each by default); then the fp32 softmax of each map,
their mean, argmax.

    python -m hybrid_ctunet_tpu_torch.cli.bench [--seed 0] [--reps 3] [--sw_ct 4] [--sw_tu 4] [--profile]

Prints one JSON line: {"metric": "hybrid_volumes/min", "value": ..., ...}
with the seconds per volume of each half, the peak memory, the useful
TFLOP of a volume (``utils/flops.py``: the CTUNet res head's count a window
x 50 + the TUNet's x 147) and ``mfu``, those FLOPs over the mean seconds a
volume at the H100's dense bf16 peak; each half's chunks and mean ms a
chunk go to stderr. ``--profile`` first traces one warm volume of each
half with ``torch.profiler`` and prints their device time by kernel to
stderr. The TUNet-only slice is the same
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

from .. import kernels
from ..infer.sliding_window import SlidingWindowEngine
from ..models import CTUNet, TUNet
from ..models.layers import remat_blocks
from ..utils import flops
from ..utils.params import random_init_
from ..utils.profiling import StepTimer, trace

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


def _init(model, seed: int):
    """Random weights from ``seed``; a model on the meta device (shapes
    only, for ``utils/flops.py``) has none to draw."""
    if next(model.parameters()).device.type != "meta":
        random_init_(model, seed)
    return model.eval()


def build_tunet(seed: int, device, dtype=torch.bfloat16, **overrides) -> TUNet:
    """TUNet with random weights from ``seed`` (pf 8, 14 classes, full width
    unless ``overrides`` say otherwise)."""
    cfg = dict(out_channels=OUT_CHANNELS, patch_frame=8)
    cfg.update(overrides)
    return _init(TUNet(dtype=dtype, device=device, **cfg), seed)


def build_ctunet(seed: int, device, dtype=torch.bfloat16, **overrides) -> CTUNet:
    """CTUNet with random weights from ``seed`` (ResNet-101, pf 8, 14
    classes, full width unless ``overrides`` say otherwise)."""
    cfg = dict(out_channels=OUT_CHANNELS, model_depth=101, patch_frame=8)
    cfg.update(overrides)
    return _init(CTUNet(dtype=dtype, device=device, **cfg), seed)


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
    volumes (``StepTimer``: host clock, fenced on the result)."""
    warm, timer = StepTimer(), StepTimer()
    if warmup:
        warm.tic()
        warm.toc(segment(engine, volume))
    torch.cuda.reset_peak_memory_stats()
    for _ in range(reps):
        timer.tic()
        timer.toc(segment(engine, volume))
    return {
        "warmup_s": warm.mean_s,
        "seconds_per_volume": timer.times,
        "mean_s": timer.mean_s,
        "volumes_per_min": timer.per_min(skip_first=0),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def time_hybrid(ct_engine: SlidingWindowEngine, tu_engine: SlidingWindowEngine,
                volume: torch.Tensor, reps: int, warmup: bool = True) -> Dict:
    """``time_volumes`` for the ensemble: per volume the seconds of the
    CTUNet half, the TUNet half and the whole (ensemble included), each
    fenced on its result."""
    warm = StepTimer()
    if warmup:
        warm.tic()
        warm.toc(segment_hybrid(ct_engine, tu_engine, volume))
    torch.cuda.reset_peak_memory_stats()
    ct, tu, whole = StepTimer(), StepTimer(), StepTimer()
    for _ in range(reps):
        with torch.inference_mode():
            whole.tic()
            ct.tic()
            (res_map,) = ct_engine(volume)
            ct.toc(res_map)
            tu.tic()
            (tu_map,) = tu_engine(volume)
            tu.toc(tu_map)
            whole.toc(ensemble(res_map, tu_map))
        del res_map, tu_map
    return {
        "warmup_s": warm.mean_s,
        "seconds_per_volume": whole.times,
        "ctunet_seconds_per_volume": ct.times,
        "tunet_seconds_per_volume": tu.times,
        "mean_s": whole.mean_s,
        "volumes_per_min": whole.per_min(skip_first=0),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def profile_half(engine: SlidingWindowEngine, volume: torch.Tensor) -> Dict:
    """One warm volume of ``engine`` under ``torch.profiler``."""
    return profile_device(lambda: segment(engine, volume))


def profile_device(fn) -> Dict:
    """``fn()`` once to warm up, then once under ``utils.profiling.trace``:
    wall seconds, summed device kernel time, the 30 kernels with the most
    device time, and the traced records of each of the port's kernels,
    which must equal its launches in the traced call
    (``kernels.reconcile`` raises otherwise: no partial table)."""
    fn()
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with trace() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in kernels.launch_counts().items()}
    traced = kernels.traced_counts(ev.name for ev in prof.events() if _on_device(ev))
    kernels.reconcile(traced, launched)
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0 and _on_device(ev):
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    kernel_ms = sum(r[1] for r in rows)
    return {"wall_s": wall, "kernel_ms": kernel_ms, "busy_share": kernel_ms / 1e3 / wall,
            "kernel_records": traced,
            "top": [{"name": n[:120], "ms": ms, "count": c} for n, ms, c in rows[:30]]}


def _on_device(ev) -> bool:
    return getattr(ev, "device_type", None) is not None and "CUDA" in str(ev.device_type)


def useful_flops_per_volume(ct_engine: SlidingWindowEngine,
                            tu_engine: SlidingWindowEngine) -> int:
    """Useful FLOPs of one volume (``utils/flops.py``, meta-device twins of
    the bench's models): the CTUNet res head's a window x its windows plus
    the TUNet's a window x its windows."""
    ct = flops.count_model_flops(build_ctunet(0, "meta"), 1, res_only=True, roi=ct_engine.roi_size)
    tu = flops.count_model_flops(build_tunet(0, "meta"), 1, roi=tu_engine.roi_size)
    return (sum(ct.values()) * len(ct_engine.plan(VOLUME_SHAPE)[3])
            + sum(tu.values()) * len(tu_engine.plan(VOLUME_SHAPE)[3]))


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
    ap.add_argument("--sw_ct", type=int, default=SW_BATCH, help="CTUNet windows a chunk")
    ap.add_argument("--sw_tu", type=int, default=SW_BATCH, help="TUNet windows a chunk")
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm volume of each half first; kernel tables to stderr")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: this benchmark needs a CUDA device", file=sys.stderr)
        return 1
    with remat_blocks(False):  # an inference-only process (the JAX bench.py:49)
        return _bench(args)


def _bench(args) -> int:
    set_precision_flags()
    device = torch.device("cuda", 0)
    ct_engine = make_ctunet_engine(build_ctunet(args.seed, device), sw=args.sw_ct)
    tu_engine = make_engine(build_tunet(args.seed, device), sw=args.sw_tu)
    volume = make_volume(args.seed, device=device)
    if args.profile:
        print(json.dumps({"profile_ctunet_half": profile_half(ct_engine, volume),
                          "profile_tunet_half": profile_half(tu_engine, volume)}),
              file=sys.stderr)
    stats = time_hybrid(ct_engine, tu_engine, volume, args.reps)
    for name, engine, key in (("CTUNet", ct_engine, "ctunet_seconds_per_volume"),
                              ("TUNet", tu_engine, "tunet_seconds_per_volume")):
        windows = len(engine.plan(VOLUME_SHAPE)[3])
        chunks = -(-windows // engine.sw_batch_size)
        print(f"{name}: {windows} windows in {chunks} chunks of <= {engine.sw_batch_size}; "
              f"{1e3 * sum(stats[key]) / len(stats[key]) / chunks!r} ms a chunk", file=sys.stderr)
    useful = useful_flops_per_volume(ct_engine, tu_engine)
    print(json.dumps({
        "metric": "hybrid_volumes/min",
        "value": stats["volumes_per_min"],
        "unit": "vol/min",
        "seconds_per_volume": stats["seconds_per_volume"],
        "ctunet_seconds_per_volume": stats["ctunet_seconds_per_volume"],
        "tunet_seconds_per_volume": stats["tunet_seconds_per_volume"],
        "peak_mem_bytes": stats["peak_mem_bytes"],
        "sw_ct": args.sw_ct,
        "sw_tu": args.sw_tu,
        "useful_tflop_per_volume": useful / 1e12,
        "mfu": useful / (stats["mean_s"] * flops.H100_BF16_FLOP_PER_S),
        "device": device_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
