#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Device: ``nvidia-smi`` name and power limit, torch and CUDA versions, the
   TF32 / reduced-precision flags (set off, and printed).
2. Build every kernel of the path from ``hybrid_ctunet_tpu_torch/csrc`` with
   nvcc (seconds printed).
3. Each kernel against its plain PyTorch version at the main path's shapes
   (K1 scatter must be bit-exact; the bf16 kernels must meet the stated
   tolerance), with CUDA-event times of both (median of several runs).
4. The slice: full-width TUNet (109,904,124 params, random weights from a
   seed, bf16) through ``cli/bench.py``'s functions — sliding-window
   inference over one 256x256x128 volume at overlap 0.7 (147 windows,
   sw_batch 4), with every kernel launch counted; then 2 timed volumes.
   One 4-window batch of the model is also run with the kernels and with
   their plain versions, and the two outputs compared.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with an error and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# bf16 kernels against their plain versions: summation order inside the
# matmuls differs, so a value may round one bf16 ulp (2^-8 relative) apart at
# any rounding point, and a flipped intermediate moves the next product.
BF16_MAX_ABS_FRACTION = 2.0 ** -5  # max |kernel - plain| <= this * max |plain|
BF16_REL_L2 = 1e-2
# the whole bf16 model with kernels against the same model on plain
# versions: the per-op differences above, carried through ~40 layers
MODEL_REL_L2 = 5e-2
SEED = 0


def log(*a):
    print(*a, flush=True)


def cuda_time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def errors(got, want):
    d = (got.float() - want.float())
    max_abs = d.abs().max().item()
    rel_l2 = (d.norm() / want.float().norm().clamp_min(1e-30)).item()
    return max_abs, rel_l2


def check_bf16(name, got, want):
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    max_abs, rel_l2 = errors(got, want)
    bound = BF16_MAX_ABS_FRACTION * want.float().abs().max().item()
    log(f"  {name}: max_abs_err {max_abs!r} (bound {bound!r}) rel_l2 {rel_l2!r} (bound {BF16_REL_L2})")
    if not (max_abs <= bound and rel_l2 <= BF16_REL_L2):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel: (max_abs_err, ms per chunk, plain ms per chunk)}."""
    import numpy as np
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine
    from hybrid_ctunet_tpu_torch.ops import attention, ffn, scatter, shuffle
    from hybrid_ctunet_tpu_torch.ops.importance import gaussian_importance_map

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32, std=1.0):
        return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)

    results = {}

    # K1: one chunk of 4 windows at unaligned starts (overlap 0.7) into the
    # 256x256x128x(14+1) canvas; predictions bf16 as the model emits them
    planner = SlidingWindowEngine(None, bench.ROI, overlap=bench.OVERLAP)
    _, _, _, starts = planner.plan(bench.VOLUME_SHAPE)
    chunk = starts[4:8]
    imp = torch.tensor(gaussian_importance_map(bench.ROI), device=device)
    pred = randn(4, *bench.ROI, bench.OUT_CHANNELS, dtype=bf)
    acc0 = randn(*bench.VOLUME_SHAPE, bench.OUT_CHANNELS + 1)
    got = scatter.scatter_add_windows(acc0.clone(), pred, imp, chunk)
    want = scatter.reference_scatter_add_windows(acc0.clone(), pred, imp, chunk)
    torch.cuda.synchronize()
    exact = torch.equal(got, want)
    max_abs = (got - want).abs().max().item()
    log(f"  scatter_add_windows starts {chunk.tolist()}: bit-exact {exact} max_abs_err {max_abs!r}")
    if not exact:
        raise AssertionError("scatter_add_windows is not bit-exact with its plain version")
    acc = acc0.clone()
    ms = cuda_time_ms(lambda: scatter.scatter_add_windows(acc, pred, imp, chunk))
    plain = cuda_time_ms(lambda: scatter.reference_scatter_add_windows(acc, pred, imp, chunk))
    log(f"  scatter_add_windows: {ms!r} ms, plain {plain!r} ms")
    results["scatter_add_windows"] = (max_abs, ms, plain)
    del acc, acc0, got, want, pred

    # K2: window attention at pyramid stages 0-2 (block and grid calls share
    # shapes: 2 calls per stage per chunk)
    worst, ms_sum, plain_sum = 0.0, 0.0, 0.0
    for stage, (nwin, C) in enumerate(((8, 768), (64, 512), (512, 256))):
        heads, T = C // 32, 216
        qkv = randn(nwin, T, 3 * C, dtype=bf)
        q = qkv[..., :C] * 32 ** -0.5
        k, v = qkv[..., C : 2 * C], qkv[..., 2 * C :]
        bias = randn(heads, T, T)
        got = attention.window_attention(q, k, v, bias, bf)
        want = attention.reference_window_attention(q, k, v, bias, bf)
        worst = max(worst, check_bf16(f"window_attention stage {stage} ({nwin}x{T}x{C})", got, want))
        ms = cuda_time_ms(lambda: attention.window_attention(q, k, v, bias, bf))
        plain = cuda_time_ms(lambda: attention.reference_window_attention(q, k, v, bias, bf))
        log(f"  window_attention stage {stage}: {ms!r} ms, plain {plain!r} ms")
        ms_sum, plain_sum = ms_sum + 2 * ms, plain_sum + 2 * plain
    results["window_attention"] = (worst, ms_sum, plain_sum)

    def ffn_params(c, h):
        return (1.0 + randn(c, std=0.1), randn(c, std=0.1), randn(h, c, std=c ** -0.5),
                randn(h, std=0.1), randn(c, h, std=h ** -0.5), randn(c, std=0.1))

    # K3: stage-2 FFN, residual, 2 calls per chunk
    x = randn(4, 24, 24, 48, 256, dtype=bf)
    p = ffn_params(256, 1024)
    got = ffn.ffn(x, *p, bf, residual=True)
    want = x + ffn.reference_ffn(x, *p, bf)
    err = check_bf16("ffn stage 2 (110592x256, hidden 1024)", got, want)
    ms = cuda_time_ms(lambda: ffn.ffn(x, *p, bf, residual=True))
    plain = cuda_time_ms(lambda: x + ffn.reference_ffn(x, *p, bf))
    log(f"  ffn: {ms!r} ms, plain {plain!r} ms")
    results["ffn"] = (err, 2 * ms, 2 * plain)

    # K4: stage-3 FFN pair, 1 call per chunk
    x = randn(4, 48, 48, 96, 128, dtype=bf)
    p1, p2 = ffn_params(128, 512), ffn_params(128, 512)
    got = ffn.ffn_pair(x, p1, p2, bf)
    want = ffn.reference_ffn_pair(x, p1, p2, bf)
    err = check_bf16("ffn_pair stage 3 (884736x128, hidden 512)", got, want)
    ms = cuda_time_ms(lambda: ffn.ffn_pair(x, p1, p2, bf))
    plain = cuda_time_ms(lambda: ffn.reference_ffn_pair(x, p1, p2, bf))
    log(f"  ffn_pair: {ms!r} ms, plain {plain!r} ms")
    results["ffn_pair"] = (err, ms, plain)
    del x, got, want

    # K5: the four pyramid shuffles, 1 call each per chunk
    worst, ms_sum, plain_sum = 0.0, 0.0, 0.0
    for shape, factor, F in (((4, 6, 6, 12, 768), (2, 2, 2), 512),
                             ((4, 12, 12, 24, 512), (2, 2, 2), 256),
                             ((4, 24, 24, 48, 256), (2, 2, 2), 128),
                             ((4, 48, 48, 96, 128), (2, 2, 1), 64)):
        cp = shape[-1] // int(np.prod(factor))
        x = randn(*shape, dtype=bf)
        w, b = randn(F, cp, std=cp ** -0.5), randn(F, std=0.1)
        got = shuffle.pixel_shuffle_linear(x, w, b, factor, bf)
        want = shuffle.reference_shuffle(x, w, b, factor, bf)
        worst = max(worst, check_bf16(f"pixel_shuffle_linear {shape} {factor} -> {F}", got, want))
        ms = cuda_time_ms(lambda: shuffle.pixel_shuffle_linear(x, w, b, factor, bf))
        plain = cuda_time_ms(lambda: shuffle.reference_shuffle(x, w, b, factor, bf))
        log(f"  pixel_shuffle_linear {shape}: {ms!r} ms, plain {plain!r} ms")
        ms_sum, plain_sum = ms_sum + ms, plain_sum + plain
    results["pixel_shuffle_linear"] = (worst, ms_sum, plain_sum)
    return results


def phase_model_check(model, device):
    """One 4-window batch through the bf16 model with its kernels and with
    their plain versions (the modules' gates turned off for the second run)."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.ops import attention, ffn, shuffle

    x = bench.make_volume(SEED + 7, (4, 96, 96, 96), device)[0]
    with torch.inference_mode():
        got = model(x.to(torch.bfloat16))[0]
        gates = (attention.supports, ffn.supports, shuffle.supports)
        off = lambda *a, **k: False
        attention.supports = ffn.supports = shuffle.supports = off
        try:
            want = model(x.to(torch.bfloat16))[0]
        finally:
            attention.supports, ffn.supports, shuffle.supports = gates
    torch.cuda.synchronize()
    max_abs, rel_l2 = errors(got, want)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"  model, 4 windows, kernels vs plain: max_abs_err {max_abs!r} rel_l2 {rel_l2!r} "
        f"(bound {MODEL_REL_L2}) argmax agreement {agree!r}")
    if not torch.isfinite(got.float()).all() or rel_l2 > MODEL_REL_L2:
        raise AssertionError("model with kernels disagrees with the plain model")


def phase_slice(device):
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench

    t0 = time.perf_counter()
    model = bench.build_tunet(SEED, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  TUNet params {n_params} (built in {time.perf_counter() - t0:.3f} s)")
    if n_params != 109_904_124:
        raise AssertionError(f"TUNet has {n_params} params, expected 109904124")
    engine = bench.make_engine(model)
    volume = bench.make_volume(SEED, bench.VOLUME_SHAPE, device)
    n_windows = len(engine.plan(bench.VOLUME_SHAPE)[3])
    log(f"  volume {bench.VOLUME_SHAPE}, roi {bench.ROI}, overlap {bench.OVERLAP}: {n_windows} windows")
    if n_windows != 147:
        raise AssertionError(f"{n_windows} windows, expected 147")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, mask = bench.segment(engine, volume)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"  first volume (warm-up) {first!r} s; launches {counts}")
    want_shape = (1, *bench.VOLUME_SHAPE, bench.OUT_CHANNELS)
    if tuple(logits.shape) != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"output {tuple(logits.shape)} (want {want_shape}) or non-finite")
    if tuple(mask.shape) != want_shape[:4] or mask.min() < 0 or mask.max() >= bench.OUT_CHANNELS:
        raise AssertionError("argmax mask out of range")
    hist = torch.bincount(mask.flatten(), minlength=bench.OUT_CHANNELS).tolist()
    log(f"  logits mean {logits.mean().item()!r} std {logits.std().item()!r}; mask classes {hist}")
    missing = [n for n, c in counts.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    del logits, mask

    stats = bench.time_volumes(engine, volume, reps=2, warmup=False)
    log(f"  timed volumes {stats['seconds_per_volume']!r} s -> "
        f"{stats['volumes_per_min']!r} vol/min; peak memory {stats['peak_mem_bytes']} B")
    phase_model_check(model, device)
    return counts, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench

    device = torch.device("cuda", 0)
    log("phase 1: device")
    card = bench.device_line()
    log(f"  {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    bench.set_precision_flags()
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"bf16_reduced_precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    log("phase 2: build")
    log(f"  nvcc build {kernels.build_all()!r} s")

    log("phase 3: kernels against their plain versions (ms per 4-window chunk)")
    results = phase_kernels(device)

    log("phase 4: TUNet sliding-window slice")
    counts, stats = phase_slice(device)

    entries = []
    for info in kernels.KERNELS:
        err, ms, plain = results[info.name]
        entries.append({
            "name": info.name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": counts[info.name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
        })
    log(json.dumps({
        "slice": {"seconds_per_volume": stats["seconds_per_volume"],
                  "volumes_per_min": stats["volumes_per_min"],
                  "peak_mem_bytes": stats["peak_mem_bytes"]},
    }))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
