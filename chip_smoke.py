#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

It checks; it does not measure the port end to end (``python3 -m
benchmark.run`` does). Its timings are phase 3's kernel table and the
per-chunk times beside it. Phases, in order; any failure raises and the
script exits non-zero:

1. Device: ``nvidia-smi`` name and power limit, torch and CUDA versions, the
   TF32 / reduced-precision flags (set off, and printed).
2. Build every kernel of the path from ``hybrid_ctunet_tpu_torch/csrc`` with
   nvcc, all sources in parallel (seconds printed).
3. Each kernel against its plain PyTorch version at the main path's shapes
   (K1 scatter must be bit-exact, at four chunk shapes: windows 4-7 of the
   TUNet and of the CTUNet engine and each engine's trailing chunk, and with
   the engine's constant importance map (``mode="constant"``); the bf16
   kernels must meet the stated tolerance), with CUDA-event times per
   4-window chunk of the kernel, its
   plain version and, where one PyTorch call computes the same function,
   that call (median of 5 runs of 10 back-to-back calls); and each
   kernel's bound, the least time an H100 could take for the same bytes and
   operations. K2 is also logged per pyramid stage against SDPA, K5 per
   pyramid site and K7 per width (the C entry alone, a rerun bit for bit;
   K7's weight packing against its plain layout), K6 per decoder site
   against cuDNN, K8 per InstanceNorm site (its regime, the C entry alone,
   F.instance_norm, a rerun bit for bit) with a CTUNet-chunk and a
   TUNet-chunk total, and K8's residual tails per (shape, residual form),
   each bit for bit the unfused K8, add and LeakyReLU, timed fused and
   unfused per chunk; K9 per call against cuDNN with its fused entry beside
   it; K3-K8 also as the C entry alone.
4. The TUNet slice: full-width TUNet (109,904,124 params, random weights from
   a seed, bf16) through ``cli/bench.py``'s functions, one 256x256x128 volume
   at overlap 0.7 (147 windows, sw_batch 4); every launch counted and held
   equal to the count the module tree implies; one 4-window
   batch with every kernel call held to its plain version on the model's
   activations, and the output against the same model on plain versions;
   the TUNet saved as a reference-format checkpoint for phase 7.
5. The Hybrid-CTUNet ensemble: full-width CTUNet (ResNet-101, pf 8,
   174,109,542 params, res head only, overlap 0.5, 50 windows) and the
   TUNet, softmax-mean and argmax over the same volume; launch counts per
   volume equal to the module tree's for all nine kernels and K8's residual
   tails (``instance_norm.residual``);
   one 4-window CTUNet batch checked as the TUNet one (every gate off for
   the plain run); one 4-window batch of full-width CUNet (50,779,754
   params).
6. Training (main_CTUNet.py): every kernel's
   autograd.Function against its plain path's backward at the training
   shapes (CUNet's decoder sites included); the full-width CTUNet trained
   on --synthetic data through the
   port's train step at batch 4 x 96^3 in bf16 with block remat on (the
   default) and off, one warm-up and one checked step each, the checked
   step's peak memory, launches per step equal to the module tree's (with
   remat, K8 and K9 of the rematerialized blocks twice) and a finite loss;
   one step's gradients with remat equal to those without;
   one profiled step; then ``cli/train_main.py`` end to end (two epochs, a
   validation pass, the three best-metric checkpoints and latest.pt, which
   must load back; the checkpoints are kept for phase 7). C6: that
   two-epoch CTUNet's res head with kernels against the plain model on 4
   windows of its synthetic data, logged (its weights are still chaotic);
   then the run resumed from latest.pt to 32 epochs and the same check
   held within MODEL_REL_L2 and argmax agreement >= 0.995, the one-ulp
   sensitivity logged beside.
7. The eval CLI (``cli/test_main.py``), this slice's main path: one
   synthetic validation case whose preprocessed grid is 256x256x128;
   ``test_final`` (phase 6's trained CTUNet res head + phase 4's TUNet) at
   full width, again with ``--postprocess``, and ``test_ctunet`` on phase
   6's three checkpoints; launches per run equal to the module tree's times
   the chunks, every engine's first and trailing K1 call bit-exact on the
   eval's own canvas, finite Dice and HD95, the report's HD95 block, the
   masks at the case's native shape; seconds per case on the device and on
   the host.
8. The remaining training configurations, this slice's main path, at full
   width (ResNet-101, pf 8, batch 1 x 4 crops of 96^3, bf16, AdamW):
   (a) ``--dropout_rate 0.2``: a warm-up and a checked step with remat on
   and off, finite losses and launches equal to the tree's with
   the dropout sites plain; the gradients with remat equal those without;
   a step redone at the same (seed, step) draws the same masks, and every
   mask a recompute draws equals its forward's; in eval mode the res
   logits equal a rate-0 model's bit for bit on a chunk. Then
   ``--batch_size 2`` (8 crops a step) with dropout and remat, which
   needs remat to fit the card: its peak memory.
   (b) ``--norm_name batch``: a warm-up and a checked step with remat on
   and off (K8 at no BatchNorm site), the running buffers moved
   and finite, and after one step equal with remat and without, as are the
   gradients; one profiled step, an eval chunk with every kernel held to
   its plain version.
   (c) DDP on the one card: a DDP step (NCCL, world 1) against the plain
   step, ``train_main --distributed`` for one epoch with validation (its
   checkpoints written once, ``latest.pt`` reloaded), and ``test_final
   --distributed`` on phase 7's case, whose masks must equal phase 7's.
   Each sub-phase's peak memory and launches; the run's wall time.
9. The ensemble at 8 windows a chunk (launches per volume equal to the
   module tree's x 7 CTUNet and 19 TUNet chunks, K1 bit-exact on each
   engine's first 8-window and trailing 2- and 3-window chunks, one
   8-window chunk of each model with every kernel call held to its plain
   version); ``utils/profiling.py::profile_device`` on a warm volume of
   each half with every kernel's traced records equal to its launch
   counter (as in the profiled steps of phases 6 and 8b); ``utils.
   profiling.enable_nan_checks`` catching a NaN planted in a TUNet chunk.
10. main_C_TUNet.py's workflow at full width (batch 1 x 4 crops of 96^3,
   bf16, AdamW, --synthetic): (a) the TUNet (pf 8, 109,904,124 params) and
   CUNet (ResNet-101, 50,779,754 params) train steps, a warm-up and a
   checked step each with remat on and off, launches equal to the module
   tree's, finite losses, peak memory, one step's gradients with remat
   against without; (b) ``python -m hybrid_ctunet_tpu_torch.cli.
   train_main c_tunet --model_name tunet``, then ``cunet``, two epochs with
   validation, each writing its best-metric file (``model_vit.pt``,
   ``model_res.pt``) and latest.pt, both loaded back, every kernel of the
   model launched (K1 in the validation); (c) ``test_single`` on each, on
   phase 7's case, checked as phase 7's runs, HD95 computed from its saved
   mask; (d) ``test_final`` on phase 6's trained CTUNet and (b)'s trained
   TUNet (the README's train, train, evaluate).
11. Swin-UNETR (MONAI's BTCV model, 62,187,296 params) at full width: K2's
   head-width-16 instance at each stage's shapes and K8 at its C = 48 * 2^k
   InstanceNorm and tail sites against their plain versions, bit for bit on
   a rerun, timed per chunk with the plain version, the library call and
   the bound; a 4-window chunk with every kernel call held to its plain
   version, launches, K2's windows and K8's launches at the new widths
   against the module tree, the traced records reconciled with the
   counters, the chunk's time and peak memory; a 256x256x128 volume with
   its launches against the tree; train steps with remat on and off;
   ``train_main c_tunet --model_name swin_unetr`` and ``test_single`` on
   its ``model_vit.pt``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits with an error and prints no result.
"""
from __future__ import annotations

import collections
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# bf16 kernels against their plain versions: summation order inside the
# matmuls differs, so a value may round one bf16 ulp (2^-8 relative) apart at
# any rounding point, and a flipped intermediate moves the next product.
BF16_MAX_ABS_FRACTION = 2.0 ** -5  # max |kernel - plain| <= this * max |plain|
BF16_REL_L2 = 1e-2
# the whole bf16 TUNet with kernels against the same model on plain versions:
# the per-op differences above, carried through ~40 layers. (The random-weight
# CTUNet is chaotic, see model_check.)
MODEL_REL_L2 = 5e-2
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# bf16 tensor-core FLOP/s and fp32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
CHUNK = 4  # windows per chunk (sw_batch_size)
CTUNET_PARAMS = 174_109_542  # at ResNet-101, pf 8, instance norm
# C6 needs a CTUNet that is no longer chaotic: phase 6's train_main run (two
# epochs of two steps: two synthetic cases) is resumed to this many epochs
# (resumed to 24, the kernels-vs-plain rel L2 was 0.032 of MODEL_REL_L2)
C6_EPOCHS = 32


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 5, calls: int = 10) -> float:
    """Milliseconds per call of ``fn``: after one warm-up, the median over
    ``reps`` CUDA-event timings of ``calls`` back-to-back calls, divided by
    ``calls``, so that the host's launch time between calls is hidden as it
    is on the main path, where the host runs ahead of the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
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


class Tally:
    """One kernel's row: worst error, and per chunk the kernel, plain and
    library times and the bound, each summed over the chunk's calls. A
    call's bound is max(bytes / HBM rate, FLOP / bf16 rate, fp32 FLOP /
    fp32 rate), bytes counting each input read once and each output written
    once; the tensor cores and the fp32 units run side by side, so the
    larger of their two times bounds the operations."""

    def __init__(self, library: bool):
        self.err = 0.0
        self.ms = self.plain_ms = self.bound_ms = 0.0
        self.library_ms = 0.0 if library else None
        self.by = {"bytes": 0.0, "operations": 0.0}

    def add(self, err, n, ms, plain_ms, nbytes, flops, library_ms=None, fp32_flops=0):
        """``n`` calls per chunk of one shape; ``flops`` on the tensor cores
        in bf16, ``fp32_flops`` outside them."""
        self.err = max(self.err, err)
        self.ms += n * ms
        self.plain_ms += n * plain_ms
        if self.library_ms is not None:
            self.library_ms += n * library_ms
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(flops / BF16_FLOP_PER_S, fp32_flops / FP32_FLOP_PER_S) * 1e3
        self.bound_ms += n * max(t_bytes, t_ops)
        self.by["bytes" if t_bytes >= t_ops else "operations"] += n * max(t_bytes, t_ops)

    def row(self):
        return {"max_abs_err": self.err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": max(self.by, key=self.by.get),
                "library_ms": self.library_ms}


def erff_fp32_flops() -> int:
    """fp32 FLOP of one ``erff`` as this card's compiler builds it: a kernel
    that applies it once, compiled for sm_90a and read back with
    ``cuobjdump -sass``; FFMA counts 2, FADD, FMUL and MUFU 1 each (selects,
    compares and moves none)."""
    import re
    import subprocess

    from hybrid_ctunet_tpu_torch import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, cubin = kernels.BUILD_DIR / "erff_probe.cu", kernels.BUILD_DIR / "erff_probe.cubin"
    src.write_text("__global__ void k(float* p) { p[threadIdx.x] = erff(p[threadIdx.x]); }\n")
    nvcc = kernels._nvcc()
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin", "-o",
                    str(cubin), str(src)], check=True, capture_output=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(cubin)],
                          check=True, capture_output=True, text=True).stdout
    ops = re.findall(r"\b(FFMA|FADD|FMUL|MUFU)\b", sass)
    return sum(2 if op == "FFMA" else 1 for op in ops)


def meta_forward(model, x, **kw):
    """One eval forward of ``model`` on the meta tensor ``x`` without
    gradient: shapes only, nothing computed. The parameters and buffers are
    swapped for meta twins (``torch.func.functional_call``), so a model on
    the card serves too. In eval mode no block is rematerialized and no
    dropout drawn, so each site runs once."""
    import torch

    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in (*model.named_parameters(), *model.named_buffers())}
    training = model.training
    try:
        model.eval()
        with torch.no_grad():
            torch.func.functional_call(model, meta, (x,), kw)
    finally:
        model.train(training)


def record_norm_sites(model, x, **kw):
    """The conv-path InstanceNorm sites of one forward of ``model`` on
    ``x`` (``meta_forward``): (shape, act) -> calls, and the residual tails
    of instance kind (``ConvNorm.tail``) as (norm module, shape, raw
    residual), in call order. On the meta device every tail takes its plain
    composition, so its norms are among the (shape, act) calls too."""
    from hybrid_ctunet_tpu_torch.models import layers

    sites = collections.Counter()
    tails = []
    orig, orig_tail = layers.instance_norm_act, layers.ConvNorm.tail

    def rec(t, act=False):
        sites[(tuple(t.shape), act)] += 1
        return orig(t, act)

    def rec_tail(norm, a, residual, residual_norm=None):
        if norm.kind == "instance":
            tails.append((norm, tuple(a.shape), residual_norm is not None))
        return orig_tail(norm, a, residual, residual_norm)

    layers.instance_norm_act, layers.ConvNorm.tail = rec, rec_tail
    try:
        meta_forward(model, x, **kw)
    finally:
        layers.instance_norm_act, layers.ConvNorm.tail = orig, orig_tail
    return sites, tails


def record_conv_sites(model, x, **kw):
    """(x shape, w shape, stride) -> calls of ``conv3d_same`` in one forward
    of ``model`` on ``x`` (``meta_forward``)."""
    from hybrid_ctunet_tpu_torch.models import layers, swin_unetr

    sites = collections.Counter()
    orig = layers.conv3d_same

    def rec(t, w, stride=1):
        sites[(tuple(t.shape), tuple(w.shape), layers._triple(stride))] += 1
        return orig(t, w, stride)

    layers.conv3d_same = swin_unetr.conv3d_same = rec
    try:
        meta_forward(model, x, **kw)
    finally:
        layers.conv3d_same = swin_unetr.conv3d_same = orig
    return sites


def phase_kernels(device):
    """Each kernel against its plain version at the main path's shapes.
    Returns {kernel: Tally row} with times per 4-window chunk."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hybrid_ctunet_tpu_torch.ops import attention, ffn, pixelweight, shuffle

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=device) * std + mean).to(dtype)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    results = {"scatter_add_windows": scatter_rows(device)}

    # K2: window attention at pyramid stages 0-2 (block and grid calls share
    # shapes: 2 calls per stage per chunk), the bias from a random
    # ((2w-1)^3, heads) table as the layer holds it; library: SDPA with the
    # gathered bias as an additive bf16 mask (gathered outside the timing),
    # q pre-scaled. Bound: q, k, v, the table and the output once; the
    # products on the tensor cores and, per score, the bias add, max, exp,
    # sum and division in fp32.
    t = Tally(library=True)
    stages = []
    for stage, (nwin, C) in enumerate(((8, 768), (64, 512), (512, 256))):
        heads, w = C // 32, 6
        T = w ** 3
        qkv = randn(nwin, T, 3 * C, dtype=bf)
        q = qkv[..., :C] * 32 ** -0.5
        k, v = qkv[..., C : 2 * C], qkv[..., 2 * C :]
        table = randn((2 * w - 1) ** 3, heads)
        got = attention.window_attention(q, k, v, table, w, bf)
        want = attention.reference_window_attention_table(q, k, v, table, w, bf)
        err = check_bf16(f"window_attention stage {stage} ({nwin}x{T}x{C})", got, want)
        ms = cuda_time_ms(lambda: attention.window_attention(q, k, v, table, w, bf))
        plain = cuda_time_ms(
            lambda: attention.reference_window_attention_table(q, k, v, table, w, bf))
        qh, kh, vh = (a.reshape(nwin, T, heads, 32).transpose(1, 2) for a in (q, k, v))
        mask = attention.gather_bias(table, w).to(bf).contiguous()[None]
        lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                                  scale=1.0))
        log(f"  window_attention stage {stage}: {ms!r} ms, plain {plain!r} ms, sdpa {lib!r} ms "
            f"per call")
        stages.append({"stage": stage, "windows": nwin, "C": C, "ms": ms, "plain_ms": plain,
                       "library_ms": lib})
        t.add(err, 2, ms, plain, nbytes(q, k, v, table, got), 4 * nwin * T * T * C, lib,
              fp32_flops=5 * nwin * heads * T * T)
    results["window_attention"] = {**t.row(), "stages": stages}
    del qkv, q, k, v, got, want, mask

    def ffn_params(c, h):
        return (1.0 + randn(c, std=0.1), randn(c, std=0.1), randn(h, c, std=c ** -0.5),
                randn(h, std=0.1), randn(c, h, std=h ** -0.5), randn(c, std=0.1))

    erf_flops = erff_fp32_flops()
    log(f"  erff: {erf_flops} fp32 FLOP an element (SASS of a one-erff kernel)")

    def ffn_fp32_flops(rows, c, h):
        """fp32 FLOP of one residual FFN outside the tensor cores: per input
        element the LN's 7 (sum, minus the mean, the squares' FMA, times
        rstd, the affine's FMA); per hidden element the bias add, the GELU
        formula's 4 (x/sqrt 2, 1 + erf, x/2, the product) and erff's; per
        output element the bias and residual adds. The function's work
        whatever implements it (K4 reads its GELU from a table)."""
        return rows * (7 * c + h * (5 + erf_flops) + 2 * c)

    # K3: stage-2 FFN, residual, 2 calls per chunk
    x = randn(CHUNK, 24, 24, 48, 256, dtype=bf)
    p = ffn_params(256, 1024)
    got = ffn.ffn(x, *p, bf, residual=True)
    want = x + ffn.reference_ffn(x, *p, bf)
    err = check_bf16("ffn stage 2 (110592x256, hidden 1024)", got, want)
    ms = cuda_time_ms(lambda: ffn.ffn(x, *p, bf, residual=True))
    fn, args, _, keep = ffn.ffn_call(x, p, bf, residual=True)
    alone = cuda_time_ms(lambda: fn(*args))  # the C entry on bound arguments
    plain = cuda_time_ms(lambda: x + ffn.reference_ffn(x, *p, bf))
    log(f"  ffn: {ms!r} ms, kernel alone {alone!r} ms, plain {plain!r} ms per call")
    t = Tally(library=False)
    rows = x.numel() // 256
    t.add(err, 2, ms, plain, 2 * nbytes(x) + nbytes(*p), 4 * rows * 256 * 1024,
          fp32_flops=ffn_fp32_flops(rows, 256, 1024))
    results["ffn"] = {**t.row(), "kernel_alone_ms": 2 * alone}
    del keep

    # K4: stage-3 FFN pair, 1 call per chunk
    x = randn(CHUNK, 48, 48, 96, 128, dtype=bf)
    p1, p2 = ffn_params(128, 512), ffn_params(128, 512)
    got = ffn.ffn_pair(x, p1, p2, bf)
    want = ffn.reference_ffn_pair(x, p1, p2, bf)
    err = check_bf16("ffn_pair stage 3 (884736x128, hidden 512)", got, want)
    ms = cuda_time_ms(lambda: ffn.ffn_pair(x, p1, p2, bf))
    fn, args, _, keep = ffn.pair_call(x, p1, p2, bf)
    alone = cuda_time_ms(lambda: fn(*args))  # the C entry on bound arguments
    plain = cuda_time_ms(lambda: ffn.reference_ffn_pair(x, p1, p2, bf))
    log(f"  ffn_pair: {ms!r} ms, kernel alone {alone!r} ms, plain {plain!r} ms")
    t = Tally(library=False)
    rows = x.numel() // 128
    t.add(err, 1, ms, plain, 2 * nbytes(x) + nbytes(*p1, *p2), 2 * 4 * rows * 128 * 512,
          fp32_flops=2 * ffn_fp32_flops(rows, 128, 512))
    results["ffn_pair"] = {**t.row(), "kernel_alone_ms": alone}
    del x, got, want, keep

    # K5: the four pyramid shuffles, 1 call each per chunk (TUNet; CTUNet's
    # res-only path runs the first three), w and b fp32 as the layer holds
    # them; per site the wrapper, the C entry alone (``shuffle.shuffle_call``),
    # the plain version, the bound and a rerun bit for bit
    t = Tally(library=False)
    sites, alone_sum = [], 0.0
    for shape, factor, Fo in (((CHUNK, 6, 6, 12, 768), (2, 2, 2), 512),
                              ((CHUNK, 12, 12, 24, 512), (2, 2, 2), 256),
                              ((CHUNK, 24, 24, 48, 256), (2, 2, 2), 128),
                              ((CHUNK, 48, 48, 96, 128), (2, 2, 1), 64)):
        cp = shape[-1] // int(np.prod(factor))
        x = randn(*shape, dtype=bf)
        w, b = randn(Fo, cp, std=cp ** -0.5), randn(Fo, std=0.1)
        got = shuffle.pixel_shuffle_linear(x, w, b, factor, bf)
        want = shuffle.reference_shuffle(x, w, b, factor, bf)
        err = check_bf16(f"pixel_shuffle_linear {shape} {factor} -> {Fo}", got, want)
        if not torch.equal(got, shuffle.pixel_shuffle_linear(x, w, b, factor, bf)):
            raise AssertionError(f"pixel_shuffle_linear {shape}: a rerun is not bit-identical")
        ms = cuda_time_ms(lambda: shuffle.pixel_shuffle_linear(x, w, b, factor, bf))
        fn, args, _, keep = shuffle.shuffle_call(x, w, b, factor, bf)
        alone = cuda_time_ms(lambda: fn(*args))  # the C entry on bound arguments
        plain = cuda_time_ms(lambda: shuffle.reference_shuffle(x, w, b, factor, bf))
        log(f"  pixel_shuffle_linear {shape} (rerun bit-identical): {ms!r} ms, kernel alone "
            f"{alone!r} ms, plain {plain!r} ms")
        site = Tally(library=False)
        for tally in (t, site):
            tally.add(err, 1, ms, plain, nbytes(x, w, b, got), 2 * got.numel() * cp)
        sites.append({"x": list(shape), "factor": list(factor), "features": Fo, **site.row(),
                      "kernel_alone_ms": alone})
        alone_sum += alone
        del keep
    results["pixel_shuffle_linear"] = {**t.row(), "kernel_alone_ms": alone_sum, "sites": sites}
    del x, got, want

    # K6: the four decoder upsamples of CTUNet/CUNet, 1 call each per chunk,
    # w fp32 as the layer holds it; library: F.conv_transpose3d (cuDNN) on
    # the channels-last views with a bf16 weight made outside the timing
    t = Tally(library=True)
    sites, alone_sum = [], 0.0
    for shape, k, cout in (((CHUNK, 6, 6, 12, 1024), (2, 2, 2), 512),
                           ((CHUNK, 12, 12, 24, 512), (2, 2, 2), 256),
                           ((CHUNK, 24, 24, 48, 256), (2, 2, 2), 128),
                           ((CHUNK, 48, 48, 96, 128), (2, 2, 1), 64)):
        cin = shape[-1]
        x = randn(*shape, dtype=bf)
        w = randn(cin, cout, *k, std=(2.0 / (cin * int(np.prod(k)))) ** 0.5)
        got = shuffle.transp_conv_kxs(x, w, bf)
        want = shuffle.reference_transp_conv(x, w, bf)
        err = check_bf16(f"transp_conv_kxs {shape} {k} -> {cout}", got, want)
        ms = cuda_time_ms(lambda: shuffle.transp_conv_kxs(x, w, bf))
        fn, args, _, keep = shuffle.transp_call(x, w, bf)
        alone = cuda_time_ms(lambda: fn(*args))  # the C entry on bound arguments
        plain = cuda_time_ms(lambda: shuffle.reference_transp_conv(x, w, bf))
        xc, wb = x.permute(0, 4, 1, 2, 3), w.to(bf)
        lib = cuda_time_ms(lambda: F.conv_transpose3d(xc, wb, stride=k))
        log(f"  transp_conv_kxs {shape}: {ms!r} ms, kernel alone {alone!r} ms, plain {plain!r} ms, "
            f"conv_transpose3d {lib!r} ms")
        site = Tally(library=True)
        for tally in (t, site):
            tally.add(err, 1, ms, plain, nbytes(x, w, got), 2 * got.numel() * cin, lib)
        sites.append({"x": list(shape), "k": list(k), "cout": cout, **site.row(),
                      "kernel_alone_ms": alone})
        alone_sum += alone
        del keep
    results["transp_conv_kxs"] = {**t.row(), "kernel_alone_ms": alone_sum, "sites": sites}
    del x, got, want

    # K7: the two fusions of each Up2FusionBlock, 2 calls per width per chunk,
    # the parameters fp32 as the layer holds them; per width the wrapper, the
    # C entry alone (``pixelweight.pixelweight_call``), the plain version, the
    # bound, a rerun bit for bit, and the entry's weight packing against its
    # plain layout (``pixelweight.pack_weights``) bit for bit
    t = Tally(library=False)
    sites, alone_sum = [], 0.0
    for shape in ((CHUNK, 12, 12, 24, 512), (CHUNK, 24, 24, 48, 256), (CHUNK, 48, 48, 96, 128)):
        C = shape[-1]
        x1, x2 = randn(*shape, dtype=bf), randn(*shape, dtype=bf)
        p = (1.0 + randn(C, std=0.1), randn(C, std=0.1), 1.0 + randn(C, std=0.1),
             randn(C, std=0.1), randn(3 * C, C, std=C ** -0.5), randn(3 * C, C, std=C ** -0.5),
             randn(C, C, std=C ** -0.5))
        got = pixelweight.pixelweight(x1, x2, p, bf)
        want = pixelweight.reference_pixelweight(x1, x2, p, bf)
        err = check_bf16(f"pixelweight {shape}", got, want)
        if not torch.equal(got, pixelweight.pixelweight(x1, x2, p, bf)):
            raise AssertionError(f"pixelweight {shape}: a rerun is not bit-identical")
        packed = pixelweight.device_pack(*p[4:]).cpu().view(torch.int16)
        if not torch.equal(packed, pixelweight.pack_weights(*[w.cpu() for w in p[4:]]).view(
                torch.int16)):
            raise AssertionError(f"pixelweight C {C}: the packing launch differs from pack_weights")
        ms = cuda_time_ms(lambda: pixelweight.pixelweight(x1, x2, p, bf))
        fn, args, _, keep = pixelweight.pixelweight_call(x1, x2, p, bf)
        alone = cuda_time_ms(lambda: fn(*args))  # the C entry on bound arguments
        plain = cuda_time_ms(lambda: pixelweight.reference_pixelweight(x1, x2, p, bf))
        log(f"  pixelweight {shape} (rerun bit-identical, packing = pack_weights): {ms!r} ms, "
            f"kernel alone {alone!r} ms, plain {plain!r} ms per call")
        rows = x1.numel() // C
        site = Tally(library=False)
        for tally in (t, site):
            tally.add(err, 2, ms, plain, nbytes(x1, x2, got, *p), 14 * rows * C * C)
        sites.append({"x": list(shape), "calls": 2, **site.row(), "kernel_alone_ms": 2 * alone})
        alone_sum += 2 * alone
        del keep
    results["pixelweight"] = {**t.row(), "kernel_alone_ms": alone_sum, "sites": sites}
    del x1, x2, got, want

    results["instance_norm"] = norm_rows(randn, nbytes)
    results["conv3x3_winograd"] = winograd_rows(randn, nbytes)
    results["conv3x3"] = conv3x3_rows(randn, nbytes)
    return results


def k1_chunks(device):
    """(name, acc, pred, imp, starts) of K1's four main-path chunk shapes on
    the 256x256x128x15 canvas: windows 4-7 of the TUNet (overlap 0.7) and of
    the CTUNet (0.5) engines, and each engine's trailing chunk (3 of the
    TUNet's 147 windows, 2 of the CTUNet's 50); random canvas, bf16
    predictions as the models emit them."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine
    from hybrid_ctunet_tpu_torch.ops.importance import gaussian_importance_map

    gen = torch.Generator(device=device).manual_seed(0)
    imp = torch.tensor(gaussian_importance_map(bench.ROI), device=device)
    acc = torch.randn(*bench.VOLUME_SHAPE, bench.OUT_CHANNELS + 1, generator=gen, device=device)
    pred = torch.randn(4, *bench.ROI, bench.OUT_CHANNELS, generator=gen,
                       device=device).to(torch.bfloat16)
    chunks = []
    for model, overlap in (("tunet", bench.OVERLAP), ("ctunet", bench.CT_OVERLAP)):
        starts = SlidingWindowEngine(None, bench.ROI, overlap=overlap).plan(bench.VOLUME_SHAPE)[3]
        last = (len(starts) - 1) // 4 * 4
        for name, s in ((f"{model} windows 4-7", starts[4:8]),
                        (f"{model} trailing ({len(starts) - last} of {len(starts)})",
                         starts[last:])):
            chunks.append((name, acc, pred[:len(s)].contiguous(), imp, s))
    return chunks


def scatter_rows(device):
    """K1 at its four main-path chunk shapes on the 256x256x128x15 canvas
    (``k1_chunks``: windows 4-7 of the TUNet engine at
    overlap 0.7, the row, and of the CTUNet engine at 0.5; each engine's
    trailing chunk, 3 and 2 windows), each held bit for bit to its plain
    version and timed with the plain version and the bound: the canvas the
    windows cover read and written once, the predictions and the importance
    read once, 2C+1 fp32 operations per window voxel."""
    import numpy as np
    import torch

    from hybrid_ctunet_tpu_torch.ops import scatter

    row, chunks = None, []
    for name, acc0, pred, imp, starts in k1_chunks(device):
        got = scatter.scatter_add_windows(acc0.clone(), pred, imp, starts)
        want = scatter.reference_scatter_add_windows(acc0.clone(), pred, imp, starts)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        max_abs = (got - want).abs().max().item()
        log(f"  scatter_add_windows {name} starts {starts.tolist()}: bit-exact {exact} "
            f"max_abs_err {max_abs!r}")
        if not exact:
            raise AssertionError(f"scatter_add_windows {name}: not bit-exact with its plain version")
        del got, want
        acc = acc0.clone()
        ms = cuda_time_ms(lambda: scatter.scatter_add_windows(acc, pred, imp, starts))
        plain = cuda_time_ms(lambda: scatter.reference_scatter_add_windows(acc, pred, imp, starts))
        covered = np.zeros(acc.shape[:3], bool)  # the canvas the windows read and write
        for x0, y0, z0 in starts.tolist():
            covered[x0:x0 + imp.shape[0], y0:y0 + imp.shape[1], z0:z0 + imp.shape[2]] = True
        canvas_bytes = int(covered.sum()) * acc.shape[-1] * 4
        t = Tally(library=False)
        t.add(max_abs, 1, ms, plain, pred.numel() * pred.element_size() + imp.numel() * 4
              + 2 * canvas_bytes, 0, fp32_flops=len(starts) * imp.numel() * (2 * pred.shape[-1] + 1))
        chunk = {"chunk": name, "starts": starts.tolist(), "bit_exact": exact, **t.row()}
        log(f"  scatter_add_windows {name}: {ms!r} ms, plain {plain!r} ms, bound "
            f"{chunk['bound_ms']!r} ms")
        chunks.append(chunk)
        row = row or t.row()  # the row: the TUNet chunk of 4 windows
        del acc
    # the constant blend (SlidingWindowEngine mode="constant", the functional
    # sliding_window_inference's default) at the first chunk's shape
    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine

    name, acc0, pred, _, starts = k1_chunks(device)[0]
    ones = torch.tensor(SlidingWindowEngine(None, bench.ROI, mode="constant").importance(),
                        device=device)
    got = scatter.scatter_add_windows(acc0.clone(), pred, ones, starts)
    want = scatter.reference_scatter_add_windows(acc0.clone(), pred, ones, starts)
    torch.cuda.synchronize()
    constant = torch.equal(got, want)
    log(f"  scatter_add_windows {name}, constant importance map: bit-exact {constant}")
    if not constant:
        raise AssertionError("scatter_add_windows: not bit-exact with the constant map")
    return {**row, "chunks": chunks, "constant_map_bit_exact": constant}


def norm_rows(randn, nbytes):
    """K8 at every conv-path InstanceNorm of one CTUNet res-only chunk (the
    row) and of one TUNet chunk (``tunet_chunk``), the shapes recorded from
    forwards on the meta device. Each (shape, act) is held to its plain
    version and to itself on a rerun, bit for bit, and timed through the
    wrapper, as the C entry alone (``norm.norm_call``) and as the library
    call, F.instance_norm (+ in-place F.leaky_relu_) on the channels-last
    view; its regime is ``norm.plan``'s. Then K8's residual tails
    (``tails``, per chunk): each (shape, raw residual) bit for bit the
    unfused sequence it replaces (K8 of a [and of the raw residual], torch's
    add and LeakyReLU), and itself on a rerun, held to its plain version,
    timed fused, as the C entry alone (``norm.tail_call``) and unfused; its
    bound reads a and the residual once and writes once."""
    import torch
    import torch.nn.functional as F

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet
    from hybrid_ctunet_tpu_torch.ops import norm

    bf = torch.bfloat16
    x_meta = torch.empty(CHUNK, *bench.ROI, 1, device="meta")
    ct_model = CTUNet(out_channels=bench.OUT_CHANNELS, model_depth=101, patch_frame=8,
                      dtype=bf, device="meta")
    tu_model = TUNet(out_channels=bench.OUT_CHANNELS, patch_frame=8, dtype=bf, device="meta")
    recorded = {"ctunet": record_norm_sites(ct_model, x_meta, res_only=True),
                "tunet": record_norm_sites(tu_model, x_meta)}
    census = {name: sites for name, (sites, _) in recorded.items()}
    tails = {name: collections.Counter((shape, raw) for _, shape, raw in t)
             for name, (_, t) in recorded.items()}
    for name, model, kw in (("ctunet", ct_model, {"res_only": True}), ("tunet", tu_model, {})):
        calls = sum(census[name].values())
        folded = sum(n for (shape, raw), n in tails[name].items() if raw and norm.folds(shape))
        tree = tree_launches(model, **kw)
        log(f"  instance_norm sites per {name} chunk: {calls} calls, "
            f"{len(census[name])} distinct (shape, act); {sum(tails[name].values())} residual "
            f"tails, {folded} of them folding their projection's norm")
        if calls - folded != tree["instance_norm"] or \
                sum(tails[name].values()) != tree["instance_norm.residual"]:
            raise AssertionError(f"recorded {name} InstanceNorm sites differ from the module tree's")
    tallies = {name: Tally(library=True) for name in census}
    alone_sums = dict.fromkeys(census, 0.0)
    sites = []
    for shape, act in sorted(set(census["ctunet"]) | set(census["tunet"])):
        x = randn(*shape, dtype=bf, std=2.0, mean=0.5)
        run = (lambda: norm.instance_norm_leaky(x)) if act else (lambda: norm.instance_norm(x))

        def plain_fn():
            y = norm.reference_instance_norm(x)
            return F.leaky_relu(y, 0.01) if act else y

        def lib_fn():
            y = F.instance_norm(x.permute(0, 4, 1, 2, 3), eps=1e-5)
            return F.leaky_relu_(y, 0.01) if act else y

        got = run()
        err = check_bf16(f"instance_norm {shape} act={act}", got, plain_fn())
        if not torch.equal(got, run()):
            raise AssertionError(f"instance_norm {shape} act={act}: a rerun is not bit-identical")
        del got
        fn, args, _, p = norm.norm_call(x, 1e-5, 0.01 if act else None)
        ms, alone = cuda_time_ms(run), cuda_time_ms(lambda: fn(*args))
        plain, lib = cuda_time_ms(plain_fn), cuda_time_ms(lib_fn)
        regime = "onchip" if p.onchip else "two-pass"
        site = Tally(library=True)
        site.add(err, 1, ms, plain, 2 * nbytes(x), 5 * x.numel(), lib)
        row = site.row()
        log(f"  instance_norm {shape} act={act} ({regime}, rerun bit-identical): {ms!r} ms, kernel "
            f"alone {alone!r} ms, plain {plain!r} ms, F.instance_norm {lib!r} ms, bound "
            f"{row['bound_ms']!r} ms")
        calls = {name: census[name].get((shape, act), 0) for name in census}
        for name, n in calls.items():
            if n:
                tallies[name].add(err, n, ms, plain, 2 * nbytes(x), 5 * x.numel(), lib)
                alone_sums[name] += n * alone
        sites.append({"x": list(shape), "act": act, "calls": calls, "regime": regime,
                      "plan": p._asdict(), **row, "kernel_alone_ms": alone})
        del x
    tu = {**tallies["tunet"].row(), "kernel_alone_ms": alone_sums["tunet"]}
    log(f"  instance_norm per TUNet chunk: {tu['ms']!r} ms (alone {tu['kernel_alone_ms']!r}), "
        f"F.instance_norm {tu['library_ms']!r} ms, bound {tu['bound_ms']!r} ms")
    return {**tallies["ctunet"].row(), "kernel_alone_ms": alone_sums["ctunet"], "sites": sites,
            "tunet_chunk": tu, "tails": tail_rows(tails, randn, nbytes)}


def tail_rows(tails, randn, nbytes):
    """K8's residual tails of norm_rows: per chunk (``tails``: name ->
    Counter of (shape, raw residual)) the fused tails' ms (``ms``; the C
    entry's ``alone_ms``, on chip without a raw residual's own K8), the
    unfused sequences' (``unfused_ms``), the plain version's and the bound
    (a and the residual read once, the output written once, bf16), with
    each site's row."""
    import torch
    import torch.nn.functional as F

    from hybrid_ctunet_tpu_torch.ops import norm

    bf = torch.bfloat16
    tallies = {name: Tally(library=False) for name in tails}
    extra = {name: {"unfused_ms": 0.0, "alone_ms": 0.0, "calls": 0} for name in tails}
    sites = []
    for shape, raw in sorted(set().union(*tails.values())):
        a = randn(*shape, dtype=bf, std=2.0, mean=0.5)
        r = randn(*shape, dtype=bf, std=2.0, mean=0.5 if raw else 0.0)
        what = f"instance_norm tail {shape} {'raw' if raw else 'as is'}"

        def fused():
            return norm.instance_norm_add_leaky(a, r, raw)

        def unfused():
            return F.leaky_relu(norm.instance_norm(a) + (norm.instance_norm(r) if raw else r),
                                0.01)

        def plain():
            res = norm.reference_instance_norm(r) if raw else r
            return F.leaky_relu(norm.reference_instance_norm(a) + res, 0.01)

        got = fused()
        if not torch.equal(got, unfused()):
            raise AssertionError(f"{what}: the fused tail differs from the unfused sequence")
        if not torch.equal(got, fused()):
            raise AssertionError(f"{what}: a rerun is not bit-identical")
        err = check_bf16(what, got, plain())
        del got
        fold = raw and norm.folds(shape)
        ms, unf, pl = cuda_time_ms(fused), cuda_time_ms(unfused), cuda_time_ms(plain)
        fn, args, _, _ = norm.tail_call(a, r, fold)  # on chip, without the residual's K8
        alone = cuda_time_ms(lambda: fn(*args))
        site = Tally(library=False)
        site.add(err, 1, ms, pl, 3 * nbytes(a), 0)
        row = site.row()
        regime = "onchip" if norm.plan(shape[0], math.prod(shape[1:4]), shape[-1]).onchip \
            else "two-pass"
        log(f"  {what} ({regime}{', folded' if fold else ''}; bit-identical to the unfused "
            f"sequence and on a rerun): {ms!r} ms, C entry alone {alone!r} ms, unfused {unf!r} "
            f"ms, plain {pl!r} ms, bound {row['bound_ms']!r} ms")
        calls = {name: tails[name].get((shape, raw), 0) for name in tails}
        for name, n in calls.items():
            if n:
                tallies[name].add(err, n, ms, pl, 3 * nbytes(a), 0)
                extra[name]["unfused_ms"] += n * unf
                extra[name]["alone_ms"] += n * alone
                extra[name]["calls"] += n
        sites.append({"x": list(shape), "raw": raw, "fold": fold, "regime": regime,
                      "calls": calls, **row, "unfused_ms": unf, "kernel_alone_ms": alone})
        del a, r
    out = {}
    for name in tails:
        out[name] = {**tallies[name].row(), **extra[name]}
        log(f"  instance_norm tails per {name} chunk ({extra[name]['calls']} calls): fused "
            f"{out[name]['ms']!r} ms, unfused {out[name]['unfused_ms']!r} ms, bound "
            f"{out[name]['bound_ms']!r} ms")
    return {"chunks": out, "sites": sites}


def winograd_rows(randn, nbytes):
    """K9: the plain entry at the ResNet stage-1 conv2, (4,48,48,96,32) -> 32,
    8 calls per chunk (the row); the fused entry (affine + LeakyReLU in, IN
    sums out) at (4,96,96,96,32) -> 32, checked and timed beside it, its
    sums bit-identical across two runs. Both against their plain versions
    and against cuDNN ``F.conv3d`` on the same (affine'd) input."""
    import torch

    from hybrid_ctunet_tpu_torch.ops import winograd

    bf = torch.bfloat16

    def flops(x, w, fused=False):
        """(bf16, fp32) FLOP of the F(2,3)^3 conv: per 2^3-output tile, 64
        products of C by F on the tensor cores; in fp32 the separable
        transforms, 192 adds per tile and channel for B^T d B and 112 per
        tile and feature for A^T m A, and G g G^T on the filter; fused, 3
        per input element (affine, LeakyReLU) and 3 per output (the sums)."""
        C, Fo, tiles = x.shape[-1], w.shape[0], x[..., 0].numel() // 8
        fp32 = tiles * (192 * C + 112 * Fo) + 2 * 64 * 27 * C * Fo
        if fused:
            fp32 += 3 * x.numel() + 3 * x[..., 0].numel() * Fo
        return 2 * 64 * C * Fo * tiles, fp32

    def check_cudnn(name, got, want):
        rel = errors(got, want)[1]
        log(f"  {name} vs cuDNN F.conv3d: rel_l2 {rel!r} (bound {BF16_REL_L2})")
        if rel > BF16_REL_L2:
            raise AssertionError(f"{name}: kernel disagrees with cuDNN")

    x = randn(CHUNK, 48, 48, 96, 32, dtype=bf)
    w = randn(32, 32, 3, 3, 3, std=(2.0 / (27 * 32)) ** 0.5).to(bf)
    got = winograd.conv3x3_winograd(x, w)
    err = check_bf16("conv3x3_winograd (4,48,48,96,32)->32", got,
                     winograd.reference_conv3x3_winograd(x, w))
    check_cudnn("conv3x3_winograd", got, winograd.direct_conv3x3(x, w))
    ms = cuda_time_ms(lambda: winograd.conv3x3_winograd(x, w))
    plain = cuda_time_ms(lambda: winograd.reference_conv3x3_winograd(x, w))
    lib = cuda_time_ms(lambda: winograd.direct_conv3x3(x, w))
    log(f"  conv3x3_winograd: {ms!r} ms, plain {plain!r} ms, cuDNN {lib!r} ms per call")
    t = Tally(library=True)
    mm, fp32 = flops(x, w)
    t.add(err, 8, ms, plain, nbytes(x, w, got), mm, lib, fp32_flops=fp32)
    row = t.row()
    del x, got

    x = randn(CHUNK, 96, 96, 96, 32, dtype=bf, std=2.0, mean=0.5)
    scale, bias = 1.0 + randn(CHUNK, 32, std=0.1), randn(CHUNK, 32, std=0.1)
    run = lambda: winograd.conv3x3_winograd_fused(x, w, (scale, bias), in_act=True,
                                                  emit_stats=True)
    plain_fn = lambda: winograd.reference_conv3x3_winograd_fused(x, w, scale, bias, True, True)
    lib_fn = lambda: winograd.direct_conv3x3(winograd.apply_affine(x, scale, bias, True), w)
    y, s1, s2 = run()
    py, ps1, ps2 = plain_fn()
    ferr = check_bf16("conv3x3_winograd_fused (4,96,96,96,32)->32 y", y, py)
    for name, a, b in (("s1", s1, ps1), ("s2", s2, ps2)):
        rel = errors(a, b)[1]
        log(f"  conv3x3_winograd_fused {name}: rel_l2 {rel!r} (bound {BF16_REL_L2})")
        if rel > BF16_REL_L2:
            raise AssertionError(f"conv3x3_winograd_fused {name} disagrees with its plain version")
    check_cudnn("conv3x3_winograd_fused y", y, lib_fn())
    again = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((y, s1, s2), again)):
        raise AssertionError("conv3x3_winograd_fused: a rerun is not bit-identical")
    log("  conv3x3_winograd_fused: rerun bit-identical (y, s1, s2)")
    del py, ps1, ps2, again
    fms, fplain, flib = cuda_time_ms(run), cuda_time_ms(plain_fn), cuda_time_ms(lib_fn)
    log(f"  conv3x3_winograd_fused: {fms!r} ms, plain {fplain!r} ms, cuDNN (+ affine) {flib!r} ms")
    f = Tally(library=True)
    mm, fp32 = flops(x, w, fused=True)
    f.add(ferr, 1, fms, fplain, nbytes(x, w, scale, bias, y, s1, s2), mm, flib, fp32_flops=fp32)
    row["fused"] = {"shape": [CHUNK, 96, 96, 96, 32], **f.row()}
    return row


def conv3x3_rows(randn, nbytes):
    """K10 at each conv site of a Swin-UNETR chunk that its gate takes (eight
    calls, recorded from a meta forward at 96^3): per site the wrapper, the C
    entry alone (``conv3x3.conv3x3_call``), the plain path (``F.conv3d`` as
    ``conv3d_same`` calls it), the library yardstick (the same call with
    ``torch.backends.cudnn.benchmark`` set around its timing alone: the port
    never sets it), the bound, the largest difference from the plain path
    and a rerun bit for bit; then the kernel once at the TUNet's C 64 96^3
    input (not gated, for the record) beside cuDNN's 64 -> 64 and 64 -> 48
    convs there."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.models import SwinUNETR
    from hybrid_ctunet_tpu_torch.ops import conv3x3

    bf = torch.bfloat16
    sites = record_conv_sites(SwinUNETR(dtype=bf, device="meta"),
                              torch.empty(CHUNK, *bench.ROI, 1, device="meta"))
    gated = {(x, w): n for (x, w, s), n in sorted(sites.items())
             if conv3x3.supports(x, w, s, bf, torch.device("cuda"))}
    if sum(gated.values()) != 8:
        raise AssertionError(f"K10's gate takes {gated} of a Swin-UNETR chunk's convs, not 8")

    def library_ms(fn):
        saved = torch.backends.cudnn.benchmark
        torch.backends.cudnn.benchmark = True
        try:
            return cuda_time_ms(fn)
        finally:
            torch.backends.cudnn.benchmark = saved

    t = Tally(library=True)
    rows, alone_sum, flops_sum = [], 0.0, 0
    for (xs, ws), calls in gated.items():
        cin = xs[-1]
        x = randn(*xs, dtype=bf)
        w = randn(*ws, std=(2.0 / (27 * cin)) ** 0.5).to(bf)  # as Conv3d hands it over
        got = conv3x3.conv3x3(x, w)
        want = conv3x3.reference_conv3x3(x, w)
        err = check_bf16(f"conv3x3 {xs} -> 48", got, want)
        if not torch.equal(got, conv3x3.conv3x3(x, w)):
            raise AssertionError(f"conv3x3 {xs}: a rerun is not bit-identical")
        ms = cuda_time_ms(lambda: conv3x3.conv3x3(x, w))
        fn, args, _, keep = conv3x3.conv3x3_call(x, w)
        alone = cuda_time_ms(lambda: fn(*args))  # the C entry on bound arguments
        plain = cuda_time_ms(lambda: conv3x3.reference_conv3x3(x, w))
        lib = library_ms(lambda: conv3x3.reference_conv3x3(x, w))
        flops = 2 * 27 * cin * 48 * got[..., 0].numel()
        site = Tally(library=True)
        for tally in (t, site):
            tally.add(err, calls, ms, plain, nbytes(x, w, got), flops, lib)
        bound = site.bound_ms / calls
        log(f"  conv3x3 {xs} x{calls} (rerun bit-identical): {ms!r} ms, kernel alone {alone!r} ms, "
            f"plain {plain!r} ms, cudnn.benchmark {lib!r} ms, bound {bound!r} ms "
            f"({100 * bound / ms:.1f}%), max diff from plain {err!r}")
        rows.append({"x": list(xs), "calls": calls, **site.row(), "kernel_alone_ms": alone,
                     "max_diff_vs_plain": err})
        alone_sum += calls * alone
        flops_sum += calls * flops
        del keep
    row = {**t.row(), "kernel_alone_ms": alone_sum, "sites": rows,
           "bf16_peak_share": flops_sum / BF16_FLOP_PER_S / (t.ms / 1e3)}
    log(f"  conv3x3 a Swin-UNETR chunk: {t.ms!r} ms ({100 * row['bf16_peak_share']:.1f}% of "
        f"bf16 peak), plain {t.plain_ms!r} ms, cudnn.benchmark {t.library_ms!r} ms, bound "
        f"{t.bound_ms!r} ms")
    del x, w, got, want

    x = randn(CHUNK, *bench.ROI, 64, dtype=bf)
    w48, w64 = (randn(f, 64, 3, 3, 3, std=(2.0 / (27 * 64)) ** 0.5).to(bf) for f in (48, 64))
    fn, args, _, keep = conv3x3.conv3x3_call(x, w48)
    c64 = {"kernel_48_ms": cuda_time_ms(lambda: fn(*args)),
           "cudnn_48_ms": cuda_time_ms(lambda: conv3x3.reference_conv3x3(x, w48)),
           "cudnn_64_ms": cuda_time_ms(lambda: conv3x3.reference_conv3x3(x, w64))}
    flops48 = 2 * 27 * 64 * 48 * x[..., 0].numel()
    c64["kernel_48_tflops"] = flops48 / c64["kernel_48_ms"] / 1e9
    c64["cudnn_64_tflops"] = flops48 * 64 / 48 / c64["cudnn_64_ms"] / 1e9
    log(f"  conv3x3 at the TUNet's C 64 96^3 input (not gated): {c64!r}")
    row["tunet_c64"] = c64
    del keep, x
    return row


def tree_launches(model, res_only: bool = False, training: bool = False, remat: bool = False):
    """Kernel launches per chunk that the module tree of a TUNet, CTUNet or
    CUNet forward implies (CTUNet ``res_only``: the ensemble's predictor).
    Every InstanceNorm site (``ConvNorm`` of kind instance: ResBlocks,
    Bottlenecks, the ResNet stem) is K8, a BatchNorm site none; stages 0-2
    of the attention pyramid run two window attentions (K2) and a shuffle
    (K5) each, their FFNs K3 where hidden <= 1024 (stage 2; the wider
    ViT-side stages 0-1 stay plain, as in the JAX package), stage 3 the FFN
    pair (K4) and a shuffle; each transposed conv is K6, each pixelweight
    fusion K7; each 3^3 stride-1 conv of a 32-wide bottleneck (the ResNet's
    stage 1) K9; the engine's scatter (K1) runs once a chunk. ``training``:
    a train-mode forward, where a window attention, FFN or fusion whose
    dropout rate is > 0 takes its plain version (and stage 3 its two FFNs
    unfused), so launches no kernel. ``remat`` (with ``training``): the
    blocks that ``models.layers.maybe_remat`` wraps (every ResBlock, every
    ViT block, each ResNet stage's bottlenecks after the first) run their
    forward again in the backward, so their K8 and K9 sites launch twice a
    step (a ViT block launches no kernel: its attention is plain and its
    3072-wide FFN lies outside K3's gate). Each residual tail (a ResBlock's
    or Bottleneck's last norm, add and LeakyReLU) is one K8 call, counted
    on ``instance_norm.residual`` too; where it folds its projection's norm
    in (``ops.norm.folds`` at the tail's shape, from a meta forward of a
    4-window chunk of ``bench.ROI``) the two norms are one K8 record."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.models import CTUNet, CUNet, SwinUNETR
    from hybrid_ctunet_tpu_torch.models import layers, vit3d
    from hybrid_ctunet_tpu_torch.ops import norm

    if isinstance(model, SwinUNETR):
        return swin_tree_launches(model, training, remat)

    def dropping(site):
        return training and site.rate > 0

    def count(mods, cls, site=None):
        return sum(isinstance(m, cls) and not (site and dropping(site(m)))
                   for mod in mods for m in mod.modules())

    def norms(mods):
        return sum(isinstance(m, layers.ConvNorm) and m.kind == "instance"
                   for mod in mods for m in mod.modules())

    x = torch.empty(CHUNK, *bench.ROI, 1, device="meta")
    _, tails = record_norm_sites(model, x, **({"res_only": True} if res_only else {}))

    def add_tails(inside=None):
        mine = [(shape, raw) for n, shape, raw in tails if inside is None or id(n) in inside]
        got["instance_norm.residual"] += len(mine)
        got["instance_norm"] -= sum(raw and norm.folds(shape) for shape, raw in mine)

    got = {"scatter_add_windows": 1, "window_attention": 0, "ffn": 0, "ffn_pair": 0,
           "pixel_shuffle_linear": 0, "transp_conv_kxs": 0, "pixelweight": 0,
           "instance_norm": 0, "conv3x3_winograd": 0, "conv3x3": 0,
           "instance_norm.residual": 0}
    if not isinstance(model, CUNet):
        stages = list(model.vit_encoder.layers[:3 if res_only else 4])
        got["window_attention"] = count(stages, layers.MultiAxisWindowAttention,
                                        lambda m: m.drop_attn)
        got["ffn"] = sum(1 for s in stages[:3] for m in s.modules()
                         if isinstance(m, layers.FeedForward) and not dropping(m.net[3])
                         and m.net[1].weight.shape[0] <= 1024)
        got["ffn_pair"] = int(len(stages) == 4 and not dropping(stages[3][0][1].fn.net[3]))
        got["pixel_shuffle_linear"] = count(stages, layers.PixelShuffleLinear)
        if not res_only:
            got["instance_norm"] += norms([model.vit_encoder0, model.vit_decoder0])
    if isinstance(model, (CTUNet, CUNet)):
        dec = [getattr(model, f"res_decoder{k}") for k in range(4)]
        got["transp_conv_kxs"] = count(dec, layers.ConvTranspose3d)
        got["pixelweight"] = count(dec, layers.PixelweightFusion, lambda m: m.drop_attn)
        got["instance_norm"] += norms([model.convnet, *dec])  # stem + blocks
        # K9: the stride-1 3^3 conv2 of the 32-wide (stage-1) bottlenecks
        got["conv3x3_winograd"] = winograd_sites(model.convnet.modules())
    add_tails()
    if training and remat:
        wrapped = [m for m in model.modules()
                   if isinstance(m, (layers.ResBlock, vit3d.TransformerBlock))]
        if isinstance(model, (CTUNet, CUNet)):
            stages = (getattr(model.convnet, f"layer{s}") for s in range(1, 5))
            wrapped += [b for stage in stages for b in list(stage)[1:]]
        got["instance_norm"] += norms(wrapped)
        add_tails({id(m) for w in wrapped for m in w.modules()})
        got["conv3x3_winograd"] += winograd_sites(m for w in wrapped for m in w.modules())
    return got


def counted_launches():
    """The launch counters: each kernel's, and K8's residual tails
    (``instance_norm.residual``)."""
    from hybrid_ctunet_tpu_torch import kernels

    return {**kernels.launch_counts(), "instance_norm.residual": kernels.residual_launches()}


def winograd_sites(mods):
    """K9's sites among ``mods``: the stride-1 3^3 conv2 of a 32-wide
    (ResNet stage-1) bottleneck."""
    from hybrid_ctunet_tpu_torch.models import resnet3d

    return sum(isinstance(m, resnet3d.Bottleneck) and m.conv2.conv.weight.shape[1] == 32
               and m.conv2.stride == (1, 1, 1) for m in mods)


def check_launches(what, counts, per_chunk_and_chunks):
    """counts == sum over (per-chunk dict, chunks) of per-chunk * chunks."""
    want = collections.Counter()
    for per_chunk, chunks in per_chunk_and_chunks:
        for k, v in per_chunk.items():
            want[k] += v * chunks
    want = {k: want[k] for k in counts}
    log(f"  {what} launches {counts}")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts} differ from the module tree's {want}")


def per_call_checks():
    """Context: every kernel wrapper also runs its plain version on the same
    inputs and holds the two to the bf16 tolerance; yields {site: worst
    rel L2}. The model's own activations, not random tensors, reach each
    kernel."""
    import contextlib

    import torch.nn.functional as F

    from hybrid_ctunet_tpu_torch.ops import (attention, conv3x3, ffn, norm, pixelweight, shuffle,
                                             winograd)

    def plain_ffn(x, *p, residual=False):
        out = ffn.reference_ffn(x, *p)
        return x + out if residual else out

    def plain_tail(a, r, r_raw=False, eps=1e-5, negative_slope=0.01):
        res = norm.reference_instance_norm(r, eps) if r_raw else r
        return F.leaky_relu(norm.reference_instance_norm(a, eps) + res, negative_slope)

    plains = (
        (attention, "window_attention", attention.reference_window_attention_table),
        (ffn, "ffn", plain_ffn),
        (ffn, "ffn_pair", ffn.reference_ffn_pair),
        (shuffle, "pixel_shuffle_linear", shuffle.reference_shuffle),
        (shuffle, "transp_conv_kxs", shuffle.reference_transp_conv),
        (pixelweight, "pixelweight", pixelweight.reference_pixelweight),
        (norm, "instance_norm", norm.reference_instance_norm),
        (norm, "instance_norm_leaky",
         lambda x, eps=1e-5, negative_slope=0.01: F.leaky_relu(
             norm.reference_instance_norm(x, eps), negative_slope)),
        (norm, "instance_norm_add_leaky", plain_tail),
        (winograd, "conv3x3_winograd", winograd.reference_conv3x3_winograd),
        (conv3x3, "conv3x3", conv3x3.reference_conv3x3),
    )

    @contextlib.contextmanager
    def ctx():
        worst = {}
        saved = [(m, n, getattr(m, n)) for m, n, _ in plains]

        def checked(name, kernel, plain):
            def f(*args, **kw):
                out = kernel(*args, **kw)
                want = plain(*args, **kw)
                max_abs, rel_l2 = errors(out, want)
                site = f"{name} {tuple(args[0].shape)}"
                worst[site] = max(worst.get(site, 0.0), rel_l2)
                if not (max_abs <= BF16_MAX_ABS_FRACTION * want.float().abs().max().item()
                        and rel_l2 <= BF16_REL_L2):
                    raise AssertionError(f"{site}: kernel disagrees with its plain version on "
                                         f"the model's activations ({max_abs!r}, {rel_l2!r})")
                return out

            f.launches = getattr(kernel, "launches", 0)  # the wrappers count on their module name
            for counter in ("residual_launches", "launches_48", "windows", "masked_windows"):
                if hasattr(kernel, counter):
                    setattr(f, counter, getattr(kernel, counter))
            return f

        for (m, n, plain), (_, _, kernel) in zip(plains, saved):
            setattr(m, n, checked(n, kernel, plain))
        try:
            yield worst
        finally:
            for m, n, kernel in saved:
                setattr(m, n, kernel)

    return ctx()


ARGMAX_AGREEMENT = 0.995  # C6: voxels whose class the kernels and the plain model agree on


def model_check(name, forward, device, chaotic: bool = False, x=None, held: bool = True):
    """One 4-window batch through the bf16 model: every kernel call held to
    its plain version on the model's own activations, then the output with
    the kernels against the same model on their plain versions (the gates
    turned off), beside the plain model's response to a one-ulp perturbation
    of its bf16 input. ``chaotic``: the random-weight model amplifies
    rounding differences to O(1) (the ResNet-101 encoder of CTUNet does),
    so the end-to-end bound is 1.5x that response instead of
    MODEL_REL_L2. ``x``: the windows (bf16); a standard-normal chunk by
    default. With ``x`` given (trained weights, their own data) the argmax
    agreement is held to ``ARGMAX_AGREEMENT`` too. ``held`` False: the
    numbers are logged and returned, no bound is applied."""
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench

    own = x is not None
    if not own:
        x = bench.make_volume(SEED + 7, (CHUNK, *bench.ROI), device)[0].to(torch.bfloat16)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 8)
    sign = torch.randint(0, 2, x.shape, generator=gen, device=device) * 2 - 1
    x_ulp = (x.float() * (1 + 2.0 ** -8 * sign)).to(torch.bfloat16)  # one bf16 ulp
    with torch.inference_mode():
        with per_call_checks() as worst:
            got = forward(x)
        with kernels.gates_off():
            want = forward(x)
            moved = forward(x_ulp)
    torch.cuda.synchronize()
    log(f"  {name}, per-call rel_l2 vs plain on the model's activations (bound {BF16_REL_L2}): "
        f"worst {max(worst.values())!r} over {len(worst)} sites")
    max_abs, rel_l2 = errors(got, want)
    sensitivity = errors(moved, want)[1]
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    bound = 1.5 * sensitivity if chaotic else MODEL_REL_L2
    log(f"  {name}, 4 windows, kernels vs plain: max_abs_err {max_abs!r} rel_l2 {rel_l2!r} "
        f"(bound {bound!r}) argmax agreement {agree!r}; plain model vs a one-ulp input "
        f"perturbation: rel_l2 {sensitivity!r}")
    if held and (not torch.isfinite(got.float()).all() or rel_l2 > bound or (
            own and agree < ARGMAX_AGREEMENT)):
        raise AssertionError(f"{name} with kernels disagrees with the plain model")
    return {"max_abs_err": max_abs, "rel_l2": rel_l2, "bound": bound, "argmax_agreement": agree,
            "one_ulp_sensitivity_rel_l2": sensitivity,
            "per_call_worst_rel_l2": max(worst.values())}


def check_map(name, logits):
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench

    want_shape = (1, *bench.VOLUME_SHAPE, bench.OUT_CHANNELS)
    if tuple(logits.shape) != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"{name}: {tuple(logits.shape)} (want {want_shape}) or non-finite")
    log(f"  {name}: mean {logits.mean().item()!r} std {logits.std().item()!r}")


def check_mask(mask):
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench

    if tuple(mask.shape) != (1, *bench.VOLUME_SHAPE) or mask.min() < 0 \
            or mask.max() >= bench.OUT_CHANNELS:
        raise AssertionError("argmax mask out of range")
    log(f"  mask classes {torch.bincount(mask.flatten(), minlength=bench.OUT_CHANNELS).tolist()}")


def n_chunks(engine):
    from hybrid_ctunet_tpu_torch.cli import bench

    n = len(engine.plan(bench.VOLUME_SHAPE)[3])
    return n, -(-n // engine.sw_batch_size)


def phase_tunet(device, work):
    """The TUNet slice (phase 4); the TUNet is then saved as
    ``work/tunet/model_vit.pt`` (the reference's checkpoint format,
    ``train/checkpoint.py::save_checkpoint``) for phase 7."""
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.train.checkpoint import save_checkpoint
    from hybrid_ctunet_tpu_torch.train.state import make_optimizer

    t0 = time.perf_counter()
    model = bench.build_tunet(SEED, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  TUNet params {n_params} (built in {time.perf_counter() - t0:.3f} s)")
    if n_params != 109_904_124:
        raise AssertionError(f"TUNet has {n_params} params, expected 109904124")
    engine = bench.make_engine(model)
    volume = bench.make_volume(SEED, bench.VOLUME_SHAPE, device)
    n_windows, chunks = n_chunks(engine)
    log(f"  volume {bench.VOLUME_SHAPE}, roi {bench.ROI}, overlap {bench.OVERLAP}: "
        f"{n_windows} windows, {chunks} chunks")
    if n_windows != 147:
        raise AssertionError(f"{n_windows} windows, expected 147")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    logits, mask = bench.segment(engine, volume)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    counts = counted_launches()
    log(f"  first volume (warm-up) {first!r} s")
    check_launches("TUNet volume", counts, [(tree_launches(model), chunks)])
    check_map("TUNet logits", logits)
    check_mask(mask)
    del logits, mask

    model_check("TUNet", lambda x: model(x)[0], device)
    path = save_checkpoint(os.path.join(work, "tunet"), "model_vit.pt", model,
                           make_optimizer(model.parameters()), epoch=0, best_acc=0.0)
    log(f"  saved {path}")
    return model, engine, volume


def phase_hybrid(tunet, tu_engine, volume, device):
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench

    t0 = time.perf_counter()
    ctunet = bench.build_ctunet(SEED, device)
    n_params = sum(p.numel() for p in ctunet.parameters())
    log(f"  CTUNet params {n_params} (built in {time.perf_counter() - t0:.3f} s)")
    if n_params != 174_109_542:
        raise AssertionError(f"CTUNet has {n_params} params, expected 174109542")
    ct_engine = bench.make_ctunet_engine(ctunet)
    ct_windows, ct_chunks = n_chunks(ct_engine)
    tu_windows, tu_chunks = n_chunks(tu_engine)
    log(f"  CTUNet overlap {bench.CT_OVERLAP}: {ct_windows} windows, {ct_chunks} chunks; "
        f"TUNet overlap {bench.OVERLAP}: {tu_windows} windows, {tu_chunks} chunks")
    if (ct_windows, tu_windows) != (50, 147):
        raise AssertionError(f"{ct_windows}/{tu_windows} windows, expected 50/147")
    ct_tree = tree_launches(ctunet, res_only=True)
    log(f"  CTUNet res-only launches per chunk (module tree) {ct_tree}")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res_map, tu_map, prob, mask = bench.segment_hybrid(ct_engine, tu_engine, volume)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    hybrid_counts = counted_launches()
    log(f"  first hybrid volume (warm-up) {first!r} s")
    check_launches("hybrid volume", hybrid_counts,
                   [(ct_tree, ct_chunks), (tree_launches(tunet), tu_chunks)])
    check_map("CTUNet res map", res_map)
    check_map("TUNet map", tu_map)
    if not torch.isfinite(prob).all() or not torch.allclose(
            prob.sum(-1), torch.ones((), device=device), atol=1e-4):
        raise AssertionError("ensemble probabilities are not finite distributions")
    check_mask(mask)
    del res_map, tu_map, prob, mask

    model_check("CTUNet res head", lambda x: ctunet(x, res_only=True), device, chaotic=True)
    del ctunet, ct_engine
    torch.cuda.empty_cache()

    # full-width CUNet, one 4-window batch
    from hybrid_ctunet_tpu_torch.models import CUNet
    from hybrid_ctunet_tpu_torch.utils.params import random_init_

    cunet = random_init_(CUNet(bench.OUT_CHANNELS, 101, dtype=torch.bfloat16, device=device),
                         SEED).eval()
    n_params = sum(p.numel() for p in cunet.parameters())
    log(f"  CUNet params {n_params}")
    if n_params != 50_779_754:
        raise AssertionError(f"CUNet has {n_params} params, expected 50779754")
    x = bench.make_volume(SEED + 9, (CHUNK, *bench.ROI), device)[0].to(torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        outs = cunet(x)
    torch.cuda.synchronize()
    counts = counted_launches()
    tree = tree_launches(cunet)
    tree["scatter_add_windows"] = 0  # no engine here
    check_launches("CUNet 4 windows", counts, [(tree, 1)])
    shapes = [tuple(o.shape) for o in outs]
    if shapes != [(CHUNK, 96, 96, 96, 14), (CHUNK, 48, 48, 96, 14), (CHUNK, 24, 24, 48, 14)] \
            or not all(torch.isfinite(o.float()).all() for o in outs):
        raise AssertionError(f"CUNet outputs {shapes} or non-finite")
    log(f"  CUNet outputs {shapes}, finite")
    return hybrid_counts


def grad_cases(device):
    """(name, kernel wrapper, plain path, inputs) of every kernel with a
    backward, at the training step's shapes (a 4-window batch at 96^3):
    K2 at pyramid stages 0-2, K3 at stage 2, K4 at stage 3, K5 at its
    site's width, K6 at the three UpCatConvBlock sites of CUNet (decoder 1
    also the CTUNet's), K7 at C 128, K8 at 4x96^3x64, at the deepest stage
    and at the UpCatConvBlocks' ResBlocks (with LeakyReLU and without), K9
    at the ResNet stage-1 conv2 and its fused form at 96^3, K8's residual
    tail at both plans and both residual forms. The plain path of K9 is the
    direct conv, which its backward differentiates."""
    import torch
    import torch.nn.functional as F

    from hybrid_ctunet_tpu_torch.ops import attention, ffn, norm, pixelweight, shuffle, winograd

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 20)
    bf = torch.bfloat16

    def randn(*shape, dtype=torch.float32, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=device) * std + mean).to(dtype)

    def ffn_params(c, h):
        return (1.0 + randn(c, std=0.1), randn(c, std=0.1), randn(h, c, std=c ** -0.5),
                randn(h, std=0.1), randn(c, h, std=h ** -0.5), randn(c, std=0.1))

    cases = []
    for nwin, C in ((8, 768), (64, 512), (512, 256)):
        qkv = randn(nwin, 216, 3 * C, dtype=bf)
        cases.append((f"window_attention C{C}", lambda *a: attention.window_attention(*a, 6, bf),
                      lambda *a: attention.reference_window_attention_table(*a, 6, bf),
                      (qkv[..., :C] * 32 ** -0.5, qkv[..., C:2 * C], qkv[..., 2 * C:],
                       randn(11 ** 3, C // 32))))
    cases.append(("ffn", lambda x, *p: ffn.ffn(x, *p, bf, residual=True),
                  lambda x, *p: x + ffn.reference_ffn(x, *p, bf),
                  (randn(CHUNK, 24, 24, 48, 256, dtype=bf), *ffn_params(256, 1024))))
    cases.append(("ffn_pair", lambda x, *p: ffn.ffn_pair(x, p[:6], p[6:], bf),
                  lambda x, *p: ffn.reference_ffn_pair(x, p[:6], p[6:], bf),
                  (randn(CHUNK, 48, 48, 96, 128, dtype=bf), *ffn_params(128, 512),
                   *ffn_params(128, 512))))
    cases.append(("pixel_shuffle_linear", lambda *a: shuffle.pixel_shuffle_linear(*a, (2, 2, 1), bf),
                  lambda *a: shuffle.reference_shuffle(*a, (2, 2, 1), bf),
                  (randn(CHUNK, 48, 48, 96, 128, dtype=bf), randn(64, 32, std=32 ** -0.5),
                   randn(64, std=0.1))))
    # K6 at the CTUNet's decoder-1 site, then CUNet's other UpCatConvBlock sites
    for shape in ((CHUNK, 24, 24, 48, 256), (CHUNK, 6, 6, 12, 1024), (CHUNK, 12, 12, 24, 512)):
        cin = shape[-1]
        cases.append((f"transp_conv_kxs {shape}", lambda *a: shuffle.transp_conv_kxs(*a, bf),
                      lambda *a: shuffle.reference_transp_conv(*a, bf),
                      (randn(*shape, dtype=bf),
                       randn(cin, cin // 2, 2, 2, 2, std=0.03 * (256 / cin) ** 0.5))))
    C = 128
    cases.append(("pixelweight", lambda a, b, *p: pixelweight.pixelweight(a, b, p, bf),
                  lambda a, b, *p: pixelweight.reference_pixelweight(a, b, p, bf),
                  (randn(CHUNK, 48, 48, 96, C, dtype=bf), randn(CHUNK, 48, 48, 96, C, dtype=bf),
                   1.0 + randn(C, std=0.1), randn(C, std=0.1), 1.0 + randn(C, std=0.1),
                   randn(C, std=0.1), randn(3 * C, C, std=C ** -0.5),
                   randn(3 * C, C, std=C ** -0.5), randn(C, C, std=C ** -0.5))))
    # K8: the stem, the deepest stage, then the ResBlocks of CUNet's
    # UpCatConvBlocks (decoders 3, 2, 1: norm1 with LeakyReLU, norm2 and norm3
    # without)
    ups = ((CHUNK, 12, 12, 24, 512), (CHUNK, 24, 24, 48, 256), (CHUNK, 48, 48, 96, 128))
    for shape in ((CHUNK, 96, 96, 96, 64), (CHUNK, 6, 6, 12, 1024), *ups):
        cases.append((f"instance_norm_leaky {shape}", norm.instance_norm_leaky,
                      lambda x: F.leaky_relu(norm.reference_instance_norm(x), 0.01),
                      (randn(*shape, dtype=bf, std=2.0, mean=0.5),)))
    for shape in ups[::-1]:
        cases.append((f"instance_norm {shape}", norm.instance_norm, norm.reference_instance_norm,
                      (randn(*shape, dtype=bf, std=2.0, mean=0.5),)))
    # the residual tails: the TUNet's folded 96^3 ResBlocks, a folded and an
    # identity bottleneck of stage 1, and both forms on chip (stage 3)
    for shape, raw in (((CHUNK, 96, 96, 96, 64), True), ((CHUNK, 48, 48, 96, 128), True),
                       ((CHUNK, 48, 48, 96, 128), False), ((CHUNK, 12, 12, 24, 512), True),
                       ((CHUNK, 12, 12, 24, 512), False)):
        def plain_tail(a, r, raw=raw):
            res = norm.reference_instance_norm(r) if raw else r
            return F.leaky_relu(norm.reference_instance_norm(a) + res, 0.01)

        cases.append((f"instance_norm_add_leaky {shape} raw={raw}",
                      lambda a, r, raw=raw: norm.instance_norm_add_leaky(a, r, raw), plain_tail,
                      (randn(*shape, dtype=bf, std=2.0, mean=0.5),
                       randn(*shape, dtype=bf, std=2.0, mean=0.5 if raw else 0.0))))
    w = randn(32, 32, 3, 3, 3, std=(2.0 / (27 * 32)) ** 0.5)
    cases.append(("conv3x3_winograd", winograd.conv3x3_winograd, winograd.direct_conv3x3,
                  (randn(CHUNK, 48, 48, 96, 32, dtype=bf), w.to(bf))))
    cases.append(("conv3x3_winograd_fused",
                  lambda x, w, sc, bi: winograd.conv3x3_winograd_fused(
                      x, w, (sc, bi), in_act=True, emit_stats=True),
                  lambda x, w, sc, bi: winograd.direct_conv3x3_fused(x, w, sc, bi, True, True),
                  (randn(CHUNK, 96, 96, 96, 32, dtype=bf), w.to(bf),
                   1.0 + randn(CHUNK, 32, std=0.1), randn(CHUNK, 32, std=0.1))))
    return cases


def phase_train_grads(device):
    """Each kernel's autograd.Function against its plain path's own
    backward on the same inputs and output gradient: relative L2 <= 1e-6
    (the backward recomputes through the plain path, so they are equal; cuDNN
    is set deterministic for K9's direct conv)."""
    import torch

    def grads(fn, inputs, seed):
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = sum((o.float() * torch.randn(o.shape, generator=gen, device=device)).sum()
                   for o in outs)
        return torch.autograd.grad(loss, leaves)

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    worst = {}
    try:
        for name, kernel_fn, plain_fn, inputs in grad_cases(device):
            got = grads(kernel_fn, inputs, SEED + 21)
            want = grads(plain_fn, inputs, SEED + 21)
            rel = max(errors(g, w)[1] for g, w in zip(got, want))
            worst[name] = rel
            log(f"  {name}: {len(got)} gradients, worst rel_l2 vs the plain backward {rel!r}")
            if not rel <= 1e-6:
                raise AssertionError(f"{name}: gradient differs from the plain path's")
            del got, want
    finally:
        torch.backends.cudnn.deterministic = saved
    torch.cuda.empty_cache()
    return worst


PARAMS = {"ctunet": CTUNET_PARAMS, "tunet": 109_904_124, "cunet": 50_779_754,
          "swin_unetr": 62_187_296}


def train_args(extra=(), model_name: str = "ctunet"):
    """The arguments of main_CTUNet.py (``model_name`` "ctunet") or of
    main_C_TUNet.py with ``--model_name tunet | cunet`` for the slice:
    ResNet-101, pf 8, the CLI defaults otherwise (ROI 96^3, batch 1 x 4
    crops, AMP -> bf16, AdamW)."""
    from hybrid_ctunet_tpu_torch.cli.args import build_train_parser

    if model_name == "ctunet":
        return build_train_parser("ctunet").parse_args(
            ["--model_depths", "101", "--patch_frame", "8", *extra])
    return build_train_parser("c_tunet").parse_args(
        ["--model_depths", "101", "--patch_frame", "8", "--model_name", model_name, *extra])


def build_train(device, extra=(), steps: int = 4, model_name: str = "ctunet"):
    """The full-width model of ``train_args(extra, model_name)`` on the card,
    its train step, the LR of epoch 1 and the module tree's launches per
    step with remat on and off, with the ``--synthetic`` batches
    (batch_size x 4 crops of 96^3 each) of enough epochs for ``steps``
    steps."""
    import tempfile

    from hybrid_ctunet_tpu_torch.cli import factory
    from hybrid_ctunet_tpu_torch.data.loader import get_loader
    from hybrid_ctunet_tpu_torch.data.synthetic import write_synthetic_dataset
    from hybrid_ctunet_tpu_torch.train.schedule import make_epoch_schedule
    from hybrid_ctunet_tpu_torch.train.steps import make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        args = train_args(["--synthetic", "--data_dir", tmp, *extra], model_name)
        args.model_name = model_name
        args.json_list = os.path.basename(write_synthetic_dataset(
            tmp, n_classes=args.out_channels))
        loader, _ = get_loader(args)
        batches = []
        epoch = 0
        while len(batches) < steps:
            loader.set_epoch(epoch)
            batches += list(loader)
            epoch += 1
    model = factory.build_model(args, device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {type(model).__name__} params {n_params}, batch {args.batch_size} x 4 crops of "
        f"{(args.roi_x, args.roi_y, args.roi_z)}, {factory.model_dtype(args)} compute, "
        f"{args.optim_name}{', ' + ' '.join(extra) if extra else ''}")
    if n_params != PARAMS[model_name] + 2 * sum(  # BatchNorm: a weight and a bias a channel
            m.weight.numel() for m in model.modules() if getattr(m, "kind", "") == "batch"):
        raise AssertionError(f"{model_name} has {n_params} params, expected "
                             f"{PARAMS[model_name]} + BatchNorm")
    step = make_train_step(model_name, model, factory.build_optimizer(args, model),
                           smooth_nr=args.smooth_nr, smooth_dr=args.smooth_dr)
    lr = make_epoch_schedule(args.lrschedule, base_lr=args.optim_lr,
                             warmup_epochs=args.warmup_epochs, max_epochs=args.max_epochs)(1)
    trees = {}
    for remat in (True, False):
        trees[remat] = tree_launches(model, training=True, remat=remat)
        trees[remat]["scatter_add_windows"] = 0  # no engine in a train step
    return model, step, lr, trees, batches


def run_steps(step, lr, trees, batches, device, remats=(True, False)):
    """For each setting of ``remats`` (block remat on, off) one warm-up step,
    then one checked step of each: launches equal to ``trees[remat]`` and a
    finite loss at every step, and the checked step's peak memory (reset
    before it). Returns the numbers of each setting (the first's at the top
    level, the others under ``"no_remat"``) and the last batch on the
    card."""
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.models.layers import remat_blocks

    runs = {r: {"losses": []} for r in remats}
    for i, remat in enumerate(list(remats) * 2):
        image, label = batches[i % len(batches)]
        x = torch.from_numpy(image).to(device)
        y = torch.from_numpy(label).to(device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with remat_blocks(remat):
            metrics = step(x, y, lr)
        loss = metrics["loss"].item()
        counts = counted_launches()
        peak = torch.cuda.max_memory_allocated()
        warm = i < len(remats)
        aux = ", ".join(f"{k} {v.item()!r}" for k, v in metrics.items() if k != "loss")
        log(f"  step {i} remat {'on' if remat else 'off'}{' (warm-up)' if warm else ''}: "
            f"peak {peak} B, loss {loss!r}{f' ({aux})' if aux else ''}")
        if not math.isfinite(loss):
            raise AssertionError(f"step {i}: loss {loss}")
        check_launches(f"train step {i} (remat {'on' if remat else 'off'})", counts,
                       [(trees[remat], 1)])
        run = runs[remat]
        run["losses"].append(loss)
        run["launches_per_step"] = counts
        run["peak_mem_bytes"] = peak
    first, *rest = remats
    if rest:
        runs[first]["no_remat"] = runs[rest[0]]
    return runs[first], (x, y)


def remat_check(name, model, step, x, y):
    """One step from the same weights, buffers and dropout seed with block
    remat on, off, and off again (AdamW at lr 0 leaves the parameters where
    they are and the gradients in ``.grad``; cuDNN set deterministic): every
    parameter's gradient with remat against without, relative L2 <= 1e-6
    (the second run without remat gives the floor beside it), and every
    buffer (BatchNorm's running statistics) equal after the step."""
    import torch

    from hybrid_ctunet_tpu_torch.models.layers import remat_blocks

    params = [p for p in model.parameters() if p.requires_grad]
    buffers0 = {k: b.clone() for k, b in model.named_buffers()}
    start = step.step
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for remat in (True, False, False):
            with torch.no_grad():
                for k, b in model.named_buffers():
                    b.copy_(buffers0[k])
            step.step = start
            with remat_blocks(remat):
                step(x, y, 0.0)
            runs.append(([p.grad.clone() for p in params],
                         {k: b.clone() for k, b in model.named_buffers()}))
    finally:
        torch.backends.cudnn.deterministic = saved
    (g_on, b_on), (g_off, b_off), (g_off2, _) = runs
    worst = max(errors(a, b)[1] for a, b in zip(g_on, g_off))
    floor = max(errors(a, b)[1] for a, b in zip(g_off2, g_off))
    identical = all(torch.equal(a, b) for a, b in zip(g_on, g_off))
    buffers_equal = all(torch.equal(b_on[k], b_off[k]) for k in b_off)
    moved = sum(not torch.equal(b_off[k], v) for k, v in buffers0.items())
    log(f"  {name}: {len(params)} gradients with remat against without: worst rel_l2 {worst!r} "
        f"(bound 1e-6; bit-identical {identical}); without against without: {floor!r}; "
        f"{len(b_off)} buffers equal {buffers_equal} ({moved} moved by the step)")
    if not (worst <= 1e-6 and buffers_equal):
        raise AssertionError(f"{name}: the step with remat differs from the step without")
    del runs, g_on, g_off, g_off2
    return {"grad_worst_rel_l2": worst, "grad_floor_rel_l2": floor, "bit_identical": identical,
            "buffers_equal": buffers_equal, "buffers_moved": moved}


def phase_train_steps(device):
    """The full-width CTUNet trained on --synthetic data through the port's
    train step: with block remat on (the default) and off, one warm-up step
    and one checked step each (``run_steps``), per-step launches equal to
    the module tree's for the full five-output forward (with remat, K8 and
    K9 of the wrapped blocks twice), a finite loss at every step, and the
    checked step's peak memory; one step's gradients with remat equal to those without
    (``remat_check``); then one more step under ``torch.profiler`` (its
    kernels by device time). Returns the statistics and a batch of 4
    windows of the synthetic data (C6's input)."""
    import torch

    from hybrid_ctunet_tpu_torch.utils import profiling

    model, step, lr, trees, batches = build_train(device)
    out, (x, y) = run_steps(step, lr, trees, batches, device)
    out["remat_check"] = remat_check("instance norm", model, step, x, y)
    prof = profiling.profile_device(lambda: step(x, y, lr))
    log(f"  one step under torch.profiler: wall {prof['wall_s']!r} s, kernels "
        f"{prof['kernel_ms']!r} ms, busy {prof['busy_share']!r}")
    log(json.dumps({"train_step_profile": prof}))
    del model, step
    torch.cuda.empty_cache()
    return out, x.to(torch.bfloat16)


def phase_dropout_batch2(device):
    """8a'. ``--batch_size 2 --dropout_rate 0.2`` (8 crops of 96^3 a step)
    with block remat on, which it needs to fit the card: one warm-up and
    one checked step, finite losses, launches equal to the tree's, the
    checked step's peak memory."""
    import torch

    model, step, lr, trees, batches = build_train(
        device, ["--dropout_rate", "0.2", "--batch_size", "2"], steps=2)
    if batches[0][0].shape[0] != 8:
        raise AssertionError(f"batch of {batches[0][0].shape[0]} crops, expected 8")
    out, _ = run_steps(step, lr, trees, batches, device, remats=(True,))
    del model, step
    torch.cuda.empty_cache()
    return out


def phase_train_longer(work, logs, epochs: int = C6_EPOCHS):
    """C6's weights: ``phase_train_cli``'s run resumed from its latest.pt
    (``--checkpoint``: weights, optimizer and epoch) to ``epochs`` epochs,
    with validation and latest.pt at the last. Returns its wall time."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import train_main

    argv = ["--model_depths", "101", "--patch_frame", "8", "--synthetic",
            "--max_epochs", str(epochs), "--val_every", str(epochs), "--warmup_epochs", "1",
            "--save_checkpoint", "--checkpoint", os.path.join(logs, "latest.pt"),
            "--data_dir", os.path.join(work, "train_data"), "--logdir", logs]
    log(f"  train_main {' '.join(argv)}")
    t0 = time.perf_counter()
    train_main.main("ctunet", argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    log(f"  {wall!r} s")
    return wall


def trained_check(device, logs, windows, epochs: int, held: bool):
    """The CTUNet of ``logs/latest.pt`` (which must be at ``epochs``), its
    res head (the ensemble's predictor) on ``windows`` through
    ``model_check``."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import factory
    from hybrid_ctunet_tpu_torch.train.checkpoint import load_weights

    model = factory.build_model(train_args(), device)
    ckpt = load_weights(model, os.path.join(logs, "latest.pt"))
    if ckpt["epoch"] != epochs:
        raise AssertionError(f"latest.pt: epoch {ckpt['epoch']}, expected {epochs}")
    model.eval()
    log(f"  latest.pt (epoch {epochs}), {tuple(windows.shape)} windows of the synthetic "
        f"training data{'' if held else '; not held to the bound'}")
    out = model_check(f"CTUNet res head at epoch {epochs}", lambda x: model(x, res_only=True),
                      device, x=windows, held=held)
    del model, ckpt
    torch.cuda.empty_cache()
    return out


def phase_trained_check(device, work, logs, windows, epochs: int = C6_EPOCHS):
    """C6: the whole-model check on trained weights. The two-epoch
    checkpoint of ``phase_train_cli`` first, for comparison (not held to a
    bound), then that run resumed to ``epochs`` (``phase_train_longer``):
    its res head on 4 windows of the synthetic data it was trained on,
    every kernel call held to its plain version, the output with kernels
    against the plain model at ``MODEL_REL_L2`` with argmax agreement >=
    ``ARGMAX_AGREEMENT``, the plain model's one-ulp sensitivity beside it
    (``model_check``, not chaotic)."""
    before = trained_check(device, logs, windows, 2, held=False)
    wall = phase_train_longer(work, logs, epochs)
    return {**trained_check(device, logs, windows, epochs, held=True), "epoch_2": before,
            "train_wall_s": wall}


def phase_train_cli(device, work):
    """``train_main`` end to end, as main_CTUNet.py runs it: --synthetic,
    two epochs, validation at the second, the three best-metric files and
    latest.pt, which must load back into a fresh CTUNet. Every kernel the
    CTUNet's module tree has, K1 (validation) included, launches in the
    run. The checkpoints stay in ``work/train`` for C6 and phase 7."""
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import factory, train_main
    from hybrid_ctunet_tpu_torch.train.checkpoint import load_weights

    logs = os.path.join(work, "train")
    argv = ["--model_depths", "101", "--patch_frame", "8", "--synthetic",
            "--max_epochs", "2", "--val_every", "2", "--warmup_epochs", "1",
            "--save_checkpoint", "--data_dir", os.path.join(work, "train_data"),
            "--logdir", logs]
    log(f"  train_main {' '.join(argv)}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    best = train_main.main("ctunet", argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counted_launches()
    files = sorted(os.listdir(logs))
    log(f"  {wall!r} s; best {best}; files {files}; launches {counts}")
    missing = {"model_hybrid.pt", "model_res.pt", "model_vit.pt", "latest.pt"} - set(files)
    if missing:
        raise AssertionError(f"train_main did not write {sorted(missing)}")
    fresh = factory.build_model(train_args(), device)
    if not all(counts[k] for k, v in tree_launches(fresh).items() if v):
        raise AssertionError(f"a kernel of the CTUNet was not launched in the CLI run: {counts}")
    ckpt = load_weights(fresh, os.path.join(logs, "latest.pt"))
    if ckpt["epoch"] != 2 or not all(torch.isfinite(p).all() for p in fresh.parameters()):
        raise AssertionError(f"latest.pt: epoch {ckpt['epoch']} or non-finite weights")
    log(f"  latest.pt loads into a fresh CTUNet (epoch {ckpt['epoch']}, "
        f"{len(ckpt['state_dict'])} tensors)")
    del fresh, ckpt
    torch.cuda.empty_cache()
    return {"wall_s": wall, "best": best, "launches": counts, "logs": logs}


# the eval case: native voxels at the preprocessing's target spacing, so that
# its grid is the bench's 256x256x128 and the host's inverse resample is the
# identity (at 1 x 1 x 2.5 mm, 384x384x103 voxels, the resample of two
# 14-channel maps back to the native grid took the host ~97 s a case)
EVAL_SHAPE, EVAL_SPACING = (256, 256, 128), (1.5, 1.5, 2.0)


def eval_hooks(record):
    """Context: the eval CLI's device half timed per call (``_dispatch`` up
    to its maps' arrival in host memory, with the grid and the engine's
    window count), its case pipeline timed whole, and every K1 call of an
    engine's first and trailing chunk held bit for bit to the plain version
    on the eval's own canvas and predictions (a copy of the canvas taken
    before the call). ``record``: a dict the hooks fill."""
    import contextlib

    from hybrid_ctunet_tpu_torch.cli import test_main

    def dispatch(engine, model, case):
        t0 = time.perf_counter()
        record.setdefault("first_dispatch", t0)
        _, done = handle = orig_dispatch(engine, model, case)
        done.synchronize()
        grid = tuple(case.image.shape[:3])
        n = len(engine.plan(grid)[3])
        record["device_s"].append(time.perf_counter() - t0)
        record["runs"].append((grid, n, -(-n // engine.sw_batch_size), engine.num_outputs))
        return handle

    def pipeline(cases, dispatch_fn, finish):
        t0 = time.perf_counter()
        out = orig_pipeline(cases, dispatch_fn, finish)
        record["pipeline_s"].append(time.perf_counter() - t0)
        return out

    orig_dispatch, orig_pipeline = test_main._dispatch, test_main._pipeline_cases

    @contextlib.contextmanager
    def ctx():
        test_main._dispatch, test_main._pipeline_cases = dispatch, pipeline
        try:
            with k1_checks(record["k1_checked"]):
                yield
        finally:
            test_main._dispatch, test_main._pipeline_cases = orig_dispatch, orig_pipeline

    return ctx()


def k1_checks(checked):
    """Context: every K1 call of an engine's first and trailing chunk held
    bit for bit to the plain version on the engine's own canvas and
    predictions (a copy of the canvas taken before the call); each checked
    call's window count is appended to ``checked``."""
    import contextlib

    import numpy as np
    import torch

    from hybrid_ctunet_tpu_torch.infer import sliding_window
    from hybrid_ctunet_tpu_torch.ops import scatter

    def checked_scatter(acc, pred, imp, starts):
        last = tuple(d - r for d, r in zip(acc.shape[:3], imp.shape))
        if np.any(starts[0]) and tuple(starts[-1].tolist()) != last:
            return scatter.scatter_add_windows(acc, pred, imp, starts)
        before = acc.clone()
        out = scatter.scatter_add_windows(acc, pred, imp, starts)
        want = scatter.reference_scatter_add_windows(before, pred, imp, starts)
        if not torch.equal(out, want):
            raise AssertionError(f"K1 on the chunk {starts.tolist()}: not bit-exact")
        checked.append(len(starts))
        return out

    @contextlib.contextmanager
    def ctx():
        sliding_window.scatter_add_windows = checked_scatter
        try:
            yield
        finally:
            sliding_window.scatter_add_windows = scatter.scatter_add_windows

    return ctx()


def phase_eval(work, ct_dir, tu_dir):
    """The eval CLI (``cli/test_main.py``) on one synthetic validation case
    whose preprocessed grid is the bench's 256x256x128, at full width
    (ResNet-101, pf 8, ROI 96, 14 classes, bf16): ``test_final`` with phase
    6's trained ``model_res.pt`` and phase 4's TUNet, then again with
    ``--postprocess``, then ``test_ctunet`` on phase 6's three checkpoints.
    Each run's launches equal the module tree's per chunk times its chunks,
    every engine's first and trailing K1 call is bit-exact on the eval's own
    data, the Dice and HD95 are finite, the report has its HD95 block, the
    masks load back at the case's native shape; seconds per case on the
    device (sliding window, maps to host memory) and on the host (invert,
    metrics, save) (``eval_run``). Returns the runs' numbers, with
    ``test_final``'s flags under ``"argv"`` and the case's under
    ``"common"``."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import test_main
    from hybrid_ctunet_tpu_torch.data.synthetic import write_synthetic_dataset
    from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet

    data = os.path.join(work, "eval_data")
    t0 = time.perf_counter()
    path = write_synthetic_dataset(data, n_train=0, n_val=1, shape=EVAL_SHAPE,
                                   spacing=EVAL_SPACING)
    log(f"  synthetic case {EVAL_SHAPE} written in {time.perf_counter() - t0!r} s")
    common = ["--data_dir", data, "--json_list", os.path.basename(path), "--model_depths", "101",
              "--patch_frame", "8"]
    meta = dict(out_channels=14, patch_frame=8, dtype=torch.bfloat16, device="meta")
    tree_ct = tree_launches(CTUNet(model_depth=101, **meta))
    tree_ct["scatter_add_windows"] = 2  # two canvases a chunk
    tree_ct_res = tree_launches(CTUNet(model_depth=101, **meta), res_only=True)
    tree_tu = tree_launches(TUNet(**meta))
    final = [f"--ctunet_dir={ct_dir}", f"--tunet_dir={tu_dir}"]
    runs = (  # (name, entry, exp_name, flags, the module tree of each engine run)
        ("test_final", test_main.test_final, "final", final, [tree_ct_res, tree_tu]),
        ("test_final --postprocess", test_main.test_final, "final_pp", final + ["--postprocess"],
         [tree_ct_res, tree_tu]),
        ("test_ctunet", test_main.test_ctunet, "ct3", [f"--pretrained_dir={ct_dir}"],
         [tree_ct, tree_ct, tree_ct]),
    )
    out = {name: eval_run(work, data, name, entry, common + argv + [f"--exp_name={exp}"], trees)
           for name, entry, exp, argv, trees in runs}
    torch.cuda.empty_cache()
    out["argv"], out["common"] = common + final, common
    return out


def eval_run(work, data, name, entry, argv, trees):
    """One eval CLI run (``entry(argv)``, from ``work``: the CLI writes
    under ``./outputs/<exp_name>``) on ``data``'s validation case under
    ``eval_hooks``: launches equal to ``trees`` (the module tree of each
    engine run, in order) times each run's chunks, every engine's first and
    trailing K1 call bit-exact, the masks at the case's native shape and
    below 14, finite Dice and HD95 (``test_final``'s, or for ``test_single``
    and ``test_ctunet`` the rows they return; ``test_single``'s HD95 from
    its saved mask, as ``test_final`` computes it). Returns the seconds of
    set-up, device and host, the launches and the metrics' means."""
    import numpy as np
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.data.nifti import load_nifti

    label, _ = load_nifti(os.path.join(data, "labelsTr", "val_000.nii.gz"))
    exp = next(a for a in argv if a.startswith("--exp_name=")).split("=", 1)[1]
    record = {"device_s": [], "pipeline_s": [], "runs": [], "k1_checked": []}
    cwd = os.getcwd()
    os.chdir(work)
    try:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()  # set-up (reading and preprocessing the case, the
        # models and their checkpoints) ends at the first dispatch
        with eval_hooks(record):
            result = entry(argv)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = counted_launches()
    for grid, n, chunks, heads in record["runs"]:
        log(f"  {name}: grid {grid}, {n} windows, {chunks} chunks, {heads} map(s)")
    check_launches(name, counts, [(tree, run[2]) for tree, run in zip(trees, record["runs"])])
    if len(record["runs"]) != len(trees):
        raise AssertionError(f"{name}: {len(record['runs'])} engine runs, expected {len(trees)}")
    launched = {k for tree in trees for k, v in tree.items() if v}
    if not all(counts[k] for k in launched):
        raise AssertionError(f"{name}: a kernel of the models was not launched: {counts}")
    # each engine run checks its first and its trailing chunk (one call a
    # canvas each)
    want_checked = sum(2 * heads for _, _, _, heads in record["runs"])
    if len(record["k1_checked"]) != want_checked:
        raise AssertionError(f"{name}: {len(record['k1_checked'])} K1 calls checked, "
                             f"expected {want_checked}")
    setup_s = record["first_dispatch"] - t0
    device_s = sum(record["device_s"])
    host_s = wall - setup_s - device_s
    case_s = sum(record["pipeline_s"]) - device_s
    log(f"  {name}: {wall!r} s in all, set-up {setup_s!r} s; per case: device "
        f"{device_s!r} s (sliding window, maps to host memory: {record['device_s']!r}), "
        f"host {host_s!r} s ({case_s!r} s in the case loop: invert, softmax, save; "
        f"{host_s - case_s!r} s after it: metrics"
        f"{' and postprocessing' if 'postprocess' in name else ''}); K1 bit-exact on "
        f"{len(record['k1_checked'])} first/trailing chunk calls {record['k1_checked']}")
    out_dir = os.path.join(work, "outputs", exp)
    masks = sorted(f for f in os.listdir(out_dir) if f.endswith(".nii.gz"))
    loaded = []
    for f in masks:
        mask, _ = load_nifti(os.path.join(out_dir, f))
        if mask.shape != label.shape[:3] or mask.max() >= 14:
            raise AssertionError(f"{f}: mask {mask.shape} (label {label.shape})")
        loaded.append(mask)
    if name.startswith("test_final"):
        dice, hd = np.asarray(result["dice"]), np.asarray(result["hd95"])
        text = open(os.path.join(out_dir, "dice.txt")).read()
        if not (np.isfinite(dice).all() and np.isfinite(hd).all()
                and "mean_hd95:" in text and len(masks) == 1):
            raise AssertionError(f"{name}: dice {dice}, hd95 {hd}, report or mask missing")
        log(f"  {name}: mean Dice {float(dice.mean())!r} (raw "
            f"{float(np.mean(result['dice_raw']))!r}), mean HD95 {float(hd.mean())!r}; "
            f"per-organ Dice {dice.tolist()}")
        summary = {"mean_dice": float(dice.mean()), "mean_hd95": float(hd.mean())}
    elif name.startswith("test_single"):
        dice = np.asarray(result)
        t1 = time.perf_counter()
        hd = organ_hd95(loaded[0], label[..., 0] if label.ndim == 4 else label)
        hd_s = time.perf_counter() - t1
        if not (np.isfinite(dice).all() and np.isfinite(hd).all() and len(masks) == 1
                and os.path.exists(os.path.join(out_dir, "dice.txt"))):
            raise AssertionError(f"{name}: dice {dice}, hd95 {hd}, report or mask missing")
        log(f"  {name}: mean Dice {float(dice.mean())!r}, mean HD95 {float(hd.mean())!r} "
            f"(of the saved mask, {hd_s!r} s); per-organ Dice {dice.ravel().tolist()}")
        summary = {"mean_dice": float(dice.mean()), "mean_hd95": float(hd.mean()),
                   "hd95_host_s": hd_s}
    else:
        rows = {k: np.asarray(v) for k, v in result.items()}
        if not (all(np.isfinite(v).all() for v in rows.values()) and len(masks) == 2):
            raise AssertionError(f"{name}: rows {rows} or masks {masks}")
        log(f"  {name}: mean Dice " + ", ".join(
            f"{k} {float(v.mean())!r}" for k, v in rows.items()))
        summary = {k: float(v.mean()) for k, v in rows.items()}
    return {"wall_s": wall, "setup_s": setup_s, "device_s": device_s, "host_s": host_s,
            "host_invert_save_s": case_s, "launches": counts,
            "k1_checked_calls": len(record["k1_checked"]), **summary}


def organ_hd95(mask, label, n_classes: int = 14):
    """HD95 of each organ of one case, ``eval.metrics.per_organ_hd95``'s
    numbers, the organs spread over spawned processes (two distance
    transforms an organ, ~4.5 s each at 256x256x128 on one core)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np

    from hybrid_ctunet_tpu_torch.eval.metrics import hd95

    organs = range(1, n_classes)
    with ProcessPoolExecutor(min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return np.array(list(pool.map(hd95, (mask == c for c in organs),
                                      (label == c for c in organs))))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


MASK_KEEP = 1 << 25  # a dropout record keeps masks of at most this many values


def dropout_masks(record):
    """Context: every dropout draw also appends to ``record`` the count of
    its kept values, its keep mask where it has at most ``MASK_KEEP``
    values (both drawn again from a copy of the generator's state: the
    draw's own mask, not a second one), whether it is a rematerialized
    block's recompute (``ops.recompute.recomputing``) and the generator's
    state."""
    import contextlib

    import torch

    from hybrid_ctunet_tpu_torch.ops import dropout as dropout_ops
    from hybrid_ctunet_tpu_torch.ops.recompute import recomputing

    real = dropout_ops.dropout

    def draw(x, rate, generator):
        copy = torch.Generator(device=x.device)
        state = generator.get_state()
        copy.set_state(state)
        mask = torch.rand(x.shape, generator=copy, device=x.device) >= rate
        record.append((mask.sum(), mask if mask.numel() <= MASK_KEEP else None, recomputing(),
                       state))
        return real(x, rate, generator)

    @contextlib.contextmanager
    def ctx():
        dropout_ops.dropout = draw
        try:
            yield
        finally:
            dropout_ops.dropout = real

    return ctx()


def eval_chunk(name, model, device, tree, windows: int = CHUNK, res_only: bool = True):
    """One chunk of ``windows`` windows through ``model``'s forward in eval
    mode (a CTUNet's res-only one unless ``res_only`` is off): every kernel
    call held to its plain version on the model's own activations, launches
    equal to ``tree``; returns the (first) logits."""
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench

    x = bench.make_volume(SEED + 7, (windows, *bench.ROI), device)[0].to(torch.bfloat16)
    model.eval()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.inference_mode(), per_call_checks() as worst:
        res = model(x, res_only=True) if res_only else model(x)[0]
        torch.cuda.synchronize()
        counts = counted_launches()  # the checked wrappers count while they stand
    check_launches(f"{name}, eval chunk", counts, [(tree, 1)])
    log(f"  {name}, eval chunk: per-call rel_l2 vs plain on the model's activations (bound "
        f"{BF16_REL_L2}): worst {max(worst.values())!r} over {len(worst)} sites")
    if not torch.isfinite(res.float()).all():
        raise AssertionError(f"{name}: non-finite res logits")
    return res


def recompute_draws(model, record):
    """The draws of ``record`` made by a rematerialized block's recompute,
    each held to the forward's draw from the same generator state: the same
    count of kept values and the same mask. Their number must be the
    module tree's: one a step for each active dropout site of a ViT block
    (the wrapped blocks that have dropout). Returns that number."""
    import torch

    from hybrid_ctunet_tpu_torch.models import layers, vit3d

    forward = [r for r in record if not r[2]]
    again = [r for r in record if r[2]]
    want = sum(isinstance(m, layers.Dropout) and m.rate > 0 for b in model.modules()
               if isinstance(b, vit3d.TransformerBlock) for m in b.modules())
    for count, mask, _, state in again:
        twins = [r for r in forward if torch.equal(r[3], state)]
        if len(twins) != 1 or not torch.equal(twins[0][0], count) or not (
                mask is not None and twins[0][1] is not None and torch.equal(twins[0][1], mask)):
            raise AssertionError("a recomputed dropout mask differs from its forward's")
    log(f"  remat: {len(again)} draws of the recompute, each equal to its forward's mask "
        f"(module tree: {want}); {len(forward)} forward draws")
    if len(again) != want:
        raise AssertionError(f"{len(again)} recomputed dropout draws, the tree has {want}")
    return len(again)


def phase_dropout(device):
    """8a. ``--dropout_rate 0.2`` (the paper's CTUNet_ds8_dr0.2): one
    warm-up and one checked step with block remat on and off
    (``run_steps``), finite losses, launches equal to the tree with the dropout sites
    plain (K2, K3, K4 at none) and, with remat, K8 and K9 recomputed; one
    step's gradients with remat equal those without (``remat_check``); a
    step redone at the same (seed, step) draws the same masks, the next
    step others, and every mask a recompute draws equals its forward's; in
    eval mode the model's res logits equal a rate-0 model's with the same
    weights, bit for bit, on one chunk."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import factory

    model, step, lr, trees, batches = build_train(device, ["--dropout_rate", "0.2"])
    out, (x, y) = run_steps(step, lr, trees, batches, device)
    out["remat_check"] = remat_check("dropout 0.2", model, step, x, y)
    masks = []
    for k in (step.step, step.step, step.step + 1):
        step.step = k
        record = []
        with dropout_masks(record):
            step(x, y, lr)
        masks.append(record)

    def equal(a, b):
        return torch.equal(a[0], b[0]) and (a[1] is None or torch.equal(a[1], b[1]))

    same = len(masks[0]) == len(masks[1]) and all(map(equal, masks[0], masks[1]))
    firsts = [[r for r in m if not r[2]][:8] for m in (masks[0], masks[2])]
    other = sum(not torch.equal(a[1], b[1]) for a, b in zip(*firsts))
    log(f"  masks: {len(masks[0])} draws a step; the same (seed, step) again: "
        f"{'identical' if same else 'DIFFERENT'} (kept counts of every draw, the masks of "
        f"up to {MASK_KEEP} values); the next step: {other} of the first 8 forward masks "
        f"differ; keep fraction of the first draw {masks[0][0][1].float().mean().item()!r}")
    if not same or other != len(firsts[0]):
        raise AssertionError("dropout masks are not a function of (seed, step)")
    out["recomputed_draws"] = recompute_draws(model, masks[0])
    del masks, record
    args = train_args()
    args.model_name = "ctunet"
    plain = factory.build_model(args, device)
    plain.load_state_dict(model.state_dict())
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eval_tree = tree_launches(model, res_only=True)
        eval_tree["scatter_add_windows"] = 0
        got = eval_chunk("rate 0.2", model, device, eval_tree)
        want = eval_chunk("rate 0", plain, device, eval_tree)
    finally:
        torch.backends.cudnn.deterministic = saved
    if not torch.equal(got, want):
        raise AssertionError("eval-mode res logits at rate 0.2 differ from rate 0's")
    log("  eval mode: rate-0.2 res logits equal the rate-0 model's bit for bit")
    del model, step, plain, got, want
    torch.cuda.empty_cache()
    return out


def phase_batchnorm(device):
    """8b. ``--norm_name batch``: one warm-up and one checked step with
    block remat on and off (``run_steps``), finite losses, launches
    equal to the tree (K8 at no BatchNorm site, K9 recomputed with remat);
    the running buffers move and stay finite; one step from the same
    buffers with remat and without leaves them equal, its gradients equal
    (``remat_check``); one step under
    torch.profiler; an eval-mode chunk with every launched kernel held to its
    plain version on the model's own activations."""
    import torch

    from hybrid_ctunet_tpu_torch.utils import profiling

    model, step, lr, trees, batches = build_train(device, ["--norm_name", "batch"])
    before = {k: v.clone() for k, v in model.state_dict().items() if k.endswith("running_var")}
    out, (x, y) = run_steps(step, lr, trees, batches, device)
    after = model.state_dict()
    moved = sum(not torch.equal(v, after[k]) for k, v in before.items())
    finite = all(torch.isfinite(v).all() for k, v in after.items()
                 if k.endswith(("running_mean", "running_var")))
    log(f"  running buffers: {moved} of {len(before)} running_var moved, finite {finite}")
    if moved != len(before) or not finite:
        raise AssertionError("BatchNorm running buffers did not move or are not finite")
    out["remat_check"] = remat_check("BatchNorm", model, step, x, y)
    if out["remat_check"]["buffers_moved"] != len(list(model.buffers())):
        raise AssertionError("a BatchNorm buffer did not move in the compared step")
    prof = profiling.profile_device(lambda: step(x, y, lr))
    log(f"  one step under torch.profiler: wall {prof['wall_s']!r} s, kernels "
        f"{prof['kernel_ms']!r} ms, busy {prof['busy_share']!r}")
    log(json.dumps({"batchnorm_step_profile": prof}))
    eval_tree = tree_launches(model, res_only=True)
    eval_tree["scatter_add_windows"] = 0
    eval_chunk("BatchNorm", model, device, eval_tree)
    del model, step
    torch.cuda.empty_cache()
    return out


def phase_ddp(device, work, eval_argv):
    """8c. DDP on the one card. One DDP step (NCCL, world 1) from fixed
    weights against the plain step on the same batch (the CPU test's
    tolerances: loss rtol 1e-4; each parameter's gradient, which the AdamW
    step leaves in ``.grad``, to rtol 1e-2 in norm and a relative L2 error
    of 0.1), its launches
    equal to the tree; ``train_main --distributed`` for one epoch with
    validation (checkpoints written once, by rank 0; ``latest.pt``
    reloads); ``test_final --distributed`` on phase 7's case, whose masks
    must equal phase 7's."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import factory, test_main, train_main
    from hybrid_ctunet_tpu_torch.data.nifti import load_nifti
    from hybrid_ctunet_tpu_torch.parallel.dp import make_dp_train_step
    from hybrid_ctunet_tpu_torch.parallel.mesh import initialize_distributed
    from hybrid_ctunet_tpu_torch.train.checkpoint import load_weights
    from hybrid_ctunet_tpu_torch.train.steps import make_train_step

    lr = 1e-4
    model, step, _, trees, batches = build_train(device)
    image, label = (torch.from_numpy(a).to(device) for a in batches[0])
    twin = factory.build_model(train_args(), device)
    twin.load_state_dict(model.state_dict())
    initialize_distributed(f"tcp://localhost:{free_port()}", 1, 0, "nccl")
    try:
        dp_step = make_dp_train_step("ctunet", twin, factory.build_optimizer(train_args(), twin))
        want = step(image, label, lr)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        got = dp_step(image, label, lr)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = counted_launches()
    finally:
        dist.destroy_process_group()
    check_launches("DDP step", counts, [(trees[True], 1)])
    worst_ratio, worst_err = 0.0, 0.0
    for (name, p), q in zip(model.named_parameters(), twin.parameters()):
        if p.grad is None or q.grad is None:
            if (p.grad is None) != (q.grad is None):
                raise AssertionError(f"DDP step: {name} has a gradient on one side only")
            continue
        scale = p.grad.double().norm().item()
        worst_ratio = max(worst_ratio, abs(q.grad.double().norm().item() / scale - 1.0))
        worst_err = max(worst_err, (q.grad.double() - p.grad.double()).norm().item() / scale)
    log(f"  DDP step (world 1, NCCL): {dt!r} s, loss {got['loss'].item()!r} (plain step "
        f"{want['loss'].item()!r}); per-parameter gradient against the plain step's: worst "
        f"norm ratio - 1 {worst_ratio!r} (bound 1e-2), worst relative L2 error {worst_err!r} "
        f"(bound 0.1)")
    if not (abs(got["loss"].item() - want["loss"].item()) <= 1e-4 * abs(want["loss"].item())
            and worst_ratio <= 1e-2 and worst_err <= 0.1):
        raise AssertionError("the DDP step differs from the plain step")
    del model, twin, step, dp_step, batches
    torch.cuda.empty_cache()

    logs = os.path.join(work, "train_ddp")
    argv = ["--model_depths", "101", "--patch_frame", "8", "--synthetic", "--max_epochs", "1",
            "--val_every", "1", "--warmup_epochs", "1", "--save_checkpoint", "--distributed",
            "--dist-url", f"tcp://localhost:{free_port()}",
            "--data_dir", os.path.join(work, "train_data"), "--logdir", logs]
    log(f"  train_main {' '.join(argv)}")
    t0 = time.perf_counter()
    best = train_main.main("ctunet", argv)
    cli_wall = time.perf_counter() - t0
    files = sorted(os.listdir(logs))
    with open(os.path.join(logs, "scalars.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    log(f"  {cli_wall!r} s; best {best}; files {files}; scalars {tags}")
    if "latest.pt" not in files or any(f.endswith(".tmp") for f in files) \
            or tags.count("train_loss") != 1:
        raise AssertionError(f"train_main --distributed: files {files}, scalars {tags}")
    fresh = factory.build_model(train_args(), device)
    ckpt = load_weights(fresh, os.path.join(logs, "latest.pt"))
    if ckpt["epoch"] != 1 or not all(torch.isfinite(p).all() for p in fresh.parameters()):
        raise AssertionError(f"latest.pt: epoch {ckpt['epoch']} or non-finite weights")
    log(f"  latest.pt loads into a fresh CTUNet (epoch {ckpt['epoch']})")
    del fresh, ckpt
    torch.cuda.empty_cache()

    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        result = test_main.test_final(eval_argv + [
            "--distributed", "--dist-url", f"tcp://localhost:{free_port()}",
            "--exp_name=final_dist"])
        eval_wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    case = sorted(f for f in os.listdir(os.path.join(work, "outputs", "final"))
                  if f.endswith(".nii.gz"))[0]
    mask, _ = load_nifti(os.path.join(work, "outputs", "final_dist", case))
    want_mask, _ = load_nifti(os.path.join(work, "outputs", "final", case))
    equal = float((mask == want_mask).mean())
    log(f"  test_final --distributed: {eval_wall!r} s, mean Dice "
        f"{float(np.mean(result['dice']))!r}; mask equal to phase 7's on {equal!r} of voxels")
    if equal != 1.0:
        raise AssertionError("test_final --distributed gave other masks than phase 7")
    return {"ddp_step_s": dt, "ddp_step_loss": got["loss"].item(),
            "ddp_step_grad_worst_norm_ratio": worst_ratio,
            "ddp_step_grad_worst_rel_l2": worst_err, "launches_per_step": counts,
            "train_cli_wall_s": cli_wall, "test_final_wall_s": eval_wall}


SW_WIDE = 8  # the JAX bench's window batch (bench.py BENCH_SW_CT / BENCH_SW_TU)


def phase_measure(device):
    """9. The ensemble at 8 windows a chunk, the traced records and the NaN
    checks. (a) At 8 windows a chunk: launches per volume equal to the
    module tree's x 7 CTUNet and 19 TUNet chunks, every K1 call of each
    engine's first and trailing chunk bit-exact, one 8-window chunk of each
    model with every kernel call held to its plain version. (b)
    ``utils.profiling.profile_device`` on a warm volume of each half at 4,
    its traced kernel records equal to the launch counters. (c)
    ``enable_nan_checks``: a NaN in one window of a TUNet chunk raises
    ``FloatingPointError`` naming a module; with the checks off the chunk
    runs."""
    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.utils import enable_nan_checks, profiling

    t0 = time.perf_counter()
    ctunet, tunet = bench.build_ctunet(SEED, device), bench.build_tunet(SEED, device)
    volume = bench.make_volume(SEED, bench.VOLUME_SHAPE, device)
    engines = {sw: (bench.make_ctunet_engine(ctunet, sw=sw), bench.make_engine(tunet, sw=sw))
               for sw in (CHUNK, SW_WIDE)}
    ct8, tu8 = engines[SW_WIDE]
    chunks = (n_chunks(ct8)[1], n_chunks(tu8)[1])
    log(f"  (a) sw {SW_WIDE}: CTUNet {n_chunks(ct8)[0]} windows in {chunks[0]} chunks, "
        f"TUNet {n_chunks(tu8)[0]} in {chunks[1]}")
    if chunks != (7, 19):
        raise AssertionError(f"{chunks} chunks at sw {SW_WIDE}, expected (7, 19)")
    checked = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with k1_checks(checked):
        _, _, prob, mask = bench.segment_hybrid(ct8, tu8, volume)
    torch.cuda.synchronize()
    counts8 = counted_launches()
    check_launches(f"hybrid volume at sw {SW_WIDE}", counts8,
                   [(tree_launches(ctunet, res_only=True), chunks[0]),
                    (tree_launches(tunet), chunks[1])])
    check_mask(mask)
    log(f"  K1 bit-exact on the first and trailing chunk of each engine: windows {checked}")
    if sorted(checked) != [2, 3, SW_WIDE, SW_WIDE]:
        raise AssertionError(f"K1 checked on chunks of {checked} windows")
    del prob, mask
    for name, model, res_only in (("CTUNet res head", ctunet, True), ("TUNet", tunet, False)):
        tree = tree_launches(model, res_only=res_only)
        tree["scatter_add_windows"] = 0
        eval_chunk(f"{name}, {SW_WIDE} windows", model, device, tree, SW_WIDE, res_only)
    log("  (b) profile_device, traced kernel records against the launch counters")
    profiles = {}
    for name, engine in zip(("ctunet", "tunet"), engines[CHUNK]):
        prof = profiling.profile_device(lambda: bench.segment(engine, volume))
        profiles[name] = {k: prof[k] for k in ("wall_s", "kernel_ms", "busy_share",
                                               "kernel_records")}
        log(f"  {name} half: wall {prof['wall_s']!r} s, kernels {prof['kernel_ms']!r} ms, busy "
            f"{prof['busy_share']!r}; records equal to launches {prof['kernel_records']}")
        log(json.dumps({f"{name}_half_profile": prof}))

    log("  (c) enable_nan_checks")
    x = bench.make_volume(SEED + 7, (CHUNK, *bench.ROI), device)[0].to(torch.bfloat16)
    x[1, 40, 40, 40, 0] = float("nan")
    enable_nan_checks(True)
    try:
        with torch.inference_mode():
            tunet(x)
        raise AssertionError("a NaN in the chunk did not raise under enable_nan_checks")
    except FloatingPointError as e:
        caught = str(e)
    finally:
        enable_nan_checks(False)
    with torch.inference_mode():
        tunet(x)
    torch.cuda.synchronize()
    log(f"  planted NaN caught: {caught}; with the checks off the chunk runs")
    del ctunet, tunet, engines, ct8, tu8
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"  phase 9: {wall!r} s")
    return {"sw8_launches": counts8, "profiles": profiles, "nan_check": caught, "wall_s": wall}


SINGLE_FILES = {"tunet": "model_vit.pt", "cunet": "model_res.pt",  # trainer.py's names
                "swin_unetr": "model_vit.pt"}


def phase_single_steps(device, model_name: str):
    """10a. The full-width TUNet or CUNet (main_C_TUNet.py ``--model_name``)
    through the port's train step on --synthetic data, batch 1 x 4 crops of
    96^3, bf16, AdamW: a warm-up and one checked step with block remat on
    and off (``run_steps``: launches equal to the module tree's, finite
    losses, the checked step's peak), then one step's gradients with remat
    against without (``remat_check``)."""
    import torch

    model, step, lr, trees, batches = build_train(device, model_name=model_name)
    out, (x, y) = run_steps(step, lr, trees, batches, device)
    out["remat_check"] = remat_check(model_name, model, step, x, y)
    del model, step
    torch.cuda.empty_cache()
    return out


def phase_single_cli(device, work, model_name: str, extra=()):
    """10b. ``python -m hybrid_ctunet_tpu_torch.cli.train_main c_tunet
    --model_name <model_name>`` (main_C_TUNet.py's counterpart, run as the
    module with ``sys.argv`` set, so that its entry word picks the entry):
    --synthetic, two epochs, validation at the second, the best-metric file
    (``model_vit.pt`` or ``model_res.pt``) and latest.pt, each loaded back
    into a fresh model with finite weights. The kernels launched in the run
    are those of the model's module tree, K1 (validation) with them. The
    checkpoints stay in ``work/train_<model_name>`` for 10c and 10d."""
    import runpy

    import torch

    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import factory
    from hybrid_ctunet_tpu_torch.train.checkpoint import load_weights

    logs = os.path.join(work, f"train_{model_name}")
    argv = ["c_tunet", "--model_name", model_name, "--model_depths", "101", "--patch_frame", "8",
            "--synthetic", "--max_epochs", "2", "--val_every", "2", "--warmup_epochs", "1",
            "--save_checkpoint", "--data_dir", os.path.join(work, "train_data"),
            "--logdir", logs, *extra]
    log(f"  python -m hybrid_ctunet_tpu_torch.cli.train_main {' '.join(argv)}")
    saved = sys.argv
    sys.argv = ["train_main", *argv]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        runpy.run_module("hybrid_ctunet_tpu_torch.cli.train_main", run_name="__main__")
        code = None
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = counted_launches()
    files = sorted(os.listdir(logs))
    log(f"  exit {code}; {wall!r} s; files {files}; launches {counts}")
    best_file = SINGLE_FILES[model_name]
    missing = {best_file, "latest.pt"} - set(files)
    if code != 0 or missing:
        raise AssertionError(f"train_main c_tunet exited {code} and did not write "
                             f"{sorted(missing)}")
    fresh = factory.build_model(train_args(extra, model_name=model_name), device)
    tree = tree_launches(fresh, training=True)
    want = {k for k, v in tree.items() if v} | {"scatter_add_windows"}
    if {k for k, v in counts.items() if v} != want:
        raise AssertionError(f"launched {counts}, expected the kernels {sorted(want)}")
    loaded = {}
    for f in (best_file, "latest.pt"):
        ckpt = load_weights(fresh, os.path.join(logs, f))
        if not all(torch.isfinite(p).all() for p in fresh.parameters()):
            raise AssertionError(f"{f}: non-finite weights")
        loaded[f] = {"epoch": ckpt["epoch"], "best_acc": float(ckpt["best_acc"])}
        log(f"  {f} loads into a fresh {type(fresh).__name__} (epoch {ckpt['epoch']}, best_acc "
            f"{ckpt['best_acc']!r}, {len(ckpt['state_dict'])} tensors)")
    if loaded["latest.pt"]["epoch"] != 2:
        raise AssertionError(f"latest.pt: epoch {loaded['latest.pt']['epoch']}, expected 2")
    del fresh, ckpt
    torch.cuda.empty_cache()
    return {"wall_s": wall, "launches": counts, "checkpoints": loaded, "logs": logs}


def phase_single(device, work, ct_logs, common):
    """10. main_C_TUNet.py's workflow at full width (ResNet-101, pf 8, the
    CLI defaults: batch 1 x 4 crops of 96^3, bf16, AdamW, --synthetic):
    (a) the TUNet and CUNet train steps (``phase_single_steps``); (b)
    ``train_main c_tunet --model_name tunet``, then ``cunet``
    (``phase_single_cli``); (c) ``test_single`` on each run's best-metric
    file, on phase 7's 256x256x128 case (``eval_run``: launches equal to
    the tree's times the chunks, K1 bit-exact on each engine's first and
    trailing chunk, finite Dice and HD95, masks at the native shape, device
    and host seconds); (d) the README's workflow: ``test_final`` on phase 6's
    trained CTUNet (``model_res.pt``) and (b)'s trained TUNet."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import test_main
    from hybrid_ctunet_tpu_torch.models import CTUNet, CUNet, TUNet

    t0 = time.perf_counter()
    out = {}
    for name in ("tunet", "cunet"):
        log(f"  (a) {name} train steps")
        out[f"{name}_steps"] = phase_single_steps(device, name)
    runs = {}
    for name in ("tunet", "cunet"):
        log(f"  (b) train_main c_tunet --model_name {name}")
        runs[name] = phase_single_cli(device, work, name)
    data = os.path.join(work, "eval_data")
    meta = dict(out_channels=14, dtype=torch.bfloat16, device="meta")
    trees = {"tunet": tree_launches(TUNet(patch_frame=8, **meta)),
             "cunet": tree_launches(CUNet(model_depth=101, **meta))}
    for name, run in runs.items():
        log(f"  (c) test_single --model_name {name}")
        out[f"test_single_{name}"] = eval_run(
            work, data, f"test_single {name}", test_main.test_single,
            common + [f"--model_name={name}", f"--pretrained_dir={run['logs']}",
                      f"--pretrained_model_name={SINGLE_FILES[name]}",
                      f"--exp_name=single_{name}"], [trees[name]])
    log("  (d) test_final on phase 6's trained CTUNet and (b)'s trained TUNet")
    tree_ct_res = tree_launches(CTUNet(model_depth=101, patch_frame=8, **meta), res_only=True)
    out["test_final_trained"] = eval_run(
        work, data, "test_final, trained TUNet", test_main.test_final,
        common + [f"--ctunet_dir={ct_logs}", f"--tunet_dir={runs['tunet']['logs']}",
                  "--exp_name=final_trained"], [tree_ct_res, trees["tunet"]])
    out.update({f"{name}_cli": {k: v for k, v in run.items() if k != "logs"}
                for name, run in runs.items()})
    out["wall_s"] = time.perf_counter() - t0
    log(f"  phase 10: {out['wall_s']!r} s")
    return out


def swin_tree_launches(model, training: bool = False, remat: bool = False):
    """Kernel launches per 4-window chunk that a Swin-UNETR forward implies:
    one window attention (K2) a transformer block; a conv (K10) at each
    stride-1 3^3 conv to 48 channels (encoder1, encoder2, and decoder1-2's
    ResBlocks: 8); a transposed conv (K6)
    where its gate takes the decoder's input (Cin 192 and up: decoder1 and
    decoder2, at Cin 48 and 96, run K6's plain GEMM); every InstanceNorm
    (K8), a tail's folded projection norm in the same record
    (``ops.norm.folds``); the engine's scatter (K1). ``training`` with
    ``remat``: each transformer block and ResBlock runs its forward again
    in the backward, its K2, K8 and K10 calls with it."""
    import torch

    from hybrid_ctunet_tpu_torch.cli import bench
    from hybrid_ctunet_tpu_torch.models import layers, swin_unetr
    from hybrid_ctunet_tpu_torch.ops import conv3x3, norm, shuffle

    x = torch.empty(CHUNK, *bench.ROI, 1, device="meta")
    _, tails = record_norm_sites(model, x)

    def k8(mods):
        inside = {id(m) for mod in mods for m in mod.modules()}
        mine = [(shape, raw) for n, shape, raw in tails if id(n) in inside]
        norms = sum(isinstance(m, layers.ConvNorm) and m.kind == "instance"
                    for mod in mods for m in mod.modules())
        return norms - sum(raw and norm.folds(shape) for shape, raw in mine), len(mine)

    def k10(mods):
        return sum(isinstance(m, layers.Conv3d) and m.stride == (1, 1, 1)
                   and conv3x3.supports((CHUNK, 8, 8, 8, m.conv.weight.shape[1]),
                                        tuple(m.conv.weight.shape), m.stride, model.dtype,
                                        torch.device("cuda"))
                   for mod in mods for m in mod.modules())

    blocks = [m for m in model.modules() if isinstance(m, swin_unetr.SwinBlock)]
    got = dict.fromkeys(("scatter_add_windows", "window_attention", "ffn", "ffn_pair",
                         "pixel_shuffle_linear", "transp_conv_kxs", "pixelweight",
                         "instance_norm", "conv3x3_winograd", "conv3x3",
                         "instance_norm.residual"), 0)
    got["scatter_add_windows"] = 1
    got["window_attention"] = len(blocks)
    for k in range(1, 6):
        w = getattr(model, f"decoder{k}").transp_conv.conv.weight
        side = bench.ROI[0] // 2 ** k
        got["transp_conv_kxs"] += shuffle.transp_supports(
            (CHUNK, side, side, side, w.shape[0]), tuple(w.shape), model.dtype)
    got["instance_norm"], got["instance_norm.residual"] = k8([model])
    got["conv3x3"] = k10([model])
    if training and remat:
        got["window_attention"] += len(blocks)
        got["conv3x3"] += k10([m for m in model.modules() if isinstance(m, layers.ResBlock)])
        again = k8([m for m in model.modules() if isinstance(m, layers.ResBlock)])
        got["instance_norm"] += again[0]
        got["instance_norm.residual"] += again[1]
    return got


# Swin-UNETR's window attentions, a 4-window chunk at 96^3: (stage, windows,
# C, heads, window, padded grid)
SWIN_ATTENTION = ((1, 4 * 343, 48, 3, 7, 49), (2, 4 * 64, 96, 6, 7, 28), (3, 4 * 8, 192, 12, 7, 14),
                  (4, 4, 384, 24, 6, 6))
SWIN_WINDOWS = (3328, 684)  # windows a chunk's forward runs, and of them masked


def phase_swin(device, work):
    """11. Swin-UNETR (MONAI's BTCV model, 62,187,296 params) at full width:
    (a) K2's head-width-16 instance at each stage's shapes, unshifted and
    shifted (stage 4's 6^3 windows indexed over 7^3), against its plain
    version, bit for bit on a rerun, timed with the plain version, the
    library's attention (``F.scaled_dot_product_attention`` over the
    materialized bias and mask) and the bound, a chunk's total counting
    stage 4's two blocks; today's instance re-timed at TUNet's pyramid
    shapes; (b) K8 at
    every InstanceNorm and tail site of a chunk (C = 48 * 2^k) against the
    plain composition, each tail bit for bit the unfused K8 sequence, timed
    with the plain version and the bound; today's widths re-timed at CTUNet
    sites; (c) a chunk through the bf16 model with every kernel call held to
    its plain version, the launch counters equal to the module tree's
    (``swin_tree_launches``), K2's windows (3,328, 684 masked) and K8's
    launches at the new widths, the traced records reconciled with the
    counters, the kernel model against the plain model, the chunk's time
    and peak memory; (d) a 256 x 256 x 128 volume through the engine at sw
    4, its launches equal to the module tree's x 13 chunks, finite logits
    and the mask in range; (e) train steps (1 x 4 crops, remat on and off,
    ``run_steps``) and
    ``train_main c_tunet --model_name swin_unetr --feature_size 48``; (f)
    ``test_single`` on the trained model's ``model_vit.pt``."""
    import torch
    import torch.nn.functional as F

    from benchmark import weights
    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench, test_main
    from hybrid_ctunet_tpu_torch.models import SwinUNETR
    from hybrid_ctunet_tpu_torch.models.layers import remat_blocks
    from hybrid_ctunet_tpu_torch.ops import attention, norm
    from hybrid_ctunet_tpu_torch.utils import profiling

    bf = torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    out = {}

    def randn(*shape, dtype=torch.float32, mean=0.0):
        return (torch.randn(shape, generator=gen, device=device) + mean).to(dtype)

    log("  (a) K2 at Swin-UNETR's shapes (ms a call)")
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    for stage, n, C, heads, w, grid in SWIN_ATTENTION:
        T = w ** 3
        qkv = randn(n, T, 3 * C, dtype=bf)
        q, k, v = qkv[..., :C] * 16 ** -0.5, qkv[..., C:2 * C], qkv[..., 2 * C:]
        qh, kh, vh = (a.reshape(n, T, heads, 16).transpose(1, 2) for a in (q, k, v))
        table = randn(13 ** 3, heads)
        bias = attention.gather_bias(table, w, 7)
        # stages 1-3 run one unshifted and one shifted block, stage 4 two unshifted
        shifts, calls = ((0, 3), 1) if w == 7 else ((0,), 2)
        for shift in shifts:
            kw = dict(index_window=7, shift=((grid,) * 3, shift) if shift else None)
            got = attention.window_attention(q, k, v, table, w, bf, **kw)
            want = attention.reference_window_attention_table(q, k, v, table, w, bf, **kw)
            err = check_bf16(f"window_attention stage {stage} shift {shift} ({n}x{w ** 3}x{C})",
                             got, want)
            if not torch.equal(got, attention.window_attention(q, k, v, table, w, bf, **kw)):
                raise AssertionError(f"K2 stage {stage} shift {shift}: a rerun differs")
            ms = cuda_time_ms(lambda: attention.window_attention(q, k, v, table, w, bf, **kw))
            plain = cuda_time_ms(lambda: attention.reference_window_attention_table(
                q, k, v, table, w, bf, **kw), reps=3, calls=2)
            # the library's attention over the materialized bias (and mask)
            if shift:
                mask = attention.shift_mask((grid,) * 3, w, shift, device)
                mask = (bias[None] + mask[:, None]).to(bf).repeat(n // mask.shape[0], 1, 1, 1)
            else:
                mask = bias.to(bf).contiguous()[None]
            lib = cuda_time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                                      scale=1.0))
            del mask
            bound = n * heads * max(4 * T * T * 16 / BF16_FLOP_PER_S,
                                    4 * T * 16 * 2 / HBM_BYTES_PER_S) * 1e3
            log(f"  K2 stage {stage} shift {shift} x{calls}: {ms!r} ms, plain {plain!r} ms, sdpa "
                f"{lib!r} ms, bound {bound!r} ms ({100 * bound / ms:.1f}%)")
            rows.append({"stage": stage, "shift": shift, "calls": calls, "windows": n, "C": C,
                         "ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                         "max_abs_err": err})
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                             ("bound_ms", bound)):
                total[key] += calls * val
    log(f"  K2 a chunk (8 calls, stage 4's counted twice): {total!r}")
    tunet = []
    for stage, (nwin, C) in enumerate(((8, 768), (64, 512), (512, 256))):
        qkv = randn(nwin, 216, 3 * C, dtype=bf)
        q, k, v = qkv[..., :C] * 32 ** -0.5, qkv[..., C:2 * C], qkv[..., 2 * C:]
        table = randn(11 ** 3, C // 32)
        tunet.append(cuda_time_ms(lambda: attention.window_attention(q, k, v, table, 6, bf)))
    log(f"  K2 head width 32 at TUNet's pyramid stages 0-2: {tunet!r} ms a call")
    out["k2"] = {"rows": rows, "chunk": total, "tunet_stages_ms": tunet}
    del qkv, q, k, v, qh, kh, vh, got, want

    log("  (b) K8 at Swin-UNETR's InstanceNorm and tail sites (ms a chunk)")
    meta_model = SwinUNETR(dtype=bf, device="meta")
    x_meta = torch.empty(CHUNK, *bench.ROI, 1, device="meta")
    sites, tails = record_norm_sites(meta_model, x_meta)
    k8 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    folded = collections.Counter((shape, raw) for _, shape, raw in tails)
    for (shape, act), calls in sorted(sites.items()):
        x = randn(*shape, dtype=bf, mean=0.5)
        run = norm.instance_norm_leaky if act else norm.instance_norm

        def plain(x=x, act=act):
            y = norm.reference_instance_norm(x)
            return F.leaky_relu(y, 0.01) if act else y

        def library(x=x, act=act):
            y = F.instance_norm(x.permute(0, 4, 1, 2, 3), eps=1e-5).permute(0, 2, 3, 4, 1)
            return F.leaky_relu_(y, 0.01) if act else y

        got = run(x)
        check_bf16(f"K8 {shape} act {act}", got, plain())
        if not torch.equal(got, run(x)):
            raise AssertionError(f"K8 {shape}: a rerun differs")
        ms, p_ms, l_ms = (cuda_time_ms(f) for f in (lambda: run(x), plain, library))
        bound = 2 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
        regime = norm.plan(shape[0], math.prod(shape[1:4]), shape[-1])
        log(f"  K8 {shape} act {act} x{calls} ({'on chip' if regime.onchip else 'two passes'}): "
            f"{ms!r} ms, plain {p_ms!r}, library {l_ms!r}, bound {bound!r}")
        for key, val in (("ms", ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                         ("bound_ms", bound)):
            k8[key] += calls * val
    tail_ms = 0.0
    for (shape, raw), calls in sorted(folded.items()):
        a, r = randn(*shape, dtype=bf, mean=0.5), randn(*shape, dtype=bf, mean=0.5 if raw else 0)
        got = norm.instance_norm_add_leaky(a, r, raw)
        res = norm.instance_norm(r) if raw else r
        if not torch.equal(got, F.leaky_relu(norm.instance_norm(a) + res, 0.01)):
            raise AssertionError(f"K8 tail {shape} raw {raw}: not the unfused sequence")
        ms = cuda_time_ms(lambda: norm.instance_norm_add_leaky(a, r, raw))
        log(f"  K8 tail {shape} raw {raw} x{calls} (fold {raw and norm.folds(shape)}): {ms!r} ms, "
            "bit for bit the unfused K8 sequence")
        tail_ms += calls * ms
    today = []
    for shape in ((4, 96, 96, 96, 64), (4, 48, 48, 96, 128), (4, 24, 24, 48, 256),
                  (4, 12, 12, 24, 512), (4, 6, 6, 12, 1024)):
        x = randn(*shape, dtype=bf, mean=0.5)
        today.append(cuda_time_ms(lambda: norm.instance_norm_leaky(x)))
    log(f"  K8 a chunk: {k8!r}; tails {tail_ms!r} ms; today's widths at CTUNet sites {today!r}")
    out["k8"] = {**k8, "tails_ms": tail_ms, "today_ms": today}
    del x, a, r, got

    log("  (c) a chunk through the model, every kernel call held to its plain version")
    model = SwinUNETR(dtype=bf, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != PARAMS["swin_unetr"]:
        raise AssertionError(f"Swin-UNETR has {n_params} params")
    model.load_state_dict(weights.make([(k, tuple(p.shape)) for k, p in model.named_parameters()],
                                       SEED, device))
    model.eval()
    tree = swin_tree_launches(model)
    xs = randn(CHUNK, *bench.ROI, 1)
    with torch.inference_mode(), remat_blocks(False):
        with per_call_checks() as worst:
            kernels.reset_launch_counts()
            y = model(xs)[0]
            counts, windows = counted_launches(), kernels.window_counts()
            launches_48 = kernels.launches_48()
        log(f"  worst kernel-vs-plain rel L2 by site: {max(worst.values())!r}")
        check_launches("Swin-UNETR chunk", counts, [({**tree, "scatter_add_windows": 0}, 1)])
        if windows != SWIN_WINDOWS or launches_48 != counts["instance_norm"]:
            raise AssertionError(f"K2 windows {windows} (expected {SWIN_WINDOWS}), K8 at the "
                                 f"new widths {launches_48} of {counts['instance_norm']}")
        with kernels.gates_off():
            yp = model(xs)[0]
        rel = errors(y, yp)[1]
        log(f"  kernels against the plain model: rel L2 {rel!r}")
        prof = profiling.profile_device(lambda: model(xs))  # raises unless the records reconcile
        log(f"  traced records reconcile with the counters: {prof['kernel_records']}")
        torch.cuda.reset_peak_memory_stats()
        chunk_ms = cuda_time_ms(lambda: model(xs), reps=3, calls=5)
        peak = torch.cuda.max_memory_allocated()
        log(f"  a 4-window chunk: {chunk_ms!r} ms, peak {peak} B")
        out["chunk"] = {"ms": chunk_ms, "peak_bytes": peak, "rel_l2_vs_plain": rel,
                        "windows": windows, "launches": counts, "launches_48": launches_48}

        log("  (d) a 256 x 256 x 128 volume through the engine, sw 4")
        engine = bench.make_engine(model, bench.ROI, 0.5, CHUNK)
        volume = bench.make_volume(SEED, device=device)
        kernels.reset_launch_counts()
        logits, mask = bench.segment(engine, volume)
        vol_counts = counted_launches()
        _, chunks = n_chunks(engine)
        check_launches("Swin-UNETR volume", vol_counts, [(tree, chunks)])
        check_map("Swin-UNETR logits", logits)
        check_mask(mask)
        out["volume"] = {"launches": vol_counts}
    del model, engine, volume, y, yp, xs, logits, mask
    torch.cuda.empty_cache()

    log("  (e) train steps and train_main c_tunet --model_name swin_unetr")
    extra = ("--feature_size", "48")
    model, step, lr, trees, batches = build_train(device, extra, model_name="swin_unetr")
    steps_out, _ = run_steps(step, lr, trees, batches, device)
    out["train_steps"] = step_stats(steps_out)
    del model, step
    torch.cuda.empty_cache()
    cli = phase_single_cli(device, work, "swin_unetr", extra)
    out["train_cli"] = {k: v for k, v in cli.items() if k != "logs"}

    log("  (f) test_single --model_name swin_unetr on the trained model_vit.pt")
    data = os.path.join(work, "train_data")
    argv = ["--model_name", "swin_unetr", "--feature_size", "48", "--data_dir", data,
            "--json_list", "dataset_synth.json", "--pretrained_dir", cli["logs"],
            "--pretrained_model_name", SINGLE_FILES["swin_unetr"], "--exp_name", "single_swin"]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        t0 = time.perf_counter()
        rows = test_main.test_single(argv)
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    if rows is None or not all(math.isfinite(float(v)) for v in rows.ravel()):
        raise AssertionError(f"test_single: {rows}")
    log(f"  test_single: {wall!r} s, mean Dice {float(rows.mean())!r}")
    out["test_single"] = {"wall_s": wall, "mean_dice": float(rows.mean())}
    return out


def step_stats(run):
    """A train phase's numbers for the summary line: with remat, and under
    ``no_remat`` and ``remat_check`` where the phase has them."""
    keys = ("losses", "peak_mem_bytes")
    out = {k: run[k] for k in keys}
    if "no_remat" in run:
        out["no_remat"] = {k: run["no_remat"][k] for k in keys}
    if "remat_check" in run:
        out["remat_check"] = run["remat_check"]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("error: chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from hybrid_ctunet_tpu_torch import kernels
    from hybrid_ctunet_tpu_torch.cli import bench

    start = time.perf_counter()
    device = torch.device("cuda", 0)
    log("phase 1: device")
    card = device_line()
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

    work_dir = tempfile.TemporaryDirectory()  # checkpoints and data of phases 4-11
    work = work_dir.name

    log("phase 4: TUNet sliding-window slice")
    tunet, tu_engine, volume = phase_tunet(device, work)

    log("phase 5: Hybrid-CTUNet ensemble")
    counts = phase_hybrid(tunet, tu_engine, volume, device)
    del tunet, tu_engine, volume
    torch.cuda.empty_cache()

    log("phase 6: training (the slice's main path)")
    grads = phase_train_grads(device)
    train, windows = phase_train_steps(device)
    cli = phase_train_cli(device, work)
    log("phase 6 (C6): the whole-model kernel check on trained weights")
    c6 = phase_trained_check(device, work, cli["logs"], windows)
    del windows

    log("phase 7: the eval CLI (cli/test_main.py) on the card")
    ev = phase_eval(work, cli["logs"], os.path.join(work, "tunet"))

    log("phase 8: the remaining training configurations")
    t8 = time.perf_counter()
    log("phase 8a: --dropout_rate 0.2")
    drop = phase_dropout(device)
    log("phase 8a': --batch_size 2 --dropout_rate 0.2 (8 crops a step) with remat")
    drop2 = phase_dropout_batch2(device)
    log("phase 8b: --norm_name batch")
    bn = phase_batchnorm(device)
    log("phase 8c: --distributed (DDP over NCCL at world 1, sharded eval)")
    ddp = phase_ddp(device, work, ev.pop("argv"))
    log(f"  phase 8: {time.perf_counter() - t8!r} s")

    log("phase 9: the ensemble at sw 8, traced records, NaN checks")
    meas = phase_measure(device)

    log("phase 10: main_C_TUNet.py's workflow (TUNet and CUNet training, test_single, "
        "test_final on the trained TUNet)")
    single = phase_single(device, work, cli["logs"], ev.pop("common"))

    log("phase 11: Swin-UNETR")
    swin = phase_swin(device, work)
    work_dir.cleanup()

    entries = []
    for info in kernels.KERNELS:
        entries.append({
            "name": info.name, "route": "cuda", "source": info.source,
            "replaces": info.replaces, "launches": counts[info.name], **results[info.name],
            "train_launches_per_step": train["launches_per_step"][info.name],
            "train_launches_per_step_no_remat":
                train["no_remat"]["launches_per_step"][info.name],
            "train_cli_launches": cli["launches"][info.name],
            "eval_final_launches": ev["test_final"]["launches"][info.name],
            "eval_ctunet_launches": ev["test_ctunet"]["launches"][info.name],
            "dropout_train_launches_per_step": drop["launches_per_step"][info.name],
            "dropout_batch2_train_launches_per_step": drop2["launches_per_step"][info.name],
            "batchnorm_train_launches_per_step": bn["launches_per_step"][info.name],
            "ddp_train_launches_per_step": ddp["launches_per_step"][info.name],
            "sw8_launches": meas["sw8_launches"][info.name],
            **{f"{m}_train_launches_per_step{sfx}": run["launches_per_step"][info.name]
               for m in ("tunet", "cunet")
               for sfx, run in (("", single[f"{m}_steps"]),
                                ("_no_remat", single[f"{m}_steps"]["no_remat"]))},
            **{f"{m}_cli_launches": single[f"{m}_cli"]["launches"][info.name]
               for m in ("tunet", "cunet")},
            **{f"eval_single_{m}_launches": single[f"test_single_{m}"]["launches"][info.name]
               for m in ("tunet", "cunet")},
            "eval_final_trained_launches": single["test_final_trained"]["launches"][info.name],
        })
    log(json.dumps({
        "train": {**step_stats(train), "grad_worst_rel_l2": grads, "cli_wall_s": cli["wall_s"]},
        "c6_trained_check": c6,
        "eval": {name: {k: v for k, v in run.items() if k != "launches"}
                 for name, run in ev.items()},
        "train_dropout": {**step_stats(drop), "recomputed_draws": drop["recomputed_draws"]},
        "train_dropout_batch2": step_stats(drop2),
        "train_batchnorm": step_stats(bn),
        "ddp": {k: v for k, v in ddp.items() if k != "launches_per_step"},
        "measure": {k: v for k, v in meas.items() if k != "sw8_launches"},
        "single": {k: (step_stats(v) if k.endswith("_steps") else
                       {kk: vv for kk, vv in v.items() if kk != "launches"}
                       if isinstance(v, dict) else v) for k, v in single.items()},
        "swin": swin,
        "wall_s": time.perf_counter() - start,
    }))
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
