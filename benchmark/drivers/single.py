"""Driver of single-model inference cells (Swin-UNETR): one client in a
closed loop, one volume after another through the program's single-output
sliding-window engine (``cli/bench.py::make_engine``, the eval CLI's), then
the float32 softmax of the blended map and its argmax.

Set-up: weights from the seed on the device, the model loaded, the
traffic's volumes made on the device (``traffic/synth.py``, as the ensemble
cells make theirs), one volume through the engine to warm up. Window:
volumes until ``--seconds`` have passed, each timed on the host clock,
fenced on its map. Check: one finished volume drawn from the seed
(reservoir sampling over the window), recomputed by the plain float32
reference (``reference/swin_unetr.py``) once the window has closed and the
program is freed: the blended map by relative L2, the mask by the mean gap
between the reference's best probability and the probability it gives the
program's class.

The record's costs come from the reference on the meta device: useful
FLOPs (``cost._Count``), K8's least time (the InstanceNorm sites) and K2's
(``k2_bound_s_per_unit``: per window and head the larger of 4 T^2 dh FLOPs
at the bf16 peak and q, k, v read and the output written once in bf16 at
the memory rate).

    python3 -m benchmark.drivers.single --workload <cell> --seeds 11,12,13 [--out FILE]

prints, for each seed, the float8 control's readings at the cell's size
(the reference with e4m3 operands of every product, against the float32
reference): the lower precision that the limits must refuse. The
program's own readings are ``python3 -m benchmark.control --program``'s.
"""
from __future__ import annotations

import argparse
import gc
import itertools
import json
import random
import sys
import time

import torch

from benchmark import harness, weights
from benchmark.reference import cost, models, window
from benchmark.reference import swin_unetr as ref_swin


def _program(cfg, device, dtype):
    from hybrid_ctunet_tpu_torch.models import SwinUNETR

    m = cfg["model"]
    return SwinUNETR(img_size=tuple(m["roi"]), in_channels=m["in_channels"],
                     out_channels=m["out_channels"], feature_size=m["feature_size"],
                     depths=tuple(m["depths"]), num_heads=tuple(m["num_heads"]),
                     window_size=m["window_size"], mlp_ratio=m["mlp_ratio"], dtype=dtype,
                     device=device)


def _state(cfg, seed, device):
    model = ref_swin.build(cfg["model"], models.Arith(), "meta")
    return weights.make(models.parameter_shapes(model), seed, device)


# the traffic's volumes, made as the ensemble cells make theirs
_volumes = harness.load_module(harness.HERE / "drivers" / "ensemble.py")._volumes


def run(ctx: harness.Context) -> harness.Record:
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    from hybrid_ctunet_tpu_torch.cli.bench import make_engine, set_precision_flags
    from hybrid_ctunet_tpu_torch.models.layers import remat_blocks

    set_precision_flags()  # as the program's bench entry runs
    dtype = getattr(torch, cfg["compute_dtype"])
    rec = harness.Record(unit="volume", t0=ctx.t0)
    rec.mark("imports")
    m = cfg["model"]
    model = _program(cfg, device, dtype)
    model.load_state_dict(_state(cfg, ctx.seed, device))
    model.eval()
    engine = make_engine(model, tuple(m["roi"]), cfg["overlap"], tr["sw"])
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    sync()
    rec.mark("weights")
    volumes = _volumes(cfg, tr, ctx.seed, device)
    sync()
    rec.mark("cases")

    def volume(v, span=harness.null_span):
        with torch.inference_mode():
            t = time.perf_counter()
            with span("single"):
                (logits,) = engine(v)
                prob = torch.softmax(logits.float(), -1)
                mask = prob.argmax(-1).to(torch.int32)
                sync()
        return logits, mask, time.perf_counter() - t

    with remat_blocks(False):  # an inference-only process, as cli/bench.py
        volume(volumes[0])
        rec.mark("warmup")
        if ctx.trace:
            order = itertools.count()
            rec.trace = harness.trace_units(
                tr["trace_units"], lambda span: volume(volumes[next(order) % len(volumes)], span),
                sync)
            rec.mark("trace")
        pick = random.Random(ctx.seed ^ 0x5EED)
        kept = None
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        rec.setup_s = time.perf_counter() - ctx.t0
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            i = rec.units
            logits, mask, seconds = volume(volumes[i % len(volumes)])
            rec.units += 1
            rec.span("volume", seconds)
            if pick.random() * rec.units < 1.0:  # reservoir: each finished volume alike
                kept = (i % len(volumes), logits, mask)
            del logits, mask
        rec.window_s = time.perf_counter() - start
    rec.mark("window")
    if kept is None:  # no window (the control's program readings): the warm-up's volume
        logits, mask, _ = volume(volumes[0])
        kept = (0, logits, mask)
    if device.startswith("cuda"):
        rec.window_peak_bytes = rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del engine, model
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    _costs(rec, cfg, tr, dtype)
    rec.checks = check(cfg, ctx.seed, volumes[kept[0]], kept[1:], device)
    rec.failed = int(not all(c.ok() for c in rec.checks))
    rec.mark("check")
    return rec


def k2_bound_s(sites, item_bytes: int) -> float:
    """The least time of window attentions ``sites`` ((windows, heads,
    tokens, head width) each): per window and head, the larger of QK^T and
    PV's 4 T^2 dh FLOPs at the bf16 peak and q, k, v read and the output
    written once (4 T dh elements) at the memory rate."""
    total = 0.0
    for n, heads, t, dh in sites:
        flops = 4.0 * t * t * dh / cost.PEAK_BF16_FLOP_PER_S
        data = 4.0 * t * dh * item_bytes / cost.HBM_BYTES_PER_S
        total += n * heads * max(flops, data)
    return total


def _costs(rec, cfg, tr, dtype):
    """Useful FLOPs, K8's and K2's least time of a volume, from one chunk of
    the reference on the meta device (a trailing chunk pro rata: all three
    are linear in windows)."""
    m = cfg["model"]
    ar = models.Arith()
    model = ref_swin.build(m, ar, "meta")
    x = torch.empty((tr["sw"], *m["roi"], m["in_channels"]), device="meta")
    ar.recording = True
    with torch.no_grad(), cost._Count() as count:
        model(x)
    chunks = len(window.window_starts(tuple(tr["volume"]), m["roi"], cfg["overlap"])) / tr["sw"]
    item = torch.finfo(dtype).bits // 8
    rec.flops_per_unit = count.flops * chunks
    rec.k8_bound_s_per_unit = cost.norm_bytes(ar.norm_sites, item) * chunks / cost.HBM_BYTES_PER_S
    rec.k2_bound_s_per_unit = k2_bound_s(ar.attn_sites, item) * chunks


def reference_map(cfg, seed, volume, device, ar=None):
    """The reference's blended map of ``volume`` (float32, or ``ar``'s
    arithmetic)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m = cfg["model"]
    model = ref_swin.build(m, ar or models.Arith(), device)
    model.load_state_dict(_state(cfg, seed, device))
    model.eval()
    out = window.blend(model, volume, m["roi"], cfg["overlap"], cfg["reference_chunk"])
    del model
    return out


def compare(cfg, ref_map, got_map, mask):
    """The numbers compared: the map's relative L2 against the reference's,
    and the mask's mean probability gap: over the voxels, the reference's
    best probability less the probability it gives the program's class."""
    lim = cfg["limits"]
    rel = float((got_map.float() - ref_map).norm() / ref_map.norm())
    prob = torch.softmax(ref_map, -1)
    best = prob.max(-1).values
    got = prob.gather(-1, mask.long().reshape(*prob.shape[:-1], 1))[..., 0]
    return [harness.Check("swin_map.rel_l2", rel, lim["swin_map.rel_l2"]),
            harness.Check("mask.mean_gap", float((best - got).double().mean()),
                          lim["mask.mean_gap"])]


def check(cfg, seed, volume, kept, device):
    got_map, mask = kept
    with torch.no_grad():
        return compare(cfg, reference_map(cfg, seed, volume, device), got_map, mask)


def control_readings(cfg, tr, seed, device) -> dict:
    """The float8 control's numbers at the cell's size: the reference in
    float8 arithmetic in the program's place."""
    volume = _volumes(cfg, tr, seed, device)[0]
    with torch.no_grad():
        ref = reference_map(cfg, seed, volume, device)
        low = reference_map(cfg, seed, volume, device, models.Arith(fp8=True))
        mask = torch.softmax(low, -1).argmax(-1)
        return {c.name: c.value for c in compare(cfg, ref, low, mask)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the float8 control's readings of a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    entry = harness.cell_of(harness.load_spec(), args.workload)
    cfg = harness.load_json("configs", entry["config"])
    tr = harness.load_json("traffic", entry["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": control_readings(cfg, tr, seed, "cuda")})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
