"""Driver of the Hybrid-CTUNet ensemble's cells: one client in a closed
loop, one volume after another, each through the program's CTUNet engine
(res head only), its TUNet engine and the ensemble (softmax mean, argmax),
as ``cli/bench.py`` runs them.

Set-up: weights from the seed on the device, both models loaded, the
traffic's volumes made on the device, one volume through both halves to
warm up. Window: volumes until ``--seconds`` have passed; each half timed on
the host clock, fenced on its map. Check: one finished volume drawn from the
seed (reservoir sampling over the window), recomputed by the plain float32
reference once the window has closed and the program is freed: the two
blended maps by relative L2, the ensemble's mask by the mean gap between
the reference's best probability and the probability it gives the
program's class.
"""
from __future__ import annotations

import gc
import itertools
import random
import time

import torch

from benchmark import harness, weights
from benchmark.reference import cost, models, window
from benchmark.traffic import synth


def _program(cfg, device, dtype):
    from hybrid_ctunet_tpu_torch.models import CTUNet, TUNet

    m = cfg["model"]
    tunet = dict(img_size=tuple(m["roi"][:2]), frames=m["roi"][2], patch_frame=m["patch_frame"],
                 hidden_size=m["hidden_size"], num_depths=m["num_depths"], mlp_dim=m["mlp_dim"],
                 num_heads=m["num_heads"], window=m["window"], dim_conv_stem=m["feature_size"])
    ct = CTUNet(out_channels=m["out_channels"], model_depth=m["model_depth"],
                in_channels=m["in_channels"], dtype=dtype, device=device, **tunet)
    tu = TUNet(out_channels=m["out_channels"], in_channels=m["in_channels"], dtype=dtype,
               device=device, **tunet)
    return ct, tu


def _state(cfg, seed, device):
    """The seeded state dicts of the CTUNet and the TUNet (one stream)."""
    m = cfg["model"]
    ct_shapes = models.parameter_shapes(models.build("ctunet", m, models.Arith(), "meta"))
    tu_shapes = models.parameter_shapes(models.build("tunet", m, models.Arith(), "meta"))
    ct_n = sum(torch.Size(s).numel() for _, s in ct_shapes)
    return (weights.make(ct_shapes, seed, device),
            weights.make(tu_shapes, seed, device, offset=ct_n))


def _volumes(cfg, tr, seed, device):
    inten = cfg["intensity"]
    out = []
    for i in range(tr["distinct_cases"]):
        hu, _ = synth.case(tr["volume"], cfg["model"]["out_channels"], seed, i, device)
        out.append(synth.window(hu, **inten)[None, ..., None].contiguous())
    return out


def run(ctx: harness.Context) -> harness.Record:
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    from hybrid_ctunet_tpu_torch.cli.bench import ensemble, make_ctunet_engine, make_engine
    from hybrid_ctunet_tpu_torch.models.layers import remat_blocks

    # the program's bench entry runs with these (cli/bench.py set_precision_flags)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dtype = getattr(torch, cfg["compute_dtype"])
    rec = harness.Record(unit="volume", t0=ctx.t0)
    rec.mark("imports")
    m = cfg["model"]
    ct_model, tu_model = _program(cfg, device, dtype)
    ct_sd, tu_sd = _state(cfg, ctx.seed, device)
    ct_model.load_state_dict(ct_sd)
    tu_model.load_state_dict(tu_sd)
    del ct_sd, tu_sd
    ct_model.eval()
    tu_model.eval()
    ct_engine = make_ctunet_engine(ct_model, tuple(m["roi"]), cfg["ctunet_overlap"], tr["sw_ct"])
    tu_engine = make_engine(tu_model, tuple(m["roi"]), cfg["tunet_overlap"], tr["sw_tu"])
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    sync()
    rec.mark("weights")
    volumes = _volumes(cfg, tr, ctx.seed, device)
    sync()
    rec.mark("cases")

    def volume(v, span=harness.null_span):
        with torch.inference_mode():
            t = time.perf_counter()
            with span("ctunet_half"):
                (res_map,) = ct_engine(v)
                sync()
            t1 = time.perf_counter()
            with span("tunet_half"):
                (tu_map,) = tu_engine(v)
                sync()
            t2 = time.perf_counter()
            with span("ensemble"):
                _, mask = ensemble(res_map, tu_map)
                sync()
        return res_map, tu_map, mask, t1 - t, t2 - t1

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
            res_map, tu_map, mask, t_ct, t_tu = volume(volumes[i % len(volumes)])
            rec.units += 1
            rec.span("ctunet_half", t_ct)
            rec.span("tunet_half", t_tu)
            if pick.random() * rec.units < 1.0:  # reservoir: each finished volume alike
                kept = (i % len(volumes), res_map, tu_map, mask)
            del res_map, tu_map, mask
        rec.window_s = time.perf_counter() - start
    rec.mark("window")
    if device.startswith("cuda"):
        rec.window_peak_bytes = rec.memory_peak_bytes = torch.cuda.max_memory_allocated()
    del ct_engine, tu_engine, ct_model, tu_model
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    _costs(rec, cfg, tr, dtype)
    rec.checks = check(cfg, ctx.seed, volumes[kept[0]], kept[1:], device)
    rec.failed = int(not all(c.ok() for c in rec.checks))
    rec.mark("check")
    return rec


def _costs(rec, cfg, tr, dtype):
    """Useful FLOPs and K8's least time of a volume, from the reference
    models' chunks (a trailing chunk pro rata: both are linear in windows)."""
    m = cfg["model"]
    ct_flops, ct_sites = cost.forward_cost("ctunet", m, tr["sw_ct"], True)
    tu_flops, tu_sites = cost.forward_cost("tunet", m, tr["sw_tu"], False)
    shape = tuple(tr["volume"])
    n_ct = len(window.window_starts(shape, m["roi"], cfg["ctunet_overlap"])) / tr["sw_ct"]
    n_tu = len(window.window_starts(shape, m["roi"], cfg["tunet_overlap"])) / tr["sw_tu"]
    rec.flops_per_unit = ct_flops * n_ct + tu_flops * n_tu
    item = torch.finfo(dtype).bits // 8
    rec.k8_bound_s_per_unit = (cost.norm_bytes(ct_sites, item) * n_ct
                               + cost.norm_bytes(tu_sites, item) * n_tu) / cost.HBM_BYTES_PER_S


def reference_maps(cfg, seed, volume, device, ar=None):
    """The reference's two blended maps of ``volume`` (float32, or ``ar``'s
    arithmetic): each model built, loaded with the seeded weights, run and
    dropped in turn."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ar = ar or models.Arith()
    m = cfg["model"]
    ct_sd, tu_sd = _state(cfg, seed, device)
    maps = []
    for kind, sd, overlap in (("ctunet", ct_sd, cfg["ctunet_overlap"]),
                              ("tunet", tu_sd, cfg["tunet_overlap"])):
        model = models.build(kind, m, ar, device)
        model.load_state_dict(sd)
        model.eval()
        predict = models.window_predictor(model, kind, res_only=True)
        maps.append(window.blend(predict, volume, m["roi"], overlap, cfg["reference_chunk"]))
        del model
    return maps


def compare(cfg, ref_maps, maps, mask):
    """The numbers compared: each map's relative L2 against the
    reference's, and the mask's mean probability gap: over the voxels, the
    reference's best ensemble probability less the probability it gives
    the program's class (the widest gap, a maximum over 8.4 million
    voxels, read 0.12-0.21 on sound runs and 0.50-0.57 on the control: it
    did not separate them threefold)."""
    lim = cfg["limits"]
    checks = []
    for name, ref, got in zip(("ctunet_map.rel_l2", "tunet_map.rel_l2"), ref_maps, maps):
        rel = float((got.float() - ref).norm() / ref.norm())
        checks.append(harness.Check(name, rel, lim[name]))
    prob, _ = window.ensemble(ref_maps)
    best = prob.max(-1).values
    got = prob.gather(-1, mask.long().reshape(*prob.shape[:-1], 1))[..., 0]
    checks.append(harness.Check("mask.mean_gap", float((best - got).double().mean()),
                                lim["mask.mean_gap"]))
    return checks


def check(cfg, seed, volume, kept, device):
    res_map, tu_map, mask = kept
    with torch.no_grad():
        ref_maps = reference_maps(cfg, seed, volume, device)
        return compare(cfg, ref_maps, (res_map, tu_map), mask)
