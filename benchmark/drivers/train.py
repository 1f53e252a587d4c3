"""Driver of the CTUNet training cells: the program's train step
(``train/steps.py::make_train_step("ctunet", ...)``, AdamW) on batches from
its ``TrainLoader`` over the cases of ``data/dataset.py::CachedDataset``,
as ``cli/train_main.py`` trains, with block rematerialization on or off as
the traffic file says.

Set-up: the traffic's cases made from the seed and written as NIfTI under
``$TMPDIR``, loaded and preprocessed by the program's dataset, the model
loaded with the seeded weights, then the first three steps: they warm up
every shape, and what the check needs is kept from them (the batches, the
losses, AdamW's first moment after step 1, the parameters after step 3).
Window: steps until ``--seconds`` have passed, the loader's ``next()``
included; the device drained at the end. Check, once the window has closed
and the program is freed: the reference makes the same crops from the same
cases and seed (they must be equal), and follows the first three steps in
float32. ``readings`` reads each step's loss, the first gradient and each
leaf's change over the three steps; the configuration's ``limits`` name the
numbers compared: the crops, the first gradient by the median leaf's gap of
norms and by the relative L2 of the whole, and the change by the median
leaf's gap (the worst leaf's gap swings from seed to seed with the
rounding of one deep conv, and the loss moves too little to tell the
control from a sound run).
"""
from __future__ import annotations

import gc
import os
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import harness, weights
from benchmark.reference import cost, data, models
from benchmark.reference import train as ref_train
from benchmark.traffic import synth

CHECK_STEPS = 3
BETA1 = 0.9  # AdamW's first-moment decay (the program's optimizer, train/state.py)


def _shapes(cfg):
    return models.parameter_shapes(models.build("ctunet", cfg["model"], models.Arith(), "meta"))


def _cases(cfg, tr, seed, device):
    """The traffic's cases, int16 HU with uint8 labels (a CT file's types),
    made on ``device`` and brought to the host as numpy: the raw data that
    the program reads from files and the reference reads directly."""
    out = []
    for i in range(tr["cases"]):
        hu, lab = synth.case(tr["case_shape"], cfg["model"]["out_channels"], seed, i, device)
        out.append((hu.to(torch.int16).cpu().numpy(), lab.cpu().numpy()))
    return out


def _write_cases(cases, pixdim) -> list:
    """NIfTI files of the cases under ``$TMPDIR`` (a fixed directory there)."""
    from benchmark.traffic.nifti import save

    root = Path(os.environ.get("TMPDIR", "/tmp")) / "hybrid_ctunet_benchmark_cases"
    root.mkdir(parents=True, exist_ok=True)
    affine = np.diag([*pixdim, 1.0])
    files = []
    for i, (img, lab) in enumerate(cases):
        ip, lp = root / f"case{i:03d}_image.nii", root / f"case{i:03d}_label.nii"
        save(ip, img, affine)
        save(lp, lab, affine)
        files.append({"image": str(ip), "label": str(lp)})
    return files


def _batches(loader):
    epoch = 0
    while True:
        loader.set_epoch(epoch)
        yield from loader
        epoch += 1


def run(ctx: harness.Context) -> harness.Record:
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    from hybrid_ctunet_tpu_torch.data.dataset import CachedDataset, TrainLoader
    from hybrid_ctunet_tpu_torch.models import CTUNet
    from hybrid_ctunet_tpu_torch.models.layers import remat_blocks
    from hybrid_ctunet_tpu_torch.train.state import make_optimizer
    from hybrid_ctunet_tpu_torch.train.steps import make_train_step

    m, opt_cfg, inten = cfg["model"], cfg["optimizer"], cfg["intensity"]
    dtype = getattr(torch, cfg["compute_dtype"])
    rec = harness.Record(unit="step", t0=ctx.t0)
    rec.mark("imports")
    cases = _cases(cfg, tr, ctx.seed, device)
    files = _write_cases(cases, cfg["pixdim"])
    rec.mark("cases")
    dataset = CachedDataset(files, cache_num=len(files), resample_labels=True,
                            pixdim=tuple(cfg["pixdim"]), **inten)
    rec.mark("dataset")
    loader = TrainLoader(dataset, batch_size=tr["batch_size"], roi_size=tuple(m["roi"]),
                         num_samples=tr["num_samples"], seed=ctx.seed, aug_cfg=cfg["augment"],
                         prefetch=tr["prefetch"])
    model = CTUNet(out_channels=m["out_channels"], model_depth=m["model_depth"],
                   in_channels=m["in_channels"], img_size=tuple(m["roi"][:2]), frames=m["roi"][2],
                   patch_frame=m["patch_frame"], hidden_size=m["hidden_size"],
                   num_depths=m["num_depths"], mlp_dim=m["mlp_dim"], num_heads=m["num_heads"],
                   window=m["window"], dim_conv_stem=m["feature_size"], dtype=dtype,
                   device=device)
    rec.mark("model")
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    state = weights.make(_shapes(cfg), ctx.seed, device)
    sync()
    rec.mark("weights_made")
    model.load_state_dict(state)
    del state
    sync()
    rec.mark("weights")
    model.train()
    optimizer = make_optimizer(model.parameters(), "adamw", reg_weight=opt_cfg["weight_decay"])
    step = make_train_step("ctunet", model, optimizer)
    lr = opt_cfg["lr"]
    rec.mark("step")
    batches = _batches(loader)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())

    def to_device(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t[..., None] if t.ndim == 4 else t).to(device)

    kept = {"batches": [], "losses": []}
    with remat_blocks(tr["block_remat"]):
        for k in range(CHECK_STEPS):
            image, label = next(batches)
            out = step(to_device(image).float(), to_device(label), lr)
            kept["batches"].append((image.copy(), label.copy()))
            kept["losses"].append(float(out["loss"]))
            if k == 0:
                # a step that left no state behind read as a zero gradient
                kept["grad1"] = {n: (optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                                     / (1 - BETA1)).cpu() for n, p in zip(names, params)}
        kept["params3"] = {n: p.detach().to("cpu", copy=True) for n, p in zip(names, params)}
        rec.mark("warmup")

        def one_step(span=harness.null_span):
            t = time.perf_counter()
            with span("data_wait"):
                image, label = next(batches)
            wait = time.perf_counter() - t
            with span("train_step"):
                step(to_device(image).float(), to_device(label), lr)
            return wait

        if ctx.trace:
            rec.trace = harness.trace_units(tr["trace_units"], one_step, sync)
            rec.mark("trace")
        sync()
        setup_peak = torch.cuda.max_memory_allocated() if device.startswith("cuda") else 0
        if device.startswith("cuda"):
            torch.cuda.reset_peak_memory_stats()
        rec.setup_s = time.perf_counter() - ctx.t0
        start = time.perf_counter()
        while time.perf_counter() - start < ctx.seconds:
            rec.span("data_wait", one_step())
            rec.units += 1
        sync()
        rec.window_s = time.perf_counter() - start
    rec.mark("window")
    batches.close()
    if device.startswith("cuda"):
        rec.window_peak_bytes = torch.cuda.max_memory_allocated()
        rec.memory_peak_bytes = max(setup_peak, rec.window_peak_bytes)
    del step, optimizer, model, params
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    _costs(rec, cfg, tr, dtype)
    rec.readings, rec.checks = check(cfg, tr, ctx.seed, cases, kept, device)
    rec.failed = int(not all(c.ok() for c in rec.checks))
    rec.mark("check")
    return rec


def _costs(rec, cfg, tr, dtype):
    """Useful FLOPs of a step (3 x the full forward of its crops: forward
    and backward, the recompute not counted) and K8's least time (each
    forward InstanceNorm site once)."""
    crops = tr["batch_size"] * tr["num_samples"]
    flops, sites = cost.forward_cost("ctunet", cfg["model"], crops, False)
    rec.flops_per_unit = 3 * flops
    item = torch.finfo(dtype).bits // 8
    rec.k8_bound_s_per_unit = cost.norm_bytes(sites, item) / cost.HBM_BYTES_PER_S


class _Prepped:
    """The cases preprocessed as the reference does, each when first read:
    the check's steps read only the first few of the order."""

    def __init__(self, cases, cfg):
        self.cases, self.cfg, self.done = cases, cfg, {}

    def __len__(self):
        return len(self.cases)

    def __getitem__(self, i):
        if i not in self.done:
            img, lab = self.cases[i]
            pixdim = self.cfg["pixdim"]
            self.done[i] = data.preprocess(img, lab, np.diag([*pixdim, 1.0]), pixdim,
                                           **self.cfg["intensity"])
        return self.done[i]


def reference_run(cfg, tr, seed, cases, device, ar=None):
    """The reference's crops of the first steps, and its steps on them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = data.batches(_Prepped(cases, cfg), seed, CHECK_STEPS, cfg["model"]["roi"],
                           tr["num_samples"], cfg["augment"])
    model = models.build("ctunet", cfg["model"], ar or models.Arith(), device)
    model.load_state_dict(weights.make(_shapes(cfg), seed, device))
    model.train()
    on_dev = [(torch.from_numpy(i).to(device), torch.from_numpy(l).to(device)) for i, l in batches]
    opt = cfg["optimizer"]
    return batches, ref_train.train_steps(model, on_dev, opt["lr"], opt["weight_decay"])


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Each leaf's gap between the two norms, over the larger of the
    reference leaf's norm and the median leaf's norm."""
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    median = statistics.median(norms.values())
    return {n: abs(float(got[n].double().norm()) - w) / max(w, median)
            for n, w in norms.items() if keep is None or n in keep}


def leaf_gap(got: dict, want: dict, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, want, keep).values())


def _leaf_readings(name: str, got: dict, want: dict, keep=None) -> dict:
    """The gaps of norms by the worst and by the median leaf, the worst
    leaf's name and its norm over the median leaf's, and the relative L2 of
    the whole difference."""
    gaps = leaf_gaps(got, want, keep)
    worst = max(gaps, key=gaps.get)
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    diff = sum(float((got[n].double() - want[n].double()).square().sum()) for n in gaps)
    ref = sum(norms[n] ** 2 for n in gaps)
    return {f"{name}.leaf_gap": gaps[worst], f"{name}.median_gap": statistics.median(gaps.values()),
            f"{name}.rel_l2": (diff / ref) ** 0.5, f"{name}.worst": worst,
            f"{name}.worst_norm": norms[worst] / statistics.median(norms.values())}


def readings(program: dict, ref_batches, ref: dict, initial: dict) -> dict:
    """Every number the check can compare (see the module's docstring), and
    the worst leaves by name."""
    crop = 0.0
    for (pi, pl), (ri, rl) in zip(program["batches"], ref_batches):
        if pi.shape != ri.shape or pl.shape != rl.shape:
            crop = float("inf")
            break
        crop = max(crop, float(np.abs(pi - ri).max()), float((pl != rl).sum()))
    gaps = [abs(a - b) / abs(b) for a, b in zip(program["losses"], ref["losses"])]
    ref_grads = {n: g.cpu() for n, g in ref["first_grads"].items()}
    # leaves the reference's loss does not move: under a thousandth of the
    # median leaf's gradient norm, their change is AdamW's round-off alone
    gnorm = {n: float(g.double().norm()) for n, g in ref_grads.items()}
    floor = 1e-3 * statistics.median(gnorm.values())
    moved = {n for n, v in gnorm.items() if v >= floor}
    change_ref = {n: p.cpu() - initial[n] for n, p in ref["params"].items()}
    change_got = {n: program["params3"][n] - initial[n] for n in change_ref}
    return {"crops.max_diff": crop, "loss.rel_gap": max(gaps), "loss1.rel_gap": gaps[0],
            **_leaf_readings("grad1", program["grad1"], ref_grads),
            **_leaf_readings("change3", change_got, change_ref, keep=moved)}


def compare(cfg, got: dict):
    """The numbers of ``got`` (``readings``) that the configuration's
    ``limits`` name, each with its limit."""
    return [harness.Check(name, got[name], lim) for name, lim in cfg["limits"].items()]


def check(cfg, tr, seed, cases, kept, device):
    ref_batches, ref = reference_run(cfg, tr, seed, cases, device)
    initial = {n: p.cpu() for n, p in weights.make(_shapes(cfg), seed, device).items()}
    got = readings(kept, ref_batches, ref, initial)
    return got, compare(cfg, got)
