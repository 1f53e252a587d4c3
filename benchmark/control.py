"""Readings that set the limits of ``correct``, kept apart from the runs.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 [--program] [--out FILE]

For each seed, at the cell's own sizes, prints one JSON line:

- ``control``: the numbers the cell compares, read from the plain
  reference computed in float8 (e4m3 operands of every product, e5m2
  gradients; ``reference.models.Arith(fp8=True)``) put in the program's
  place, against the float32 reference: the nearest precision below the
  configuration's bfloat16;
- training cells also ``faults``: the numbers read from the float32
  reference with a fault planted: ``half_batch`` (each step's loss the mean
  over the first half of its crops). A state left unchanged reads 1 by the
  leaf measure and needs no run; an altered crop is caught exactly by
  ``crops.max_diff``.

With ``--program``, the program's own readings instead (the lower ends):
for each seed a run's set-up and check with no window, every number the
check reads, compared or not. Needs a CUDA device for the cell's sizes; the
tests run it on the CPU at small ones.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness
from benchmark.reference import models
from benchmark.reference import train as ref_train


def hybrid_readings(cfg, tr, seed, device):
    drv = harness.load_module(harness.HERE / "drivers" / "ensemble.py")
    volume = drv._volumes(cfg, tr, seed, device)[0]
    with torch.no_grad():
        ref = drv.reference_maps(cfg, seed, volume, device)
        low = drv.reference_maps(cfg, seed, volume, device, models.Arith(fp8=True))
        from benchmark.reference import window

        _, mask = window.ensemble(low)
        return {"control": {c.name: c.value for c in drv.compare(cfg, ref, low, mask)}}


def train_readings(cfg, tr, seed, device):
    drv = harness.load_module(harness.HERE / "drivers" / "train.py")
    cases = drv._cases(cfg, tr, seed, device)
    batches, ref = drv.reference_run(cfg, tr, seed, cases, device)
    initial = {n: p.cpu() for n, p in
               harness.load_module(harness.HERE / "weights.py")
               .make(drv._shapes(cfg), seed, device).items()}

    def as_program(run):
        """A reference run in the program's place: what the driver keeps."""
        return {"batches": batches, "losses": run["losses"],
                "grad1": {n: g.cpu() for n, g in run["first_grads"].items()},
                "params3": {n: p.cpu() for n, p in run["params"].items()}}

    out = {}
    _, low = drv.reference_run(cfg, tr, seed, cases, device, models.Arith(fp8=True))
    out["control"] = drv.readings(as_program(low), batches, ref, initial)
    del low
    half = _train_half(drv, cfg, tr, seed, batches, device)
    out["faults"] = {"half_batch": drv.readings(as_program(half), batches, ref, initial)}
    return out


def _train_half(drv, cfg, tr, seed, batches, device):
    """The float32 reference's steps with half of each batch left out and
    the loss the mean over the rest."""
    weights = harness.load_module(harness.HERE / "weights.py")
    model = models.build("ctunet", cfg["model"], models.Arith(), device)
    model.load_state_dict(weights.make(drv._shapes(cfg), seed, device))
    model.train()
    half = [(torch.from_numpy(i[: len(i) // 2]).to(device),
             torch.from_numpy(l[: len(l) // 2]).to(device)) for i, l in batches]
    opt = cfg["optimizer"]
    return ref_train.train_steps(model, half, opt["lr"], opt["weight_decay"])


def program_readings(workload: str, seed: int, device: str) -> dict:
    """The program's own readings (the lower ends): a run's set-up and
    check, with no window, and every number its check read."""
    spec = harness.load_spec()
    entry = harness.cell_of(spec, workload)
    cfg, tr = harness.load_json("configs", entry["config"]), harness.load_json("traffic",
                                                                               entry["traffic"])
    driver = harness.load_module(harness.HERE / "drivers" / f"{cfg['driver']}.py")
    rec = driver.run(harness.Context(workload, cfg, tr, seed, 0.0, False, device,
                                     time.perf_counter()))
    return {"workload": workload, "seed": seed, "correct": all(c.ok() for c in rec.checks),
            "program": rec.readings or {c.name: c.value for c in rec.checks}}


def readings(workload: str, seed: int, device: str, config=None, traffic=None) -> dict:
    spec = harness.load_spec()
    entry = harness.cell_of(spec, workload)
    cfg = config or harness.load_json("configs", entry["config"])
    tr = traffic or harness.load_json("traffic", entry["traffic"])
    fn = {"ensemble": hybrid_readings, "train": train_readings}[cfg["driver"]]
    return {"workload": workload, "seed": seed, **fn(cfg, tr, seed, device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--program", action="store_true",
                    help="the program's readings instead of the control's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: needs a CUDA device", file=sys.stderr)
        return 1
    for seed in (int(s) for s in args.seeds.split(",")):
        read = program_readings if args.program else readings
        line = json.dumps(read(args.workload, seed, "cuda"))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
