"""Median device milliseconds a traced step spends in the program's
``remat.recompute`` spans (each rematerialized region run again in the
backward, on autograd's thread), each timed by its two CUDA events on its
stream, summed over the step. None on the CPU, and where no region is
recomputed."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "step":
        return None
    return spans.median_per_unit(rec, "remat.recompute", lambda r: r.device_ms)
