"""Median device milliseconds of a traced step's backward: the program's
``step.backward`` spans (``loss.backward()``, a microbatch each, the
recompute included), each timed by its two CUDA events on its stream,
summed over the step. None on the CPU."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "step":
        return None
    return spans.median_per_unit(rec, "step.backward", lambda r: r.device_ms)
