"""Median device milliseconds of a traced step's forward: the program's
``step.forward`` spans (the model's forward and the loss, a microbatch
each), each timed by its two CUDA events on its stream, summed over the
step. None on the CPU."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "step":
        return None
    return spans.median_per_unit(rec, "step.forward", lambda r: r.device_ms)
