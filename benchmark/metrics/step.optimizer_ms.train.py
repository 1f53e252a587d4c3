"""Median device milliseconds of a traced step's update: the program's
``step.optimizer`` span (the learning rate set and AdamW's step), timed
by its two CUDA events on its stream. None on the CPU."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "step":
        return None
    return spans.median_per_unit(rec, "step.optimizer", lambda r: r.device_ms)
