"""Median host milliseconds the train loader takes to make a batch (the
program's ``loader.batch`` span on the prefetch thread: the dataset's get,
the crops and the augmentation, not the queue's put), over the batches
made in the traced steps."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "step":
        return None
    return spans.median_per_unit(rec, "loader.batch", lambda r: r.host_ms)
