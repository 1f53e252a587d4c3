"""Median host milliseconds a traced volume inside the program's
``engine.predict`` spans (each chunk's predictor call: the host's enqueue
of the model's work), summed over the chunks of both engines' calls for
the volume. Beside ``device.busy_ms.infer`` it says how close the host's
enqueue comes to the device's time."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "volume":
        return None
    return spans.median_per_unit(rec, "engine.predict", lambda r: r.host_ms)
