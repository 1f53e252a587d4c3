"""Median device milliseconds a traced volume inside the program's
``swin.decoder`` spans (Swin-UNETR's conv encoders, decoders and head, once
per chunk's predictor call), each timed by its two CUDA events, summed over
the volume's chunks. None where the program keeps no such span or on the
CPU."""
from pathlib import Path

from benchmark import harness

spans = harness.load_module(Path(__file__).with_name("step.host_ms.train.py"))


def read(rec):
    if rec.unit != "volume":
        return None
    return spans.median_per_unit(rec, "swin.decoder", lambda r: r.device_ms)
