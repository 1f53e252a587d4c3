"""Small sizes for the benchmark's CPU tests: the configurations and traffic
of the cells at widths and volumes a CPU run holds (ROI 32, ResNet-50, a
two-block ViT of 64; never below 32^3, where the deep stages normalize over
a handful of voxels)."""
from __future__ import annotations

import copy
import time

from benchmark import harness

TINY = dict(roi=[32, 32, 32], in_channels=1, out_channels=3, model_depth=50, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2, feature_size=16)


def sizes(cell: str, dtype: str = "bfloat16", depth: int = 50):
    """(config, traffic) of ``cell`` cut to the CPU's sizes, computing in
    ``dtype``, with a ResNet of ``depth``."""
    spec = harness.load_spec()
    entry = harness.cell_of(spec, cell)
    cfg = copy.deepcopy(harness.load_json("configs", entry["config"]))
    tr = copy.deepcopy(harness.load_json("traffic", entry["traffic"]))
    cfg["model"] = dict(TINY, model_depth=depth)
    cfg["compute_dtype"] = dtype
    if "volume" in tr:
        tr["volume"] = [48, 48, 40]
        tr["distinct_cases"] = 2
    else:
        tr["case_shape"] = [48, 48, 40]
        tr["cases"] = 2
    tr["trace_units"] = 1
    return cfg, tr


def run(cell: str, *, seed: int = 2 ** 31 + 7, trace: bool = False, dtype: str = "bfloat16",
        seconds: float = 0.5, limits=None) -> dict:
    """One run of ``cell`` on the CPU at the small sizes."""
    cfg, tr = sizes(cell, dtype)
    if limits:
        cfg["limits"].update(limits)
    return harness.run_cell(harness.load_spec(), cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), config=cfg, traffic=tr)
