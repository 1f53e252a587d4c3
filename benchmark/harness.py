"""The benchmark's harness: finds a cell's configuration, traffic, driver and
metric readers by the names in ``BENCHMARK.json``, runs the driver, and
builds the result line.

Layout (every piece found by its name, so a later cell, configuration or
metric is new files only):

- ``configs/<config>.json``: the configuration as it is run; its ``driver``
  names ``drivers/<driver>.py``, which builds the program and the reference
  from it;
- ``traffic/<traffic>.json``: the traffic mix, parameters that the driver
  and ``traffic/synth.py`` read;
- ``metrics/<metric>.py``: one reader a metric, ``read(record)`` -> a number,
  or None where the run has nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules the port must not load (compared whole, before the first dot)
FORBIDDEN = ("jax", "jaxlib", "flax", "hybrid_ctunet_tpu")


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location("benchmark_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[w['name'] for w in spec['workloads']]})")


def metrics_of(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones without
    ``trace``, the per-layer ones with it; a metric without ``workloads``
    where the cell reports the end-to-end metric it moves."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


@dataclass
class Check:
    """One number compared with its limit: correct when value <= limit."""
    name: str
    value: float
    limit: float

    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Record:
    """What a run measured; the metric readers read it."""
    unit: str  # "volume" or "step"
    units: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)  # host seconds a unit
    flops_per_unit: float = 0.0
    k8_bound_s_per_unit: float = 0.0
    window_peak_bytes: int = 0
    memory_peak_bytes: int = 0
    trace: Optional["Trace"] = None
    checks: List[Check] = field(default_factory=list)
    # every number the check read, compared or not (``control.py`` prints them)
    readings: Dict[str, object] = field(default_factory=dict)
    failed: int = 0
    # host seconds since the process started, at the end of each phase
    phases: Dict[str, float] = field(default_factory=dict)
    t0: float = 0.0

    def mark(self, phase: str) -> None:
        self.phases[phase] = time.perf_counter() - self.t0

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)


@dataclass
class Trace:
    """The device's side of the traced units: kernel time by name, the union
    of busy intervals, the traced wall and the longest idle gaps."""
    units: int
    window_s: float
    busy_s: float
    kernels: Dict[str, float]  # seconds by kernel name
    gaps: List[List]  # [[what the host did, seconds], ...], longest first


def trace_units(units: int, unit: Callable, sync: Callable[[], None]) -> "Trace":
    """``units`` calls of ``unit(span)`` under ``torch.profiler`` with the
    device's activity alone, then one more with the host's too, each inside
    a ``"unit"`` span; ``span(name)`` opens a named span
    (``torch.profiler.record_function``) that names the host's work. The
    device time, the busy union and the traced wall come from the first
    pass: recording every host op slows the host, and the idle share read
    under it is mostly the profiler's. The idle gaps are named from the
    second. The drivers trace these units apart from the timed window, so
    that the profiler's start and stop stay out of it."""
    import torch

    tp = torch.profiler
    device_only = ([tp.ProfilerActivity.CUDA] if tp.ProfilerActivity.CUDA in
                   tp.supported_activities() else [tp.ProfilerActivity.CPU])
    with tp.profile(activities=device_only) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(units):
            unit(null_span)
        sync()
        t1 = time.perf_counter()
    trace = _summary(prof.events(), units, t1 - t0)
    with tp.profile(activities={tp.ProfilerActivity.CPU, *device_only}) as prof:
        sync()
        t0 = time.perf_counter()
        with tp.record_function("unit"):
            unit(tp.record_function)
        sync()
        t1 = time.perf_counter()
    trace.gaps = _summary(prof.events(), 1, t1 - t0).gaps
    return trace


def _summary(events, units: int, wall: float) -> "Trace":
    """Device time by kernel, the union of the device's busy intervals and
    the longest idle gaps, over the traced units' wall: the first unit
    span's start to the last one's end on the profiler's clock, or ``wall``
    where the trace holds no host spans (the device's activity alone)."""
    dev, host = [], []
    annotations = set(SPAN_NAMES)
    for ev in events:
        if getattr(ev, "is_user_annotation", False):
            annotations.add(ev.name)
    for ev in events:
        tr = ev.time_range
        if "CUDA" in str(getattr(ev, "device_type", "")):
            if ev.name not in annotations and not getattr(ev, "is_user_annotation", False):
                dev.append((tr.start, tr.end, ev.name))
        else:
            host.append((tr.start, tr.end, ev.name))
    dev.sort()
    kernels: Dict[str, float] = {}
    for s, e, n in dev:
        kernels[n] = kernels.get(n, 0.0) + (e - s) * 1e-6
    spans = [(s, e) for s, e, n in host if n == "unit"]
    lo = min(s for s, _ in spans) if spans else (dev[0][0] if dev else 0)
    hi = max(e for _, e in spans) if spans else (dev[-1][1] if dev else 0)
    merged = []
    for s, e, _ in dev:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps, prev = [], lo
    for s, e in merged:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    named = [[_host_at(host, (a + b) / 2), d * 1e-6] for d, a, b in gaps[:10]]
    return Trace(units=units, window_s=(hi - lo) * 1e-6 if spans else wall, busy_s=busy,
                 kernels=kernels, gaps=named)


def _host_at(host, t) -> str:
    """The harness span and the innermost host event running at ``t``."""
    covering = sorted((s, n) for s, e, n in host if s <= t <= e)
    if not covering:
        return "host idle"
    outer = [n for _, n in covering if n in SPAN_NAMES]
    return "/".join(dict.fromkeys([*outer[-1:], covering[-1][1]]))


# the harness's own spans, the names an idle gap is charged to first
SPAN_NAMES = ("unit", "ctunet_half", "tunet_half", "ensemble", "data_wait", "train_step")


class null_span:
    """A span that records nothing (untraced units)."""

    def __init__(self, name: str = ""):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@dataclass
class Context:
    """What a driver gets."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # the process's start on the host clock


def run_cell(spec: dict, cell: str, seed: int, seconds: float, trace: bool, device: str,
             t0: float, config: Optional[dict] = None, traffic: Optional[dict] = None) -> dict:
    """One run of ``cell``; the result line's fields. ``config`` and
    ``traffic`` replace the cell's files (the tests' small sizes)."""
    entry = cell_of(spec, cell)
    config = config or load_json("configs", entry["config"])
    traffic = traffic or load_json("traffic", entry["traffic"])
    driver = load_module(HERE / "drivers" / f"{config['driver']}.py")
    ctx = Context(cell, config, traffic, seed, seconds, trace, device, t0)
    rec: Record = driver.run(ctx)
    metrics = {}
    for m in metrics_of(spec, cell, trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is None:
            if m in spec["end_to_end"]:
                raise RuntimeError(f"end-to-end metric {m['name']} has nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = bool(rec.checks) and all(c.ok() for c in rec.checks)
    out = {"correct": correct, "attempted": rec.units, "failed": rec.failed if correct else
           max(rec.failed, 1), "metrics": metrics, "device": device_info(device, rec, trace)}
    if trace and rec.trace is not None:
        top = sorted(rec.trace.kernels.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in top],
                            "idle_gaps": [[n[:160], s] for n, s in rec.trace.gaps]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in rec.checks}
    print(json.dumps({"phases_s": rec.phases}), file=sys.stderr)
    return out


def device_info(device: str, rec: Record, trace: bool) -> dict:
    import torch

    if device.startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = rec.memory_peak_bytes
    if trace and rec.trace is not None:
        info["busy_s"] = rec.trace.busy_s
        info["window_s"] = rec.trace.window_s
    return info


def kernel_seconds(trace: Trace, symbols) -> float:
    """Device seconds of the kernels whose name holds one of ``symbols`` as
    a whole identifier."""
    import re

    pat = re.compile(r"(?:^|[^A-Za-z0-9_])(?:%s)(?:[^A-Za-z0-9_]|$)" % "|".join(symbols))
    return sum(s for name, s in trace.kernels.items() if pat.search(name))


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))
