"""The benchmark's readers of the program's spans (``benchmark/metrics/``,
``"source": "program_span"``) on a hand-built store and ``Record``: only
spans that started in the traced window (the end of the warm-up to the end
of the trace), of each owner the first ``trace.units`` units, nothing for
a device metric without CUDA events or from a program without spans; and a
traced run of each cell on the CPU at small sizes, which reports the
host-side ones."""
import collections
import statistics

import pytest

from benchmark import harness
from hybrid_ctunet_tpu_torch.utils import profiling
from hybrid_ctunet_tpu_torch.utils.profiling import SpanRecord

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

bench_tiny = harness.load_module(harness.HERE / "tests" / "bench_tiny.py")

T0 = 100.0  # the process's start, host seconds
PHASES = {"warmup": 10.0, "trace": 14.0}  # the traced window: 110-114 s
DEVICE = ["step.forward_ms.train", "step.backward_ms.train", "step.optimizer_ms.train",
          "remat.recompute_ms.train"]
HOST = {"step.host_ms.train": "step", "data.produce_ms.train": "step",
        "engine.enqueue_ms.infer": "volume"}


def _read(metric, rec):
    return harness.load_module(harness.HERE / "metrics" / f"{metric}.py").read(rec)


def _record(unit, units):
    rec = harness.Record(unit=unit, t0=T0, phases=dict(PHASES))
    rec.trace = harness.Trace(units=units, window_s=1.0, busy_s=0.5, kernels={}, gaps=[])
    return rec


def _span(name, unit, owner, start_s, host_ms=0.0, device_ms=None, parent=None):
    t0 = int(start_s * 1e9)
    return SpanRecord(name, unit, owner, parent, t0, t0 + int(host_ms * 1e6), device_ms)


def _steps(device: bool):
    """Steps 0-5 of one train step, a second apart from 109.4 s: step 0 in the
    warm-up, 1-3 the device-only pass, 4 the host pass, 5 after the trace.
    Step u: host 100 + u ms; forward 10u, backward 20u, optimizer u device
    ms; two recompute regions of 3u ms, one with a region nested in it; a
    loader batch of 50 + u host ms."""
    out = []
    for u in range(6):
        s = 109.4 + u
        dev = (lambda ms: ms) if device else (lambda ms: None)
        top = _span("step", u, 1, s, host_ms=100 + u)
        bwd = _span("step.backward", u, 1, s + 0.2, device_ms=dev(20 * u), parent=top)
        outer = _span("remat.recompute", u, 1, s + 0.3, device_ms=dev(3 * u), parent=bwd)
        out += [top, _span("step.forward", u, 1, s + 0.1, device_ms=dev(10 * u), parent=top), bwd,
                outer, _span("remat.recompute", u, 1, s + 0.31, device_ms=dev(u), parent=outer),
                _span("remat.recompute", u, 1, s + 0.4, device_ms=dev(3 * u), parent=bwd),
                _span("step.optimizer", u, 1, s + 0.5, device_ms=dev(u), parent=top),
                _span("loader.batch", u + 2, 2, s + 0.05, host_ms=50 + u)]
    return out


def _store(monkeypatch, records):
    monkeypatch.setattr(profiling, "_STORE", collections.deque(records))


def test_train_readers_take_the_device_only_pass(monkeypatch):
    _store(monkeypatch, _steps(device=True))
    rec = _record("step", 3)  # steps 1, 2, 3
    assert _read("step.forward_ms.train", rec) == 20
    assert _read("step.backward_ms.train", rec) == 40
    assert _read("step.optimizer_ms.train", rec) == 2
    assert _read("remat.recompute_ms.train", rec) == 12  # the nested region counted once
    assert _read("step.host_ms.train", rec) == 102
    assert _read("data.produce_ms.train", rec) == 52
    assert _read("engine.enqueue_ms.infer", rec) is None  # a volume's metric


def test_device_readers_read_nothing_without_cuda_events(monkeypatch):
    _store(monkeypatch, _steps(device=False))
    rec = _record("step", 3)
    for metric in DEVICE:
        assert _read(metric, rec) is None, metric
    assert _read("step.host_ms.train", rec) == 102


def test_engine_reader_sums_both_engines_calls(monkeypatch):
    """Two engines (owners 7, 8), calls 0-4 a second apart from 109.5 s, each
    of 3 chunks; engine 8's chunks take twice engine 7's. Call c's chunk k
    takes (c + k) ms on engine 7."""
    records = []
    for c in range(5):
        for owner, scale in ((7, 1), (8, 2)):
            for k in range(3):
                records.append(_span("engine.predict", c, owner, 109.5 + c + 0.1 * k,
                                     host_ms=scale * (c + k)))
    _store(monkeypatch, records)
    rec = _record("volume", 2)  # calls 1 and 2 (110.5, 111.5 s)
    sums = [3 * (3 * c + 3) for c in (1, 2)]
    assert _read("engine.enqueue_ms.infer", rec) == statistics.median(sums)
    assert _read("step.host_ms.train", rec) is None


def test_span_readers_read_nothing_without_spans(monkeypatch):
    """An empty store, a run without a trace, and a program without
    ``profiling.spans`` (the parent of the spans)."""
    _store(monkeypatch, [])
    for metric in [*DEVICE, *HOST]:
        assert _read(metric, _record(HOST.get(metric, "step"), 3)) is None, metric
    _store(monkeypatch, _steps(device=True))
    rec = _record("step", 3)
    rec.trace = None
    assert _read("step.forward_ms.train", rec) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read("step.forward_ms.train", _record("step", 3)) is None


@pytest.mark.parametrize("cell", ["hybrid.vol256.sw4", "ctunet_train.b1x4.remat",
                                  "ctunet_train.b1x4.noremat"])
def test_traced_run_reports_the_host_span_metrics(cell):
    """A ``--trace 1`` run of each cell on the CPU at small sizes (one crop
    a step, a 36x36x32 volume): the span metrics it lists are those
    BENCHMARK.json gives it, and the host-side ones report."""
    spec = harness.load_spec()
    cfg, tr = bench_tiny.sizes(cell)
    if "volume" in tr:
        tr["volume"] = [36, 36, 32]
    else:
        tr["num_samples"] = 1
    out = harness.run_cell(spec, cell, 2 ** 31 + 11, 0.5, True, "cpu", harness.time.perf_counter(),
                           config=cfg, traffic=tr)
    listed = {m["name"] for m in harness.metrics_of(spec, cell, True)
              if m["source"] == "program_span"}
    train = cell.startswith("ctunet_train")
    assert listed == ({*DEVICE[:3], "step.host_ms.train", "data.produce_ms.train",
                       *DEVICE[3:] * cell.endswith(".remat")} if train
                      else {"engine.enqueue_ms.infer"})
    host = {m for m, unit in HOST.items() if unit == ("step" if train else "volume")}
    assert {m for m in out["metrics"] if m in listed} == host
    assert all(out["metrics"][m]["value"] > 0 for m in host)
