"""The port's measuring layer on the CPU: ``utils/profiling.py`` against
``hybrid_ctunet_tpu/utils/profiling.py`` (StepTimer on the same clock
readings), NaN checks, a host trace written for TensorBoard, the
reconciliation of traced kernel records with the launch counters,
``cli/bench.py``'s engines at two window batches (TINY models of
tests/test_torch_ctunet.py), and the program's spans: off without a
profiler, the train step's phases and recompute, the engine's chunks, the
loader's batches, the profiler's clock and the store's bound."""
import os
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.utils import profiling as jprof
from hybrid_ctunet_tpu_torch import kernels
from hybrid_ctunet_tpu_torch.cli import bench
from hybrid_ctunet_tpu_torch.data import dataset, synthetic
from hybrid_ctunet_tpu_torch.infer.sliding_window import SlidingWindowEngine
from hybrid_ctunet_tpu_torch.models import layers
from hybrid_ctunet_tpu_torch.ops.recompute import checkpoint
from hybrid_ctunet_tpu_torch.train import state, steps
from hybrid_ctunet_tpu_torch.utils import StepTimer, enable_nan_checks, profiling, trace

from torch_threads import two_threads  # noqa: F401 (autouse: two torch threads)

TINY = dict(out_channels=3, dim_conv_stem=16, img_size=(32, 32), frames=32, patch_frame=8,
            hidden_size=64, num_depths=2, mlp_dim=128, num_heads=2, window=2)
ROI = (32, 32, 32)


def _clock(readings):
    it = iter(readings)
    return types.SimpleNamespace(perf_counter=lambda: next(it))


def _drive(timer, result):
    for n in (4, 4, 2):
        timer.tic()
        timer.toc(result, n)
    return timer


def test_step_timer_matches_jax(monkeypatch):
    readings = [0.0, 0.5, 1.0, 1.75, 2.0, 2.125]
    monkeypatch.setattr(jprof, "time", _clock(readings))
    monkeypatch.setattr(profiling, "time", _clock(readings))
    want = _drive(jprof.StepTimer(), jnp.ones(3))
    got = _drive(StepTimer(), (torch.ones(3), {"loss": torch.zeros(())}))
    assert got.times == want.times and got.items == want.items
    assert got.mean_s == want.mean_s
    for skip in (0, 1):
        assert got.items_per_s(skip_first=skip) == want.items_per_s(skip_first=skip)
        assert got.per_min(skip_first=skip) == want.per_min(skip_first=skip)
    assert got.per_min() == want.per_min()
    got.reset()
    assert got.times == [] and got.mean_s == 0.0


def test_nan_checks_name_the_module():
    model = bench.build_tunet(0, "cpu", torch.float32, **TINY)
    x = torch.randn((2, *ROI, 1))
    x[1, 5, 5, 5, 0] = float("nan")
    enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        # the first module whose output holds the NaN: the patch embedding's first
        # layer, which takes the patches the ViT cut from the window
        with pytest.raises(FloatingPointError,
                           match=r"module TUNet\.vit\.to_patch_embedding\.0 \(Identity"):
            with torch.no_grad():
                model(x)
    finally:
        enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    with torch.no_grad():
        out = model(x)[0]
    assert torch.isnan(out).any()


def test_trace_writes_a_host_trace(tmp_path):
    with trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.name == "aten::mm" for e in prof.events())
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path))
    if not torch.cuda.is_available():  # the default device is the card: no silent host trace
        with pytest.raises(RuntimeError, match="CUDA"):
            with trace(str(tmp_path)):
                pass


def test_reconcile_raises_on_a_dropped_record():
    """Each kernel's records are found by its CUDA symbols in demangled
    names; other kernels (PyTorch's, a packing launch) count for none. One
    record dropped from the table fails with both counts."""
    names, launched = [], {}
    for i, info in enumerate(kernels.KERNELS):
        launched[info.name] = i + 1
        for j in range(i + 1):
            sym = info.symbols[j % len(info.symbols)]
            names.append(f"void ns::{sym}<__nv_bfloat16, 15>(float*, int)" if j % 2
                         else f"{sym}(float const*, float*, int)")
    names += ["void at::native::vectorized_elementwise_kernel<4, float>(int, float)",
              "void ffnk::pack_kernel<256>(Src, Src, int, int, int, unsigned char*)"]
    traced = kernels.traced_counts(names)
    assert traced == launched
    kernels.reconcile(traced, launched)
    dropped = [n for n in names if "window_attention_kernel" not in n]
    dropped += [n for n in names if "window_attention_kernel" in n][1:]
    with pytest.raises(RuntimeError, match=r"'window_attention': \(1, 2\)"):
        kernels.reconcile(kernels.traced_counts(dropped), launched)


def test_window_batch_does_not_change_the_ensemble():
    """The bench's engines at sw 2 and sw 4: the same masks, maps within
    1e-5 of their largest value."""
    ct = bench.build_ctunet(0, "cpu", torch.float32, model_depth=50, **TINY)
    tu = bench.build_tunet(0, "cpu", torch.float32, **TINY)
    volume = bench.make_volume(0, (40, 36, 34), device="cpu")
    out = {}
    for sw in (2, 4):
        engines = (bench.make_ctunet_engine(ct, ROI, sw=sw), bench.make_engine(tu, ROI, sw=sw))
        out[sw] = bench.segment_hybrid(*engines, volume)
        assert len(engines[1].plan(volume.shape[1:4])[3]) > sw  # more than one chunk
    for got, want in zip(out[2], out[4]):
        if got.dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item())


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _new_spans(before):
    """The records stored since ``before`` (a count of ``profiling.spans()``)."""
    return profiling.spans()[before:]


class _FakeEvent:
    """A timing CUDA event on a CPU machine: counts what is made and read."""
    made, resolved = [], []

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made.append(self)
        self.recorded = False

    def record(self, stream=None):
        self.recorded = True

    def synchronize(self):
        assert self.recorded

    def elapsed_time(self, end):
        _FakeEvent.resolved.append(self)
        return 2.5


def test_spans_off_and_on(monkeypatch):
    """Off (no profiler): one shared no-op, nothing stored, no CUDA event.
    On: a record a span, two events on a CUDA process resolved only when the
    store is read; a host-only span makes none; a span on another thread
    with none open there takes the open span it names by ``within`` as its
    parent, with its unit and owner."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", [])
    monkeypatch.setattr(_FakeEvent, "resolved", [])
    n = len(profiling.spans())
    assert profiling.span("a") is profiling.span("b", 3, 4)
    with profiling.span("a") as rec:
        assert rec is None
    assert len(profiling.spans()) == n and _FakeEvent.made == []

    owner = profiling.new_owner()
    inner = []
    with _profiled():
        with profiling.span("step.backward", 7, owner) as bwd:
            t = threading.Thread(target=lambda: inner.append(
                _record_in(profiling.span("remat.recompute", within="step.backward"))))
            t.start()
            t.join(timeout=30)
            with profiling.span("host", cuda=False) as host:
                pass
    assert not t.is_alive()
    assert len(_FakeEvent.made) == 4 and _FakeEvent.resolved == []
    got = _new_spans(n)
    assert len(_FakeEvent.resolved) == 2
    assert [r.name for r in got] == ["remat.recompute", "host", "step.backward"]
    assert got[0] is inner[0] and got[0].parent is bwd and (got[0].unit, got[0].owner) == (7, owner)
    assert host.parent is bwd and host.device_ms is None and host.events is None
    assert bwd.device_ms == 2.5 and bwd.parent is None and bwd.t0_ns <= bwd.t1_ns


def _record_in(context):
    with context as rec:
        return rec


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_spans(remat):
    """One TINY CTUNet step under the profiler: one ``step`` on the step's
    unit with ``step.forward``, ``step.backward`` and ``step.optimizer``
    inside it; with block remat on, as many ``remat.recompute`` spans as
    regions recomputed (``kernels.recomputes()`` since
    ``reset_launch_counts``), each inside that step's ``step.backward``;
    none with it off."""
    model = bench.build_ctunet(0, "cpu", torch.float32, model_depth=50, **TINY)
    step = steps.make_train_step("ctunet", model, state.make_optimizer(model.parameters()),
                                 start_step=5)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, *ROI, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (1, *ROI, 1)).astype(np.int32))
    checkpoint.recomputes = 3
    kernels.reset_launch_counts()
    assert kernels.recomputes() == 0
    n = len(profiling.spans())
    with layers.remat_blocks(remat), _profiled():
        step(x, y, 1e-4)
    got = _new_spans(n)
    recomputes = kernels.recomputes()
    (top,) = [r for r in got if r.name == "step"]
    assert (top.unit, top.owner, top.parent) == (5, step.owner, None)
    phases = {r.name: r for r in got if r.parent is top}
    assert sorted(phases) == ["step.backward", "step.forward", "step.optimizer"]
    assert all((r.unit, r.owner) == (5, step.owner) for r in got)
    regions = [r for r in got if r.name == "remat.recompute"]
    assert len(regions) == recomputes and (recomputes > 0) == remat
    assert all(r.parent is phases["step.backward"] for r in regions)
    assert len(got) == 4 + recomputes


@pytest.mark.parametrize("sw", [2, 4])
def test_engine_spans_a_chunk(sw):
    """One ``engine.predict`` span a chunk, on the engine's call count."""
    engine = SlidingWindowEngine(lambda w: w[..., :2] * 2, ROI, sw_batch_size=sw, overlap=0.5)
    volume = torch.rand((1, 40, 36, 34, 1))
    chunks = -(-len(engine.plan(volume.shape[1:4])[3]) // sw)
    assert chunks > 1
    n = len(profiling.spans())
    engine(volume)
    with _profiled():
        engine(volume)
        engine(volume)
    got = _new_spans(n)
    assert all(r.name == "engine.predict" and r.owner == engine.owner for r in got)
    assert [r.unit for r in got] == [1] * chunks + [2] * chunks


def test_loader_spans_a_batch_on_its_prefetch_thread(tmp_path, monkeypatch):
    """One ``loader.batch`` span a batch, numbered from epoch 0, made on the
    prefetch thread."""
    path = synthetic.write_synthetic_dataset(str(tmp_path), n_train=3, n_val=0,
                                             shape=(48, 48, 24))
    from hybrid_ctunet_tpu_torch.data.datalist import load_decathlon_datalist

    ds = dataset.CachedDataset(load_decathlon_datalist(path, base_dir=str(tmp_path)))
    loader = dataset.TrainLoader(ds, roi_size=(32, 32, 16), prefetch=2)
    threads = []
    span = profiling.span

    def spy(name, *args, **kw):
        threads.append(threading.current_thread().name)
        return span(name, *args, **kw)

    monkeypatch.setattr(profiling, "span", spy)
    loader.set_epoch(1)
    n = len(profiling.spans())
    with _profiled():
        batches = list(loader)
    got = _new_spans(n)
    assert len(batches) == len(loader) == 3
    assert [r.name for r in got] == ["loader.batch"] * 3
    assert [r.unit for r in got] == [3, 4, 5] and {r.owner for r in got} == {loader.owner}
    assert threads == ["TrainLoader-prefetch"] * 3


def test_span_start_on_the_profilers_clock():
    """A span's host start, on the profiler's clock, within 5 ms of the
    profiler's own event for it."""
    with _profiled() as prof:
        with profiling.span("clock.check") as rec:
            torch.ones(8) + 1
    (ev,) = [e for e in prof.events() if e.name == "clock.check"]
    start_ns = prof.profiler.kineto_results.trace_start_ns() + ev.time_range.start * 1e3
    assert abs(profiling.to_profiler_ns(rec.t0_ns) - start_ns) < 5e6


def test_span_store_stays_at_its_bound():
    cap = profiling.SPAN_CAPACITY
    with _profiled():
        for i in range(cap + 5):
            with profiling.span("fill", i):
                pass
    got = profiling.spans()
    assert len(got) == cap and got[0].unit == 5 and got[-1].unit == cap + 4
