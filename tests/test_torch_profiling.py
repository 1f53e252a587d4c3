"""The port's measuring layer on the CPU: ``utils/profiling.py`` against
``hybrid_ctunet_tpu/utils/profiling.py`` (StepTimer on the same clock
readings), NaN checks, a host trace written for TensorBoard, the
reconciliation of traced kernel records with the launch counters, and
``cli/bench.py``'s engines at two window batches (TINY models of
tests/test_torch_ctunet.py)."""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybrid_ctunet_tpu.utils import profiling as jprof
from hybrid_ctunet_tpu_torch import kernels
from hybrid_ctunet_tpu_torch.cli import bench
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
