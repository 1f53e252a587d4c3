"""``correct`` against its control and its faults, on the CPU at small
sizes: the lower-precision control fails the cell's limits, and a run whose
timed path is broken underneath comes out not correct, once for each fault
the cell can have. The program computes in float32 here, so that a sound run
is correct at these sizes and only the fault separates."""
from __future__ import annotations

import bench_tiny
import numpy as np
import pytest
import torch

from benchmark import control, harness

HYBRID, TRAIN = "hybrid.vol256.sw4", "ctunet_train.b1x4.remat"


def _limits(cell):
    entry = harness.cell_of(harness.load_spec(), cell)
    return harness.load_json("configs", entry["config"])["limits"]


@pytest.mark.parametrize("cell", [HYBRID, TRAIN])
def test_control_fails_the_limits(cell):
    """At the configuration's own depth (ResNet-101), small widths: with a
    ResNet-50 at these widths the float8 control's training readings fall
    near the limits, as the rounding error has fewer layers to grow in."""
    cfg, tr = bench_tiny.sizes(cell, depth=101)
    got = control.readings(cell, 2 ** 31 + 11, "cpu", cfg, tr)["control"]
    lim = _limits(cell)
    assert any(got[k] > v for k, v in lim.items()), (got, lim)


@pytest.mark.parametrize("cell", [HYBRID, TRAIN])
def test_a_sound_run_is_correct(cell):
    out = bench_tiny.run(cell, dtype="float32")
    assert out["correct"], out["checks"]


def _altered_mask(monkeypatch):
    from hybrid_ctunet_tpu_torch.cli import bench

    real = bench.ensemble

    def altered(res_map, tu_map):
        prob, mask = real(res_map, tu_map)
        mask = mask.clone()
        mask[..., : mask.shape[-1] // 4] = (mask[..., : mask.shape[-1] // 4] + 1) % prob.shape[-1]
        return prob, mask

    monkeypatch.setattr(bench, "ensemble", altered)


def _half_the_windows(monkeypatch):
    """Each chunk blends only its first half of windows: the blend is the
    mean over the rest."""
    from hybrid_ctunet_tpu_torch.infer import sliding_window

    real = sliding_window.scatter_add_windows

    def half(acc, pred, importance, starts):
        n = max(1, len(starts) // 2)
        return real(acc, pred[:n].contiguous(), importance, np.asarray(starts)[:n])

    monkeypatch.setattr(sliding_window, "scatter_add_windows", half)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from hybrid_ctunet_tpu_torch.train import steps

    real = steps.TrainStep.__call__

    def half(self, image, label, lr):
        n = image.shape[0] // 2
        return real(self, image[:n], label[:n], lr)

    monkeypatch.setattr(steps.TrainStep, "__call__", half)


def _altered_crop(monkeypatch):
    from hybrid_ctunet_tpu_torch.data import dataset

    real = dataset.TrainLoader._batches

    def altered(self):
        for image, label in real(self):
            label = label.copy()
            label[0, 0, 0, 0] = (label[0, 0, 0, 0] + 1) % 3
            yield image, label

    monkeypatch.setattr(dataset.TrainLoader, "_batches", altered)


@pytest.mark.parametrize("cell,fault", [
    (HYBRID, _altered_mask), (HYBRID, _half_the_windows),
    (TRAIN, _state_unchanged), (TRAIN, _half_the_batch), (TRAIN, _altered_crop)],
    ids=["hybrid-answer-altered", "hybrid-half-batch", "train-state-unchanged",
         "train-half-batch", "train-answer-altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = bench_tiny.run(cell, dtype="float32")
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
