"""A run's last line and what the run loads, on the CPU at small sizes."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import bench_tiny
import pytest

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", ["hybrid.vol256.sw4", "ctunet_train.b1x4.remat"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_required_keys(cell, trace):
    out = bench_tiny.run(cell, trace=trace)
    keys = list(out)
    assert keys[-1] == "checks"
    assert keys[:5] == KEYS[:5] and set(keys) == set(KEYS) | ({"breakdown"} if trace else set())
    assert out["attempted"] >= 1 and out["failed"] in (0, 1)
    spec = harness.load_spec()
    want = {m["name"] for m in harness.metrics_of(spec, cell, trace)}
    # the CPU trace has no device: its device metrics read nothing and are left out
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_run_loads_no_jax_or_the_jax_package():
    """A whole run of each cell in a fresh process: no top-level module named
    jax, jaxlib, flax or hybrid_ctunet_tpu (compared whole, so the port's
    hybrid_ctunet_tpu_torch does not count)."""
    code = ("import sys, bench_tiny\n"
            "from benchmark import harness\n"
            "bench_tiny.run('hybrid.vol256.sw4')\n"
            "bench_tiny.run('ctunet_train.b1x4.remat')\n"
            "print(harness.forbidden_modules(),"
            " sorted({m.split('.')[0] for m in sys.modules if m.startswith('hybrid')}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=600,
                         env={"PYTHONPATH": f"{harness.HERE / 'tests'}:{harness.ROOT}",
                              "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] ['hybrid_ctunet_tpu_torch']"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "hybrid_ctunet_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hybrid_ctunet_tpu.ops", sys)
    assert harness.forbidden_modules() == ["hybrid_ctunet_tpu"]


def test_no_card_exits_non_zero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "hybrid.vol256.sw4", "--seed", "3000000000", "--seconds", "1",
                          "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=120, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_it_exits_non_zero(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import time, bench_tiny, sys\n"
            "bench_tiny.run('hybrid.vol256.sw4')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": f"{tmp_path / 'benchmark' / 'tests'}:{tmp_path}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "hybrid_ctunet_tpu_torch" in out.stderr
