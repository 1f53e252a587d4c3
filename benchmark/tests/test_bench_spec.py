"""BENCHMARK.json against the rules of its format, and the harness finding
every cell, configuration and metric by name, also one added as new files."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = harness.load_spec()


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert not any(w.startswith("/") or ".." in w for w in SPEC["command"])
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cells = len(SPEC["workloads"])
    # 24 cells measured in full within 12 hours: 2 + 14 runs a cell, each
    # run_seconds + 60 s, 180 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24 and all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_fields():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and Path(harness.ROOT, c["file"]).is_file()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                      "program_counter", "host_clock")
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(SPEC, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.metrics_of(SPEC, w["name"], True), w["name"]


def test_every_piece_is_found_by_its_name():
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        cfg = harness.load_json("configs", w["config"])
        assert (harness.HERE / "drivers" / f"{cfg['driver']}.py").is_file()
        assert harness.load_json("traffic", w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        reader = harness.load_module(harness.HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


def test_a_new_cell_config_and_metric_are_new_files_only(tmp_path):
    """In a copy: a configuration, a traffic mix, a cell and a metric added
    as files and entries are listed and read without editing a file."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    cfg = harness.load_json("configs", "hybrid_ensemble")
    cfg["ctunet_overlap"] = 0.6
    (root / "benchmark/configs/hybrid_wide.json").write_text(json.dumps(cfg))
    tr = harness.load_json("traffic", "vol256.sw4")
    tr["sw_ct"] = tr["sw_tu"] = 8
    (root / "benchmark/traffic/vol256.sw8.json").write_text(json.dumps(tr))
    (root / "benchmark/metrics/units.infer.py").write_text(
        "def read(rec):\n    return float(rec.units)\n")
    spec["configs"].append({"name": "hybrid_wide", "source": "x",
                            "file": "benchmark/configs/hybrid_wide.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "hybrid_wide.vol256.sw8", "config": "hybrid_wide",
                              "traffic": "vol256.sw8", "chips": 1, "why": "x"})
    spec["end_to_end"][0]["workloads"].append("hybrid_wide.vol256.sw8")
    spec["per_layer"].append({"name": "units.infer", "unit": "vol", "better": "higher",
                              "source": "host_clock", "layer": "models, CTUNet half",
                              "moves": "volumes_per_min"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = (
        "from benchmark import harness\n"
        "s = harness.load_spec()\n"
        "w = harness.cell_of(s, 'hybrid_wide.vol256.sw8')\n"
        "c = harness.load_json('configs', w['config'])\n"
        "t = harness.load_json('traffic', w['traffic'])\n"
        "r = harness.Record(unit='volume', units=3)\n"
        "names = [m['name'] for m in harness.metrics_of(s, w['name'], True)]\n"
        "m = harness.load_module(harness.HERE / 'metrics' / 'units.infer.py')\n"
        "print(c['ctunet_overlap'], t['sw_ct'], 'units.infer' in names, m.read(r),\n"
        "      str(harness.HERE).startswith(%r))\n" % str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0.6", "8", "True", "3.0", "True"]
