"""a configuration, a traffic mix and a per-layer metric added as files and
manifest entries, with no code edited, are found and run: a copy of the
benchmark in a temporary checkout gains `configs/dt_r50_tiny.json`,
`traffic/pairs2_tiny.json`, `limits/dt_r50_tiny.pairs.json`,
`metrics/calls_profiled.py` and their entries in BENCHMARK.json, and a
traced run of the new cell on the CPU reports the new metric."""

from __future__ import annotations

import json
import shutil

from benchmark import run, spec
from benchmark.tests import tiny

READER = '''"""calls under the profiler (a test's metric)."""


def read(ctx):
    return float(ctx.profile.calls)
'''


def test_added_files_are_found(tmp_path):
    root = tmp_path / spec.HERE.name
    shutil.copytree(spec.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((spec.REPO / "BENCHMARK.json").read_text())
    (root / "configs" / "dt_r50_tiny.json").write_text(json.dumps(tiny.config()))
    (root / "traffic" / "pairs2_tiny.json").write_text(json.dumps(tiny.traffic()))
    limits = spec.load("dt_r50.pairs").limits
    (root / "limits" / "dt_r50_tiny.pairs.json").write_text(json.dumps(limits))
    (root / "metrics" / "calls_profiled.py").write_text(READER)
    manifest["configs"].append({"name": "dt_r50_tiny", "source": "a test", "file": "benchmark/configs/dt_r50_tiny.json",
                                "reduced": ["INPUT_SHAPE"], "why": "a test"})
    manifest["workloads"].append({"name": "dt_r50_tiny.pairs", "config": "dt_r50_tiny", "traffic": "pairs2_tiny",
                                  "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "calls_profiled.pairs", "unit": "calls", "better": "higher",
                                  "source": "host_clock", "layer": "entry", "moves": "pairs_per_s",
                                  "workloads": ["dt_r50_tiny.pairs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = spec.load("dt_r50_tiny.pairs", tmp_path)
    assert cell.root == root and cell.config["config"]["INPUT_SHAPE"] == [64, 96]
    assert cell.traffic["pairs_per_call"] == 2 and cell.limits == limits
    assert [m["name"] for m in cell.per_layer] == ["calls_profiled.pairs"]
    res = run.measure(cell, 99, 0.3, True, device="cpu")
    assert res["metrics"]["calls_profiled.pairs"]["value"] == tiny.TINY_TRAFFIC["profiled_calls"]
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
