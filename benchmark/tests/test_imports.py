"""what the benchmark loads: no module whose top-level name (the part
before the first dot, compared whole, since the port's name begins with
the JAX package's) is `jax`, `jaxlib`, `flax` or `detect_to_track_tpu`;
and the reference loads nothing of the port either. A card-only test runs
one short cell through the command."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark import spec

JAX_SIDE = {"jax", "jaxlib", "flax", "detect_to_track_tpu"}
PORT = "detect_to_track_tpu_torch"


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _sources(part=""):
    return [p for p in (spec.HERE / part).rglob("*.py") if "tests" not in p.relative_to(spec.HERE).parts]


def test_sources_import_no_jax():
    for path in _sources():
        assert not set(_top_level_imports(path)) & JAX_SIDE, path


def test_reference_sources_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert not set(_top_level_imports(path)) & (JAX_SIDE | {PORT, "benchmark"}), path


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=spec.REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.judge, benchmark.reference.model, benchmark.reference.ops")
    assert not loaded & (JAX_SIDE | {PORT}), loaded & (JAX_SIDE | {PORT})


def test_a_run_loads_no_jax():
    code = ("import torch; torch.set_num_threads(2)\n"
            "from benchmark import run\nfrom benchmark.tests import tiny\n"
            "res = run.measure(tiny.cell(), 3, 0.2, True, device='cpu')\n"
            "assert run.forbidden_modules() == [], run.forbidden_modules()")
    loaded = _loaded_after(code)
    assert PORT in loaded and not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "detect_to_track_tpu_torch_fake.sub", object())
    assert "detect_to_track_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "detect_to_track_tpu.ops", object())
    assert "detect_to_track_tpu" in run.forbidden_modules()


def test_the_command_fails_without_the_program(tmp_path):
    """in a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(spec.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name, ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dt_r50.pairs", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == "", (out.returncode, out.stdout[-2000:])
    assert "detect_to_track_tpu_torch" in out.stderr


@pytest.mark.gpu
def test_the_command_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dt_r50.pairs", "--seed", "5",
                          "--seconds", "2", "--trace", "0"], cwd=spec.REPO, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == {"pairs_per_s", "pairs_call_p95_ms", "setup_s"}
