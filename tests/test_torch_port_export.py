"""the port's serialized export (`export.py`, torch.export) on the CPU, at
the configuration and weights of tests/test_torch_port_detect.py: the
program equals the live detect_pairs_batched bitwise and matches the JAX
Detector, plain and under HOST_S2D, and a process that imports only the
export module (no JAX, none of the port's models) loads and serves it.

Each program holds ResNet-50's f32 weights (about 156 MB): one export per
variant, deleted when the module's tests end.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from detect_to_track_tpu.utils import space_to_depth2 as j_space_to_depth2
from detect_to_track_tpu_torch.export import export_detector, load_detector
from detect_to_track_tpu_torch.inference import detect_pairs_batched
from detect_to_track_tpu_torch.utils import space_to_depth2
from tests.test_full_graph_parity import HW
from tests.test_torch_port_detect import _assert_same_rows, _trim, detectors  # noqa: F401  (module fixture)

ROOT = Path(__file__).resolve().parents[1]
P = 2  # pairs per exported call

# a serving process: imports the export module alone, loads the program on
# the CPU, serves the uint8 pairs and the same pairs as float32 / 255, and
# reports which of the modules it must not need were imported
_SERVE = r"""
import json, sys
import numpy as np
from detect_to_track_tpu_torch.export import load_detector
path, inputs, outputs = sys.argv[1:4]
serve = load_detector(path, device="cpu")
x = np.load(inputs)
out = {}
for name in ("u8", "f32"):
    for field, t in zip(("confs", "boxes", "valid", "tracks"), serve(x[name])):
        out[f"{name}_{field}"] = t.numpy()
np.savez(outputs, **out)
print(json.dumps({m: m in sys.modules for m in ("jax", "detect_to_track_tpu", "detect_to_track_tpu_torch.models",
                                                "detect_to_track_tpu_torch.inference")}))
"""

FIELDS = ("confs", "boxes", "valid", "tracks")


def _pairs():
    return (np.random.RandomState(11).rand(P, 2, *HW, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def served(detectors, tmp_path_factory):  # noqa: F811
    """the plain program, exported at P pairs and served in a fresh
    process: ({"u8_confs": ..., ...}, the process's module report)."""
    _, det = detectors
    work = tmp_path_factory.mktemp("export")
    try:
        export_detector(det.model, det.cfg, str(work / "detector.pt2"), pair_batch=P, device="cpu")
        pairs = _pairs()
        np.savez(work / "in.npz", u8=pairs, f32=pairs.astype(np.float32) / np.float32(255.0))
        proc = subprocess.run(
            [sys.executable, "-c", _SERVE, str(work / "detector.pt2"), str(work / "in.npz"), str(work / "out.npz")],
            cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr[-3000:]
        out = dict(np.load(work / "out.npz"))
        return out, json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(work, ignore_errors=True)


@pytest.fixture(scope="module")
def served_s2d(detectors, tmp_path_factory):  # noqa: F811
    """the HOST_S2D program (input (P, 2, H/2, W/2, 12)), exported and
    loaded in this process: its outputs on space_to_depth2 of the f32
    pairs."""
    _, det = detectors
    work = tmp_path_factory.mktemp("export_s2d")
    try:
        path = str(work / "detector_s2d.pt2")
        export_detector(det.model, det.cfg.replace(HOST_S2D=True), path, pair_batch=P, device="cpu")
        serve = load_detector(path, device="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                load_detector(path)  # cuda unless asked: no card here
        packed = space_to_depth2(_pairs().astype(np.float32) / np.float32(255.0))
        return serve(packed)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _live(det, pairs, cfg=None):
    return detect_pairs_batched(det.model, pairs, det.anchors, cfg or det.cfg, device="cpu")


def test_exported_program_equals_live_port(served, detectors):  # noqa: F811
    """the same ops on the same inputs: bitwise."""
    _, det = detectors
    out, _ = served
    f32 = _pairs().astype(np.float32) / np.float32(255.0)
    for field, ref in zip(FIELDS, _live(det, f32)):
        np.testing.assert_array_equal(out[f"f32_{field}"], ref.numpy(), err_msg=field)


def _assert_matches_jax(got, ref):
    """identical valid masks; per frame, the valid rows (confs, boxes and
    frame 0's tracks) as sets at tests/test_torch_port_detect.py's TOL
    (near-tied confidences may order two slots differently)."""
    np.testing.assert_array_equal(got[2], np.asarray(ref.valid))
    for p in range(P):
        g = _trim(*(f[p] for f in got))
        r = _trim(*(np.asarray(f[p]) for f in ref))
        _assert_same_rows(g[0], r[0], f"pair{p} frame0")
        _assert_same_rows(g[1], r[1], f"pair{p} frame1")


def test_exported_program_matches_jax(served, detectors):  # noqa: F811
    jdet, _ = detectors
    out, _ = served
    ref = jdet.detect_pairs(_pairs().astype(np.float32) / np.float32(255.0))
    _assert_matches_jax([out[f"f32_{field}"] for field in FIELDS], ref)


def test_exported_program_takes_uint8_as_f32_over_255(served):
    out, _ = served
    for field in FIELDS:
        np.testing.assert_array_equal(out[f"u8_{field}"], out[f"f32_{field}"], err_msg=field)


def test_serving_process_needs_no_jax_and_no_models(served):
    _, modules = served
    assert modules == {"jax": False, "detect_to_track_tpu": False, "detect_to_track_tpu_torch.models": False,
                       "detect_to_track_tpu_torch.inference": False}


def test_exported_host_s2d_program(served_s2d, detectors):  # noqa: F811
    """the HOST_S2D program on space_to_depth2 frames: bitwise the live
    port's HOST_S2D path, and the JAX Detector's (plain stem) detections
    with the same valid slots, as the JAX package's own test."""
    jdet, det = detectors
    f32 = _pairs().astype(np.float32) / np.float32(255.0)
    packed = space_to_depth2(f32)
    np.testing.assert_array_equal(packed, j_space_to_depth2(f32))
    for field, got, ref in zip(FIELDS, served_s2d, _live(det, packed, det.cfg.replace(HOST_S2D=True))):
        np.testing.assert_array_equal(got.numpy(), ref.numpy(), err_msg=field)
    _assert_matches_jax([t.numpy() for t in served_s2d], jdet.detect_pairs(f32))
