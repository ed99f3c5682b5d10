"""the whole ported slice: the PyTorch Detector against the JAX Detector on the
same weights and the same uint8 frames (the small configuration of
tests/test_full_graph_parity.py::test_full_pipeline_images_to_detections_parity),
plus the port's import rules."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu.inference import Detector as JaxDetector
from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu.models.convert import convert_reference_state_dict
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.inference import Detector, PairDetections
from detect_to_track_tpu_torch.models import DetectTrackModule
from detect_to_track_tpu_torch.models.convert import load_reference_state_dict
from tests.test_full_graph_parity import ARCH, D_MAX, HW, K, N_ANCHORS, N_CLASSES, _full_reference_state_dict

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "detect_to_track_tpu_torch"

CFG_KW = dict(
    N_CLASSES=N_CLASSES,
    INPUT_SHAPE=HW,
    FM_STRIDE=16,
    ANCHOR_AREAS=(0.05,),
    ANCHOR_ASPECT_RATIOS=(0.5, 1.0, 2.0),  # 3 anchors per cell, 72 in all
    K=K,
    D_MAX=D_MAX,
    PRE_NMS_TOPK=None,
    EVAL_MAX_ROIS=72,
    MAX_ROIS=72,
    MAX_DETS=72,
    COMPUTE_DTYPE="float32",
)
TOL = dict(rtol=2e-3, atol=2e-3)  # as the JAX package's own f32 pipeline parity


@pytest.fixture(scope="module")
def detectors():
    sd = _full_reference_state_dict()
    # box-regression heads at trained-net magnitudes, so both decodes stay
    # inside the clamp (as in the JAX package's pipeline parity test)
    for k in ("rpn.reg_fc.weight", "rpn.reg_fc.bias", "rcnn.reg_head.sm_conv.weight", "rcnn.reg_head.sm_conv.bias"):
        sd[k] = sd[k] * 0.002
    jmodel = JaxDetectTrack(
        backbone_arch=ARCH, n_anchors=N_ANCHORS, n_classes=N_CLASSES, k=K, d_max=D_MAX, r_hw=K, dtype=jnp.float32
    )
    jdet = JaxDetector(jmodel, {"params": convert_reference_state_dict(sd, ARCH)}, JaxConfig(**CFG_KW))
    cfg = Config(**CFG_KW)
    port = DetectTrackModule.from_config(cfg, device="cpu")
    port.load_state_dict(load_reference_state_dict(sd))
    return jdet, Detector(port, cfg, device="cpu")


def _frames(rng, p):
    return (rng.rand(p, 2, *HW, 3) * 255).astype(np.uint8)


def _canon(boxes):
    key = np.round(np.asarray(boxes, np.float64), 4)
    return np.lexsort((key[:, 3], key[:, 2], key[:, 1], key[:, 0]))


def _assert_same_rows(got, ref, name):
    """(confs, boxes, tracks) row sets of one frame pair's frame 0 (or
    confs/boxes of frame 1, with tracks None)."""
    gc, gb, gt = got
    rc, rb, rt = ref
    assert len(gb) == len(rb), f"{name}: {len(gb)} vs {len(rb)} detections"
    assert len(gb) >= 1, f"{name}: no valid detection"
    gi, ri = _canon(gb), _canon(rb)
    np.testing.assert_allclose(gb[gi], rb[ri], err_msg=f"{name} boxes", **TOL)
    np.testing.assert_allclose(gc[gi], rc[ri], err_msg=f"{name} confs", **TOL)
    if gt is not None:
        np.testing.assert_allclose(gt[gi], rt[ri], err_msg=f"{name} tracks", **TOL)
        assert np.isfinite(gt).all()


def _trim(confs, boxes, valid, tracks):
    """padded per-pair outputs -> (frame 0 rows with tracks, frame 1 rows)."""
    v0, v1 = valid[0], valid[1]
    return (confs[0][v0], boxes[0][v0], tracks[v0]), (confs[1][v1], boxes[1][v1], None)


def test_detector_call_matches_jax(detectors, rng):
    jdet, det = detectors
    frames = _frames(rng, 1)[0]
    got = det(frames[0], frames[1])
    ref = jdet(frames[0], frames[1])
    for g, r in zip(got, ref):
        assert g.shape[1:] == np.asarray(r).shape[1:]
    _assert_same_rows((got[0], got[2], got[4]), (ref[0], ref[2], ref[4]), "frame0")
    _assert_same_rows((got[1], got[3], None), (ref[1], ref[3], None), "frame1")


def test_detect_pairs_matches_jax(detectors, rng):
    jdet, det = detectors
    pairs = _frames(rng, 2)
    got = det.detect_pairs(pairs)
    ref = jdet.detect_pairs(pairs)
    assert isinstance(got, PairDetections)
    d = det.cfg.max_dets
    assert got.confs.shape == (2, 2, d, N_CLASSES + 1) and got.tracks.shape == (2, d, 4)
    for p in range(2):
        g = _trim(*(f[p].numpy() for f in got))
        r = _trim(*(np.asarray(f[p]) for f in ref))
        _assert_same_rows(g[0], r[0], f"pair{p} frame0")
        _assert_same_rows(g[1], r[1], f"pair{p} frame1")
    # the same pairs as a list of float32 and uint8 pairs: uint8 entries are
    # divided by 255 before stacking
    mixed = det.detect_pairs([pairs[0].astype(np.float32) / 255.0, pairs[1]])
    torch.testing.assert_close(mixed.valid, got.valid, rtol=0, atol=0)
    torch.testing.assert_close(mixed.boxes, got.boxes, rtol=1e-5, atol=1e-6)


def test_detector_pil_input(detectors, rng):
    from PIL import Image

    _, det = detectors
    frames = _frames(rng, 1)[0]
    ims = [Image.fromarray(f) for f in frames]  # already at INPUT_SHAPE: the resize keeps the pixels
    for g, r in zip(det(*ims), det(frames[0], frames[1])):
        np.testing.assert_array_equal(g, r)


def test_detector_needs_cuda_unless_told(detectors):
    _, det = detectors
    cfg = det.cfg
    if torch.cuda.is_available():
        assert Detector(det.model, cfg).device.type == "cuda"
        det.model.to("cpu")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Detector(det.model, cfg)
    # HOST_S2D runs (tests/test_torch_port_options.py); a 3-channel tensor
    # cannot be packed on the host and is refused
    with pytest.raises(ValueError, match="3-channel tensor"):
        Detector(det.model, cfg.replace(HOST_S2D=True), device="cpu").detect_pairs(
            torch.zeros(1, 2, *cfg.INPUT_SHAPE, 3, dtype=torch.uint8)
        )


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


ENTRY_POINTS = ("train", "evaluate", "checks", "track_clip")
NEW_MODULES = ("trainer", "evaluation", "filtering", "vis", "data.imagenet", "data.pascal", "data.sampling")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    mods = _port_modules()
    for name in ENTRY_POINTS + NEW_MODULES:
        assert f"detect_to_track_tpu_torch.{name}" in mods, name
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax') or m.startswith(('jax.', 'flax.'))\n"
        "             or m == 'detect_to_track_tpu' or m.startswith('detect_to_track_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_import_no_jax(tmp_path):
    """each `python -m detect_to_track_tpu_torch.<entry>` run end to end
    with --device cpu on a tiny config (the imports its main makes at run
    time included): no JAX module and nothing of the JAX package loaded."""
    from tests.test_torch_port_train import TINY

    cfg = dict(TINY, TRN_SIZE=2, VAL_SIZE=2, REP_SIZE=1, CHECKPOINT_KEEP=0, OUTPUT_DIR=str(tmp_path / "out"))
    yaml_path = tmp_path / "tiny.yaml"
    yaml_path.write_text("".join(f"{k}: {list(v) if isinstance(v, tuple) else v}\n" for k, v in cfg.items()))
    c = str(yaml_path)
    runs = [
        ("train", ["-c", c, "--synthetic", "--max-iters", "2", "--device", "cpu"]),
        ("evaluate", ["-c", c, "--synthetic", "--n-samples", "2", "--ckpt", str(tmp_path / "out" / "ckpt"),
                      "--all-ckpts", "--device", "cpu"]),
        ("checks", ["-c", c, "--synthetic", "--sampler", "--anchors", "--out", str(tmp_path / "chk"),
                    "--device", "cpu"]),
        ("track_clip", ["-c", c, "--n-frames", "3", "--frame-chunk", "2", "--device", "cpu"]),
    ]
    assert [name for name, _ in runs] == list(ENTRY_POINTS)
    code = (
        "import runpy, sys\n"
        f"for name, argv in {runs!r}:\n"
        "    sys.argv = [name] + argv\n"
        "    runpy.run_module('detect_to_track_tpu_torch.' + name, run_name='__main__', alter_sys=True)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax') or m.startswith(('jax.', 'flax.'))\n"
        "             or m == 'detect_to_track_tpu' or m.startswith('detect_to_track_tpu.'))\n"
        "assert not bad, bad\n"
        "print('entry points ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    shutil.rmtree(tmp_path / "out", ignore_errors=True)  # two ~300 MB checkpoints
    assert out.returncode == 0, out.stderr[-3000:]
    assert "entry points ok" in out.stdout


def test_port_sources_import_no_jax():
    import_line = re.compile(r"^\s*(?:from|import)\s+([\w.]+)", re.M)
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in import_line.findall(path.read_text()):
            top = mod.split(".")[0]
            assert top not in ("jax", "flax"), (path, mod)
            assert top != "detect_to_track_tpu", (path, mod)
