"""the port's four entry points (`python -m detect_to_track_tpu_torch.train`,
`.evaluate`, `.checks`, `.track_clip`) called in-process with `--device cpu`
on a tiny YAML written to tmp_path, as tests/test_examples.py runs its
example: training, resume and `--torch-weights`, evaluation of the rotating
checkpoint history, the sampler and anchor checks, and clip tracking."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from detect_to_track_tpu_torch import checks, evaluate, track_clip, train
from detect_to_track_tpu_torch.config import Config
from tests.test_torch_port_eval import _torchvision_state_dict
from tests.test_torch_port_train import TINY

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _free_checkpoints(tmp_path):
    """a checkpoint of the ResNet-50 model takes about 300 MB: drop the
    test's files when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def tiny_yaml(tmp_path):
    cfg = dict(TINY, TRN_SIZE=4, VAL_SIZE=2, REP_SIZE=1, LOG_EVERY=1, CHECKPOINT_KEEP=2,
               OUTPUT_DIR=str(tmp_path / "out"))
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v for k, v in cfg.items()}))
    return str(path)


def test_train_cli_resume_and_torch_weights(tiny_yaml, tmp_path):
    out = tmp_path / "out"
    t = train.main(["-c", tiny_yaml, "--synthetic", "--max-iters", "4", "--device", "cpu"])
    assert t.step_count == 2 and t.device.type == "cpu"
    assert {"ckpt", "ckpt_final", "ckpt_step_00000002", "metrics.jsonl", "report"} <= {p.name for p in out.iterdir()}
    t = train.main(["-c", tiny_yaml, "--synthetic", "--resume", "--max-iters", "8", "--device", "cpu"])
    assert t.step_count == 4 and torch.load(out / "ckpt_final", weights_only=True)["step"] == 4
    weights = tmp_path / "resnet50.pt"
    torch.save({k: torch.from_numpy(v) for k, v in _torchvision_state_dict(3).items()}, weights)
    t = train.main(["-c", tiny_yaml, "--synthetic", "--torch-weights", str(weights), "--max-iters", "2",
                    "--device", "cpu"])
    sd = _torchvision_state_dict(3)
    # conv1 sits below FIRST_TRAINABLE_STAGE: still the loaded weights
    np.testing.assert_array_equal(t.model.backbone.conv1.weight.detach().numpy(), sd["conv1.weight"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["-c", tiny_yaml, "--synthetic", "--max-iters", "2"])


def test_evaluate_cli_all_ckpts(tiny_yaml, tmp_path, capsys):
    out = tmp_path / "out"
    train.main(["-c", tiny_yaml, "--synthetic", "--max-iters", "8", "--device", "cpu"])
    hist = sorted(p.name for p in out.glob("ckpt_step_*"))
    assert len(hist) == 2  # CHECKPOINT_KEEP
    (out / "ckpt_step_00000002.bak").write_bytes(b"")  # not a history entry
    common = ["-c", tiny_yaml, "--synthetic", "--n-samples", "3", "--device", "cpu"]
    res = evaluate.main(common + ["--ckpt", str(out / "ckpt"), "--all-ckpts"])
    assert [r["ckpt"] for r in res[:-1]] == hist and res[-1]["ckpt"] == "ckpt(best)"
    assert all(0.0 <= r["mAP"] <= 1.0 for r in res)
    assert [r["step"] for r in res[:-1]] == [int(h.rsplit("_", 1)[1]) for h in hist]
    # a history entry given as --ckpt is scored once; --min-step filters
    res = evaluate.main(common + ["--ckpt", str(out / hist[-1]), "--all-ckpts", "--min-step", str(res[-2]["step"])])
    assert [r["ckpt"] for r in res] == [hist[-1]]
    assert len(evaluate.main(common + ["--ckpt", str(out / "ckpt")])) == 1
    assert evaluate.main(common)[0]["ckpt"] is None  # the seeded init
    with pytest.raises(SystemExit):
        evaluate.main(common + ["--ckpt", str(out / "ckpt"), "--reference-weights", "x.pt"])
    assert "mutually exclusive" in capsys.readouterr().err


def test_checks_cli(tiny_yaml, tmp_path):
    checks.main(["-c", tiny_yaml, "--synthetic", "--sampler", "--anchors", "--out", str(tmp_path / "chk"),
                 "--device", "cpu"])
    assert len(list((tmp_path / "chk").glob("check_sampler_*.png"))) == 8
    stats = checks.check_anchors(Config(**TINY), "cpu")
    assert stats["anchors"] == Config(**TINY).n_anchors
    with pytest.raises(SystemExit):
        checks.main(["-c", tiny_yaml, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            checks.main(["-c", tiny_yaml, "--anchors"])
    proc = subprocess.run([sys.executable, "-m", "detect_to_track_tpu_torch.checks", "-c", tiny_yaml, "--anchors",
                           "--device", "cpu"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "anchors:" in proc.stdout, proc.stderr


def test_track_clip_cli(tiny_yaml, tmp_path):
    """synthetic clip, device- and host-linked, from a checkpoint, and from
    a directory of frames."""
    from PIL import Image

    kw = ["-c", tiny_yaml, "--device", "cpu", "--n-frames", "5", "--frame-chunk", "3"]
    tubes = track_clip.main(kw)
    host = track_clip.main(kw + ["--host-linking"])
    assert [s for s, _ in tubes] == [s for s, _ in host]
    for (_, a), (_, b) in zip(tubes, host):
        np.testing.assert_allclose(a, b, atol=1e-6)
    t = train.main(["-c", tiny_yaml, "--synthetic", "--max-iters", "2", "--device", "cpu"])
    assert t.step_count == 1
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, f in enumerate(track_clip.synthetic_clip(*TINY["INPUT_SHAPE"], 4)):
        Image.fromarray(f).save(frames / f"{i:03d}.png")
    out = track_clip.main(kw + ["--ckpt", str(tmp_path / "out" / "ckpt"), "--frames", str(frames), "--min-len", "1"])
    assert all(0 <= s <= e < 4 for (s, e), _ in out)
