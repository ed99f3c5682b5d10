"""the port's checkpointing trainer and entry points.

- `DetectTrackTrainer.run` against the JAX package's trainer: 3 steps and
  one validation on synthetic pairs at the small configuration of
  tests/test_torch_port_train.py, from the same JAX-initialised weights.
- JAX-free: checkpoints round-trip bitwise and `restore` rewinds, restore
  picks by write recency, early stopping and `ckpt_final`, NAN_POLICY
  raise / warn / skip, the host-memory watchdog mid-epoch and
  mid-validation (val_pending), `prefetch`, the empty-loader errors, the
  first-epoch profile and the report overlays (after
  tests/test_failure_paths.py and tests/test_train_step.py).
The entry points that drive the trainer are in test_torch_port_cli.py.
"""

import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from detect_to_track_tpu import trainer as jtrainer
from detect_to_track_tpu.config import Config as JaxConfig
from detect_to_track_tpu.data.synthetic import SyntheticVIDManager as JaxSynthetic
from detect_to_track_tpu.models import DetectTrackModule as JaxDetectTrack
from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.losses import DTLoss
from detect_to_track_tpu_torch.models import DetectTrackModule
from detect_to_track_tpu_torch.models.convert import from_jax_params
from detect_to_track_tpu_torch.trainer import DetectTrackTrainer, prefetch
from tests.test_torch_port_train import TINY


@pytest.fixture(autouse=True)
def _free_checkpoints(tmp_path):
    """a checkpoint of the ResNet-50 model takes about 300 MB: drop the
    test's files when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(tmp_path, **kw):
    return Config(**TINY).replace(OUTPUT_DIR=str(tmp_path / "out"), **kw)


def _manager(cfg, n, seed=0):
    return SyntheticVIDManager(n_samples=n, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, seed=seed)


def _trainer(cfg, n_trn=4, n_val=2, rep=None, seed=0):
    model = DetectTrackModule.from_config(cfg, device="cpu", seed=seed)
    return DetectTrackTrainer(model, _manager(cfg, n_trn), _manager(cfg, n_val, seed=1), rep, cfg, device="cpu")


# --- against the JAX trainer ------------------------------------------------


def test_trainer_run_matches_jax_trainer(tmp_path):
    """3 training steps (LOG_EVERY 1) and one validation from the same
    weights on the same synthetic pairs: every per-step loss component and
    the validation losses within 1e-4 of their magnitude, and every
    trainable weight within 1e-4 of its tensor's largest magnitude (f32;
    the frameworks sum in different orders, and each step's update moves
    the weights by about 1e-3 of their magnitude, so the drift stays far
    below that). Frozen weights bitwise."""
    kw = dict(TINY, LOG_EVERY=1, PATIENCE=5, CHECKPOINT_KEEP=0)  # no history copies
    cfg = Config(**kw, OUTPUT_DIR=str(tmp_path / "port"))
    jcfg = JaxConfig(**kw, OUTPUT_DIR=str(tmp_path / "jax"))
    jmodel = JaxDetectTrack.from_config(jcfg, corr_impl="xla")
    h, w = cfg.INPUT_SHAPE
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, h, w, 3), jnp.float32), jnp.full((2, cfg.MAX_ROIS, 4), 0.3)
    )["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    steps = 3
    n_trn, n_val = steps * cfg.BATCH_SIZE, cfg.BATCH_SIZE

    jlog, plog = [], []
    jt = jtrainer.DetectTrackTrainer(
        jmodel, {"params": params}, JaxSynthetic(n_trn, jcfg.INPUT_SHAPE, n_classes=6, seed=0),
        JaxSynthetic(n_val, jcfg.INPUT_SHAPE, n_classes=6, seed=1), None, jcfg, logger=jlog.append,
    )
    jt.run(max_iters=n_trn)
    model = DetectTrackModule.from_config(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    pt = DetectTrackTrainer(
        model, SyntheticVIDManager(n_trn, cfg.INPUT_SHAPE, n_classes=6, seed=0),
        SyntheticVIDManager(n_val, cfg.INPUT_SHAPE, n_classes=6, seed=1), None, cfg, logger=plog.append, device="cpu",
    )
    pt.run(max_iters=n_trn)

    assert len(plog) == len(jlog) == steps + 1  # 3 step windows, then the epoch report
    for got, ref in zip(plog, jlog):
        assert got.keys() == ref.keys()
        for k, v in ref.items():
            assert abs(got[k] - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, (k, got[k], float(v))
    assert pt.step_count == int(jt.state.step) == steps
    ref_sd = from_jax_params(jax.tree_util.tree_map(np.asarray, jt.state.params))
    init_sd = from_jax_params(params)
    moved = 0
    for name, param in pt.model.named_parameters():
        got, ref = param.detach(), ref_sd[name]
        if not param.requires_grad:
            torch.testing.assert_close(got, ref, rtol=0, atol=0, msg=name)
            continue
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), name
        moved += not torch.equal(got, init_sd[name])
    assert moved > 10
    assert (Path(cfg.OUTPUT_DIR) / "ckpt").exists() and (Path(cfg.OUTPUT_DIR) / "ckpt_final").exists()


# --- checkpoints and resume -------------------------------------------------


def test_checkpoint_roundtrip_and_restore_rewinds(tmp_path):
    """a step writes ckpt (and its history entry); restore brings back the
    weights, the momentum and the step bitwise, rewinds n_iters to step *
    BATCH_SIZE and salts the training sampler with the step; a history file
    (no sidecar) restores likewise and clears a stale val_pending."""
    cfg = _cfg(tmp_path, PATIENCE=0, CHECKPOINT_KEEP=1)
    t = _trainer(cfg)
    salts = []
    t.trn_loader.manager.reseed = salts.append
    t.step()
    out = Path(cfg.OUTPUT_DIR)
    assert t.n_iters == 4 and t.step_count == 2
    assert sorted(p.name for p in out.iterdir()) == [
        "ckpt", "ckpt.meta.json", "ckpt_step_00000002", "metrics.jsonl"]
    model_sd = {k: v.clone() for k, v in t.model.state_dict().items()}
    momentum = {k: v["momentum_buffer"].clone() for k, v in t.optimizer.state_dict()["state"].items()}
    with torch.no_grad():
        for p in t.model.parameters():
            p.add_(1.0)
    t._train_step.steps = 7
    t.n_iters = 99
    t.restore()
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, model_sd[k]), k
    for k, v in t.optimizer.state_dict()["state"].items():
        assert torch.equal(v["momentum_buffer"], momentum[k])
    assert t.step_count == 2 and t.n_iters == 4 and salts == [2]
    assert json.loads((out / "ckpt.meta.json").read_text())["n_iters"] == 4

    t._val_pending = True
    t.n_iters = 99
    t.restore(out / "ckpt_step_00000002")
    assert t.n_iters == 2 * cfg.BATCH_SIZE and not t._val_pending
    # the rotating history keeps CHECKPOINT_KEEP entries
    t._train_step.steps = 5
    t.checkpoint()
    assert sorted(p.name for p in out.glob("ckpt_step_*")) == ["ckpt_step_00000005"]


def test_restore_prefers_most_recent_not_highest_step(tmp_path):
    cfg = _cfg(tmp_path)
    t = _trainer(cfg)
    out = Path(cfg.OUTPUT_DIR)

    def fake_ckpt(name, step, mtime):
        (out / name).write_bytes(b"")
        meta = out / f"{name}.meta.json"
        meta.write_text(json.dumps({"step": step}))
        os.utime(meta, (mtime, mtime))
        return (out / name).absolute()

    assert t._pick_restore_path() == out / "ckpt"  # nothing written yet
    stale_auto = fake_ckpt("ckpt_autosave", 1500, 1_000_000.0)
    fresh = fake_ckpt("ckpt", 150, 2_000_000.0)
    assert t._pick_restore_path() == fresh
    os.utime(out / "ckpt_autosave.meta.json", (3_000_000.0, 3_000_000.0))
    assert t._pick_restore_path() == stale_auto
    os.utime(out / "ckpt.meta.json", (3_000_000.0, 3_000_000.0))
    assert t._pick_restore_path() == fresh  # ties go to the best model


def test_early_stopping_and_final_checkpoint(tmp_path):
    """PATIENCE 0: the first epoch improves (ckpt), the second does not, and
    the run stops there; ckpt holds the first epoch, ckpt_final the end,
    and a clean end removes the watchdog's autosave."""
    cfg = _cfg(tmp_path, PATIENCE=0)
    t = _trainer(cfg)
    out = Path(cfg.OUTPUT_DIR)
    (out / "ckpt_autosave").write_bytes(b"stale")
    (out / "ckpt_autosave.meta.json").write_text("{}")
    val = iter([1.0, 2.0, 0.5])

    def validate():
        v = torch.tensor(next(val))
        return DTLoss.single(v, v, v, v, v)

    t.validate = validate
    t.run()
    assert t.iters_no_improvement == 1 and t.step_count == 4
    assert json.loads((out / "ckpt.meta.json").read_text())["step"] == 2
    final = torch.load(out / "ckpt_final", weights_only=True)
    assert final["step"] == 4
    assert not (out / "ckpt_autosave").exists() and not (out / "ckpt_autosave.meta.json").exists()
    logged = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [e["val_o"] for e in logged if "val_o" in e] == [1.0, 2.0]


def test_max_iters_stops_mid_epoch(tmp_path):
    cfg = _cfg(tmp_path)
    t = _trainer(cfg, n_trn=8)
    t.run(max_iters=4)
    assert t.step_count == 2 and t.n_iters == 4
    assert (Path(cfg.OUTPUT_DIR) / "ckpt_final").exists()


# --- failure paths ----------------------------------------------------------


def _nan_loss():
    return DTLoss.single(*(torch.tensor(v) for v in [1.0, float("nan"), 1.0, 1.0, 1.0]))


@pytest.mark.parametrize("policy", ["raise", "warn", "skip"])
def test_nan_policy(tmp_path, policy, capsys):
    """"raise" aborts training, "warn" prints and keeps going, "skip" prints
    and spends the batch (the step itself left the state as it was)."""
    cfg = _cfg(tmp_path, NAN_POLICY=policy, LOG_EVERY=1)
    t = _trainer(cfg)
    t._train_step = lambda batch: _nan_loss()
    t._max_iters = float("inf")
    if policy == "raise":
        with pytest.raises(FloatingPointError, match="non-finite"):
            t.train()
        return
    trn = t.train()
    out = capsys.readouterr().out
    assert "non-finite" in out
    assert ("skipping update" in out) == (policy == "skip")
    assert t.n_iters == 4
    assert float(trn.count) == (2.0 if policy == "warn" else 0.0)
    assert t._check_finite(DTLoss.single(*(torch.tensor(1.0) for _ in range(5))))


class _Fired(Exception):
    pass


def _fire():
    raise _Fired  # the train entry point would exec-restart here


def test_watchdog_fires_mid_epoch_with_logging_disabled(tmp_path):
    """the watchdog runs on every batch, whatever LOG_EVERY is: with a 1 MB
    limit the first batch autosaves and calls the handler."""
    cfg = _cfg(tmp_path, LOG_EVERY=0, HOST_RSS_LIMIT_GB=0.001)
    t = _trainer(cfg, n_trn=8)
    t.on_host_memory_limit = _fire
    with pytest.raises(_Fired):
        t.train()
    out = Path(cfg.OUTPUT_DIR)
    assert (out / "ckpt_autosave").exists() and not (out / "ckpt").exists()
    assert t.step_count == 1


def test_watchdog_mid_validation_resumes_into_validation(tmp_path):
    """an autosave inside validate() marks val_pending; a restored trainer
    (the restarted process) finishes that validation before any training,
    saves the best ckpt, and a clean end drops the autosave."""
    cfg = _cfg(tmp_path, LOG_EVERY=0, HOST_RSS_LIMIT_GB=0)
    t = _trainer(cfg, n_trn=2)
    t._max_iters = cfg.BATCH_SIZE
    t.train()
    t.cfg = t.cfg.replace(HOST_RSS_LIMIT_GB=0.001)  # the limit cache is keyed on the value
    t.on_host_memory_limit = _fire
    with pytest.raises(_Fired):
        t.validate()
    out = Path(cfg.OUTPUT_DIR)
    assert json.loads((out / "ckpt_autosave.meta.json").read_text())["val_pending"] is True
    assert not t._in_validate

    t2 = _trainer(cfg, n_trn=2, seed=1)
    t2.restore()
    assert t2._val_pending and t2.step_count == 1

    def fail_train():
        raise AssertionError("trained before finishing the pending validation")

    t2.train = fail_train
    t2.run(max_iters=t2.n_iters)
    assert not t2._val_pending and t2.best_val_loss < float("inf")
    assert json.loads((out / "ckpt.meta.json").read_text())["val_pending"] is False
    assert not (out / "ckpt_autosave").exists()
    assert json.loads((out / "ckpt_final.meta.json").read_text())["n_iters"] == t2.n_iters


def test_watchdog_limits_and_disarm(tmp_path, capsys, monkeypatch):
    t = _trainer(_cfg(tmp_path, HOST_RSS_LIMIT_GB=0))
    assert t._host_rss_limit_gb() == float("inf")
    t.cfg = t.cfg.replace(HOST_RSS_LIMIT_GB=-1)  # 70% of MemTotal
    assert 0 < t._host_rss_limit_gb() < float("inf")
    t._check_host_memory()  # far below it
    assert not (Path(t.cfg.OUTPUT_DIR) / "ckpt_autosave").exists()
    assert 0 < t._host_rss_gb()
    t.cfg = t.cfg.replace(HOST_RSS_LIMIT_GB=0.001)
    saves = []
    t.checkpoint = saves.append
    for _ in range(3):  # no handler: one autosave, then disarmed
        t._check_host_memory()
    assert len(saves) == 1 and str(saves[0]).endswith("ckpt_autosave")
    assert "disarmed" in capsys.readouterr().out
    monkeypatch.setattr(os, "sysconf", lambda name: (_ for _ in ()).throw(ValueError(name)))
    assert DetectTrackTrainer._host_rss_gb() == 0.0  # unreadable: inert


def test_prefetch_relays_exceptions_and_stops_on_close():
    def bad():
        yield 1
        raise RuntimeError("corrupt file mid-epoch")

    it = prefetch(bad())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="corrupt file mid-epoch"):
        next(it)

    produced = []

    def src():
        for i in range(1000):
            produced.append(i)
            yield i

    it = prefetch(src(), depth=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.6)  # more than the producer's 0.25 s put timeout
    n = len(produced)
    time.sleep(0.6)
    assert len(produced) == n < 1000
    assert list(prefetch(iter(range(5)))) == list(range(5))


def test_trainer_rejects_empty_loaders_and_multi_device(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(ValueError, match="training manager yields 0"):
        _trainer(cfg, n_trn=1)
    with pytest.raises(ValueError, match="validation manager yields 0"):
        _trainer(cfg, n_val=1)
    # one process with no process group is a world of one
    with pytest.raises(ValueError, match="NUM_DEVICES=2 must equal the world size, 1"):
        _trainer(cfg.replace(NUM_DEVICES=2))
    with pytest.raises(ValueError, match="NUM_HOSTS=2 must divide the world size 1"):
        _trainer(cfg.replace(NUM_HOSTS=2))


def test_logger_uses_only_an_active_wandb_run(tmp_path, monkeypatch):
    """metrics go to a wandb run only when the caller started one (wandb
    already imported, `wandb.run` set), else to metrics.jsonl; the logger
    never imports wandb itself."""
    t = _trainer(_cfg(tmp_path))
    jsonl = Path(t.cfg.OUTPUT_DIR) / "metrics.jsonl"
    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    t.logger({"a": 1.0})
    assert "wandb" not in sys.modules
    logged = []
    fake = types.SimpleNamespace(run=None, log=logged.append)
    monkeypatch.setitem(sys.modules, "wandb", fake)
    t.logger({"a": 2.0})
    fake.run = object()
    t.logger({"a": 3.0})
    assert [json.loads(line)["a"] for line in jsonl.read_text().splitlines()] == [1.0, 2.0]
    assert logged == [{"a": 3.0}]


def test_report_overlays_and_profile(tmp_path):
    """the report draws one overlay per report pair with one Detector for
    every epoch and leaves the model in training mode; PROFILE_DIR gets a
    trace of the first epoch only."""
    cfg = _cfg(tmp_path, PROFILE_DIR=str(tmp_path / "prof"))
    t = _trainer(cfg, rep=_manager(Config(**TINY), 1, seed=2))
    t.step()
    det = t._report_detector
    t.step()
    out = Path(cfg.OUTPUT_DIR)
    assert t._report_detector is det and t.model.training
    im = np.asarray(Image.open(out / "report" / "pair_0.png"))
    assert im.shape == (cfg.INPUT_SHAPE[0], 2 * cfg.INPUT_SHAPE[1], 3)
    assert im.mean() < 100  # float sources scaled once to uint8, not saturated
    assert sorted(p.name for p in (tmp_path / "prof").iterdir()) == ["train_epoch.json"]
