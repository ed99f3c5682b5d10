"""`DetectTrackTrainer` as two ranks of a gloo group (each a process of
tests/torch_port_ranks.py over a `file://` store; the ranks import no JAX),
at the tiny f32 configuration of tests/test_parallel.py with NUM_DEVICES 2:

- (e) one epoch of `run` ends with bitwise-equal weights on both ranks,
  only rank 0 writes the checkpoints, their sidecars and metrics.jsonl,
  the validation loss equals a single-process run's on the same host
  batches (rtol 2e-4, tests/test_parallel.py's loss tolerance), and a
  resume goes on from the saved step on both ranks;
- (f) the host-memory watchdog: one rank over the bound makes both
  autosave and both run the handler (tests/test_multihost.py's case);
- (g) NUM_HOSTS 2: the two hosts draw different batches and salt their
  samplers apart;
- the training entry point under torchrun (`--standalone`, 2 CPU ranks):
  one metrics stream, rank 0's checkpoints.
"""

import json
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from detect_to_track_tpu_torch.config import Config
from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
from detect_to_track_tpu_torch.models import DetectTrackModule
from detect_to_track_tpu_torch.trainer import DetectTrackTrainer
from tests.test_torch_port_parallel import DP
from detect_to_track_tpu_torch.config import save_config
from tests.torch_port_ranks import digest, spawn, torchrun

TRAINER = dict(DP, LOG_EVERY=1, PATIENCE=5, CHECKPOINT_KEEP=1)
N_TRN, N_VAL = 2 * DP["BATCH_SIZE"], DP["BATCH_SIZE"]  # two steps, one validation batch


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """the three 2-rank runs, side by side, and the single-process run."""
    base = tmp_path_factory.mktemp("dp_trainer")
    init = DetectTrackModule.from_config(Config(**TRAINER), device="cpu", seed=0).state_dict()
    dirs = {}
    for mode in ("trainer", "watchdog", "hosts"):
        work = base / mode
        work.mkdir()
        (work / "cfg.json").write_text(json.dumps(Config(**TRAINER, NUM_DEVICES=2).__dict__))
        (work / "trainer.json").write_text(json.dumps({"n_trn": N_TRN, "n_val": N_VAL}))
        torch.save(init, work / "init.pt")
        dirs[mode] = work
    cli = base / "cli"
    save_config(Config(**TRAINER, NUM_DEVICES=2, TRN_SIZE=N_TRN, VAL_SIZE=N_VAL, REP_SIZE=1,
                       OUTPUT_DIR=str(cli / "out")), str(cli / "cfg.yaml"))
    with ThreadPoolExecutor(len(dirs) + 1) as pool:
        futures = {mode: pool.submit(spawn, mode, work) for mode, work in dirs.items()}
        futures["cli"] = pool.submit(torchrun, ["detect_to_track_tpu_torch.train", "-c", str(cli / "cfg.yaml"),
                                                "--synthetic", "--device", "cpu", "--max-iters", str(N_TRN)],
                                      cli / "torchrun.log")
        # the same epoch in one process, while the ranks run
        cfg = Config(**TRAINER, OUTPUT_DIR=str(base / "single"))
        model = DetectTrackModule.from_config(cfg, device="cpu")
        model.load_state_dict(init)
        trn, val = (SyntheticVIDManager(n, cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, seed=seed)
                    for seed, n in ((0, N_TRN), (1, N_VAL)))
        single = DetectTrackTrainer(model, trn, val, None, cfg, device="cpu")
        single.run(max_iters=N_TRN)
        single.close()
        results = {mode: f.result() for mode, f in futures.items()}
    dirs["cli"] = cli
    yield results, single, dirs
    shutil.rmtree(base, ignore_errors=True)


def test_trainer_epoch_on_two_ranks(runs):
    """(e) the ranks agree bitwise, rank 0 alone wrote, and the losses are
    the single-process run's."""
    results, single, dirs = runs
    r0, r1 = results["trainer"]
    assert r0["jax_modules"] == r1["jax_modules"] == []
    assert r0["steps"] == r1["steps"] == single.step_count == 2
    assert r0["digest"] == r1["digest"]
    assert r0["best_val_loss"] == r1["best_val_loss"]
    assert abs(r0["best_val_loss"] - single.best_val_loss) <= 2e-4 * abs(single.best_val_loss)
    assert r1["saves"] == [] and r1["saves_run"] == []
    assert sorted(Path(p).name for p in r0["saves_run"]) == ["ckpt.tmp", "ckpt_final.tmp"]
    out = dirs["trainer"] / "out"
    files = sorted(p.name for p in out.iterdir() if not p.name.startswith("ckpt_step_"))
    assert files == ["ckpt", "ckpt.meta.json", "ckpt_final", "ckpt_final.meta.json", "metrics.jsonl"]
    assert len(list(out.glob("ckpt_step_*"))) == 1  # CHECKPOINT_KEEP 1
    # the two runs' logs: 2 + 1 step windows and an epoch report each, from
    # rank 0 alone; the first run's entries are the single process's
    got = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    ref = [json.loads(line) for line in (Path(single.cfg.OUTPUT_DIR) / "metrics.jsonl").read_text().splitlines()]
    assert len(got) == 5 and len(ref) == 3
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k, v in r.items():
            assert abs(g[k] - v) <= 2e-4 * abs(v) + 1e-5, (k, g[k], v)


def test_trainer_resume_on_two_ranks(runs):
    """(e) `restore` on both ranks gives the saved step and weights, and the
    run goes on from there in step."""
    results, _, _ = runs
    r0, r1 = results["trainer"]
    for r in (r0, r1):
        assert r["restored"]["steps"] == 2 and r["restored"]["n_iters"] == N_TRN
        assert r["restored"]["digest"] == r["digest"]
        assert r["resumed"]["steps"] == 3
    assert r0["resumed"]["digest"] == r1["resumed"]["digest"] != r0["digest"]


def test_watchdog_one_rank_over_both_autosave(runs):
    """(f) rank 1 alone reads an RSS over HOST_RSS_LIMIT_GB: the all-reduced
    flag makes both ranks autosave (rank 0 writes) and both fire the
    handler, which keeps the watchdog armed."""
    results, _, dirs = runs
    for r in results["watchdog"]:
        assert r["fired"] and not r["disarmed"] and r["autosave"]
    assert (dirs["watchdog"] / "out" / "ckpt_autosave.meta.json").exists()


def test_two_hosts_draw_different_batches(runs):
    """(g) NUM_HOSTS 2 with one rank each: BATCH_SIZE pairs per host, the
    hosts' loaders seeded apart, and sampler salts distinct per host."""
    h0, h1 = runs[0]["hosts"]
    assert (h0["host"], h1["host"]) == (0, 1)
    assert h0["images"].shape == h1["images"].shape == (DP["BATCH_SIZE"], 2, *DP["INPUT_SHAPE"], 3)
    assert not np.array_equal(h0["images"], h1["images"])
    assert (h0["salt"], h1["salt"]) == (10, 11)
    assert digest([torch.from_numpy(h0["images"])]) != digest([torch.from_numpy(h1["images"])])


def test_train_entry_point_under_torchrun(runs):
    """README's launch line on the CPU: `torchrun --nproc-per-node 2 -m
    detect_to_track_tpu_torch.train` with NUM_DEVICES 2 trains one epoch
    of 2 steps; rank 0 alone wrote the log and the checkpoints."""
    results, _, dirs = runs
    log = (dirs["cli"] / "torchrun.log").read_text()
    assert results["cli"] == 0, log[-4000:]
    out = dirs["cli"] / "out"
    assert {"ckpt", "ckpt.meta.json", "ckpt_final", "metrics.jsonl", "report"} <= {p.name for p in out.iterdir()}
    entries = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    # 2 step windows (LOG_EVERY 1) and the epoch's report, one stream
    assert len(entries) == 3 and "val_o" in entries[-1]
