"""ranks of a torch.distributed group for the port's data-parallel tests.

`spawn(mode, workdir)` starts `world` processes of this file, each one rank
of a gloo group over a `file://` store in `workdir` (no port to race for
under several pytest workers), waits for them with a timeout, and returns
each rank's `rank{r}.pt` result. A rank imports nothing of JAX: the parent
test writes the inputs (`cfg.json`, `init.pt`, `inputs.pt`) and holds the
results against the JAX package itself.

    python tests/torch_port_ranks.py MODE RANK WORLD WORKDIR
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 420.0
GROUP_TIMEOUT_S = 300.0


def spawn(mode: str, workdir: Path, world: int = 2):
    """run `world` ranks of `mode` and return their results, in rank order.
    A rank that fails or outlives JOIN_TIMEOUT_S fails the call with every
    rank's log; every rank is killed on the way out."""
    import torch

    logs = [workdir / f"rank{r}.log" for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__)), mode, str(r), str(world), str(workdir)],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n{logs[r].read_text()[-3000:]}" for r, c in enumerate(codes))
        raise AssertionError(f"{mode} ranks failed or timed out after {JOIN_TIMEOUT_S} s:\n{tails}")
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def torchrun(argv, log: Path, nproc: int = 2) -> int:
    """`torchrun --standalone --nproc-per-node nproc -m <argv>` in its own
    session, killed with every process it started after JOIN_TIMEOUT_S;
    returns its exit code (the log gets both streams)."""
    import os
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", f"--nproc-per-node={nproc}", "-m", *argv]
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT, start_new_session=True,
                                env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        return proc.wait(timeout=JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return -1
    finally:
        if proc.poll() is None or proc.returncode == -1:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()


def digest(tensors) -> str:
    """a hash of the tensors' bytes: equal digests are bitwise-equal tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------------------- the ranks


def _cfg(workdir: Path, **kw):
    from detect_to_track_tpu_torch.config import Config

    base = json.loads((workdir / "cfg.json").read_text())
    base.update(kw)
    return Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in base.items()})


def _model(cfg, workdir: Path):
    import torch

    from detect_to_track_tpu_torch.models import DetectTrackModule

    model = DetectTrackModule.from_config(cfg, device="cpu")
    model.load_state_dict(torch.load(workdir / "init.pt", weights_only=True))
    return model


def _trainable(model):
    return [p.detach().clone() for p in model.parameters() if p.requires_grad]


def rank_step(workdir: Path, rank: int):
    """(a) one 2-rank step, (b) the same with GRAD_ACCUM 2, (c) NAN_POLICY
    skip with a non-finite batch on rank 1 only, (d) make_parallel_detect,
    (h) make_mesh's checks."""
    import torch

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.data.types import PaddedPairBatch
    from detect_to_track_tpu_torch.parallel import (
        make_mesh,
        make_parallel_detect,
        make_parallel_train_step,
        shard_batch,
    )

    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    batch = PaddedPairBatch(*inputs["batch"])
    out = {}
    cfg = _cfg(workdir)
    mesh = make_mesh(cfg.NUM_DEVICES, cfg.NUM_HOSTS)
    out["mesh"] = tuple(mesh)
    for bad in (dict(n_devices=4), dict(n_devices=1), dict(n_devices=2, n_hosts=3)):
        try:
            make_mesh(**bad)
            out[f"mesh_error {bad}"] = None
        except ValueError as e:
            out[f"mesh_error {bad}"] = str(e)

    def run(cfg, batches):
        model = _model(cfg, workdir)
        opt = trainer.make_optimizer(cfg, model)
        step = make_parallel_train_step(model, cfg, opt, mesh, device="cpu")
        losses = [step(shard_batch(b, mesh)).vector() for b in batches]
        return model, opt, step, losses

    model, _, _, losses = run(cfg, [batch])
    params = _trainable(model)
    out["step"] = {"losses": losses[0], "digest": digest(params)}
    if rank == 0:
        out["step"]["params"] = {n: p.detach().clone() for n, p in model.named_parameters()}
    del model
    model, _, _, losses = run(cfg.replace(GRAD_ACCUM=2), [batch])
    out["accum"] = {"losses": losses[0], "digest": digest(_trainable(model)), "max_err": max(
        float((a - b).abs().max()) for a, b in zip(_trainable(model), params))}
    del model

    bad = batch._replace(images=batch.images.copy())
    half = len(bad.images) // 2
    bad.images[half:] = float("nan")  # rank 1's rows only
    cfg_skip = cfg.replace(NAN_POLICY="skip")
    model = _model(cfg_skip, workdir)
    opt = trainer.make_optimizer(cfg_skip, model)
    step = make_parallel_train_step(model, cfg_skip, opt, mesh, device="cpu")
    clean = step(shard_batch(batch, mesh)).vector()
    before = (_trainable(model), [s["momentum_buffer"].clone() for s in opt.state.values()], step.steps)
    skipped = step(shard_batch(bad, mesh)).vector()
    after = (_trainable(model), [s["momentum_buffer"].clone() for s in opt.state.values()], step.steps)
    again = step(shard_batch(batch, mesh)).vector()
    out["skip"] = {
        "clean": clean, "skipped": skipped, "again": again, "steps": (before[2], after[2], step.steps),
        "params_kept": digest(before[0]) == digest(after[0]), "momentum_kept": digest(before[1]) == digest(after[1]),
        "n_momentum": len(before[1]), "digest": digest(_trainable(model)),
    }
    del model

    model = _model(cfg, workdir).eval()
    detect = make_parallel_detect(model, cfg, mesh, device="cpu")
    dets = detect(inputs["images"], inputs["anchors"])
    out["detect"] = {"fields": [f.clone() for f in dets], "digest": digest(dets)}
    return out


def _trainer(cfg, workdir: Path, n_trn: int, n_val: int):
    from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
    from detect_to_track_tpu_torch.trainer import DetectTrackTrainer

    def manager(n, seed):
        return SyntheticVIDManager(n_samples=n, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, seed=seed)

    return DetectTrackTrainer(_model(cfg, workdir), manager(n_trn, 0), manager(n_val, 1), None, cfg, device="cpu")


def rank_trainer(workdir: Path, rank: int):
    """(e) DetectTrackTrainer.run for one epoch, then a resume for one more
    step; torch.save calls are counted per rank."""
    import torch

    saves = []
    save = torch.save

    def counted(obj, f, *args, **kwargs):
        saves.append(str(f))
        return save(obj, f, *args, **kwargs)

    torch.save = counted
    try:
        spec = json.loads((workdir / "trainer.json").read_text())
        cfg = _cfg(workdir, OUTPUT_DIR=str(workdir / "out"))
        t = _trainer(cfg, workdir, spec["n_trn"], spec["n_val"])
        t.run(max_iters=spec["n_trn"])
        out = {
            "steps": t.step_count, "best_val_loss": t.best_val_loss, "digest": digest(_trainable(t.model)),
            "saves_run": list(saves), "n_iters": t.n_iters,
        }
        t.close()
        resumed = _trainer(cfg, workdir, spec["n_trn"], spec["n_val"])
        resumed.restore()
        out["restored"] = {
            "steps": resumed.step_count, "n_iters": resumed.n_iters, "digest": digest(_trainable(resumed.model))
        }
        resumed.run(max_iters=spec["n_trn"] + cfg.BATCH_SIZE)
        out["resumed"] = {"steps": resumed.step_count, "digest": digest(_trainable(resumed.model))}
        resumed.close()
    finally:
        torch.save = save
    out["saves"] = list(saves)
    return out


def rank_watchdog(workdir: Path, rank: int):
    """(f) rank 1 alone reads an RSS over the bound."""
    cfg = _cfg(workdir, OUTPUT_DIR=str(workdir / "out"), HOST_RSS_LIMIT_GB=10000.0)
    t = _trainer(cfg, workdir, cfg.BATCH_SIZE, cfg.BATCH_SIZE)
    if rank == 1:
        t._host_rss_gb = lambda: 99999.0
    fired = []
    t.on_host_memory_limit = lambda: fired.append(True)
    t._check_host_memory()
    auto = workdir / "out" / "ckpt_autosave"
    out = {"fired": bool(fired), "disarmed": t._rss_watchdog_disarmed, "autosave": auto.exists()}
    t.close()
    return out


def rank_hosts(workdir: Path, rank: int):
    """(g) NUM_HOSTS 2: each rank is a host of its own; its first training
    batch and its sampler salt."""
    cfg = _cfg(workdir, NUM_HOSTS=2, OUTPUT_DIR=str(workdir / "out"))
    t = _trainer(cfg, workdir, 4 * cfg.BATCH_SIZE, cfg.BATCH_SIZE)
    batch = next(iter(t.trn_loader))
    out = {"host": t.mesh.host, "images": batch.images, "salt": t._proc_salt(5)}
    t.close()
    return out


MODES = {"step": rank_step, "trainer": rank_trainer, "watchdog": rank_watchdog, "hosts": rank_hosts}


def main(mode: str, rank: int, world: int, workdir: Path) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from detect_to_track_tpu_torch.parallel import init_distributed

    init_distributed(torch.device("cpu"), init_method=f"file://{workdir / 'store'}", world_size=world, rank=rank,
                     timeout_s=GROUP_TIMEOUT_S)
    try:
        out = MODES[mode](workdir, rank)
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "detect_to_track_tpu.")))
    out["jax_modules"] = bad
    torch.save(out, workdir / f"rank{rank}.pt")
    print(f"rank {rank}: {mode} ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
