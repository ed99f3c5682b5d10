"""training entry point of the port (the root `train.py`'s counterpart):

    python -m detect_to_track_tpu_torch.train -c cfg/default.yaml
    python -m detect_to_track_tpu_torch.train --synthetic --max-iters 8 --device cpu

    torchrun --nproc-per-node N -m detect_to_track_tpu_torch.train -c CFG  # NUM_DEVICES: N in CFG

Builds the model, the datasets and the trainer from a flat-key YAML config
and runs the early-stopping training loop on `--device` (cuda by default;
it raises when there is no card). `--resume` continues from OUTPUT_DIR's
newest checkpoint, `--synthetic` trains on generated frame pairs (no ILSVRC
tree needed) and `--torch-weights` loads a torchvision ResNet state_dict
file into the backbone.

Data parallelism: with NUM_DEVICES (or NUM_HOSTS) above 1, or under a
launcher (torchrun sets WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT), the process joins the process group before it builds the
model: on the card it takes cuda:LOCAL_RANK unless `--device` names an
index, and the backend is NCCL there and gloo on the CPU unless
`--dist-backend` names another (two ranks on one card need gloo). The
group is destroyed at exit.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser
from typing import Optional, Sequence


def build_managers(cfg, synthetic: bool):
    """(train, val, report) data managers: the synthetic dataset at
    INPUT_SHAPE (seeds 0, 1, 2), or the ILSVRC VID / DET tree at DATA_ROOT."""
    if synthetic:
        from .data.synthetic import SyntheticVIDManager

        return tuple(
            SyntheticVIDManager(n_samples=n, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, seed=seed)
            for seed, n in enumerate((cfg.TRN_SIZE, cfg.VAL_SIZE, cfg.REP_SIZE))
        )
    from .data.imagenet import setup_vid_datasets

    return setup_vid_datasets(
        cfg.DATA_ROOT, cfg.VID_PARTITION_SIZES, cfg.TRN_SIZE, cfg.VAL_SIZE, cfg.REP_SIZE, cfg.P_DET, cfg.A
    )


def _exec_restart() -> None:
    """the host-RSS watchdog's action: re-exec this process with --resume
    (the trainer has already saved `ckpt_autosave`). The command line is the
    interpreter's own (`-m` included); a rank leaves its process group first
    and re-joins it through the same environment, under the next restart
    count's store keys."""
    import torch.distributed as dist

    argv = list(sys.orig_argv[1:])
    if "--resume" not in argv:
        argv.append("--resume")
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
        os.environ["D2T_RESTARTS"] = str(int(os.environ.get("D2T_RESTARTS", "0")) + 1)
    print(f"re-exec for host-memory hygiene: {argv}", flush=True)
    os.execv(sys.executable, [sys.executable] + argv)


def main(argv: Optional[Sequence[str]] = None):
    """parse `argv` (sys.argv[1:] when None), train, and return the
    trainer."""
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--cfg", default="cfg/default.yaml", help="path to cfg file")
    parser.add_argument("--resume", action="store_true", help="resume from OUTPUT_DIR's newest checkpoint")
    parser.add_argument("--synthetic", action="store_true", help="train on the synthetic dataset (no ILSVRC needed)")
    parser.add_argument(
        "--torch-weights", default=None, help="path to a torchvision ResNet state_dict (.pt) for the backbone"
    )
    parser.add_argument("--max-iters", type=float, default=float("inf"))
    parser.add_argument(
        "--device", default="cuda", help="cuda (default; a rank of a group takes cuda:LOCAL_RANK), cuda:N or cpu"
    )
    parser.add_argument(
        "--dist-backend", default=None, help="process group backend: nccl on cuda, gloo on cpu unless named here"
    )
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from .config import load_config
    from .parallel import init_distributed, launched, rank_device
    from .utils import resolve_device

    cfg = load_config(args.cfg)
    if cfg.NUM_DEVICES > 1 or cfg.NUM_HOSTS > 1 or launched():
        # join the group before the model is built (the JAX entry point
        # initializes its distributed runtime first too)
        device = rank_device(args.device)
        init_distributed(device, backend=args.dist_backend)
        try:
            return _train(args, cfg, device)
        finally:
            dist.destroy_process_group()
    return _train(args, cfg, resolve_device(args.device))


def _train(args, cfg, device):
    import torch
    import torch.distributed as dist

    from .models import DetectTrackModule
    from .trainer import DetectTrackTrainer

    rank0 = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    if rank0 and os.environ.get("WANDB_MODE", "disabled") != "disabled":
        # wandb.init() blocks without network or credentials, so it runs
        # only when the user opts in through WANDB_MODE
        try:
            import wandb

            wandb.init(config=cfg.__dict__)
        except Exception as e:  # noqa: BLE001 - the run goes on with the JSONL log
            print(f"WARNING: WANDB_MODE set but wandb.init failed ({e}); falling back to JSONL/stdout logging")

    model = DetectTrackModule.from_config(cfg, device=device)
    trn_manager, val_manager, rep_manager = build_managers(cfg, args.synthetic)
    if args.torch_weights:
        from .models.convert import convert_torch_state_dict

        sd = torch.load(args.torch_weights, map_location="cpu", weights_only=False)
        model.backbone.load_state_dict(convert_torch_state_dict(sd, cfg.BACKBONE_ARCH))

    trainer = DetectTrackTrainer(model, trn_manager, val_manager, rep_manager, cfg, device=device)
    try:
        if args.resume:
            trainer.restore()
        trainer.on_host_memory_limit = _exec_restart
        trainer.run(max_iters=args.max_iters)
    finally:
        trainer.close()
    return trainer


if __name__ == "__main__":
    main()
