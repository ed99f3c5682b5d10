"""training entry point of the port (the root `train.py`'s counterpart):

    python -m detect_to_track_tpu_torch.train -c cfg/default.yaml
    python -m detect_to_track_tpu_torch.train --synthetic --max-iters 8 --device cpu

Builds the model, the datasets and the trainer from a flat-key YAML config
and runs the early-stopping training loop on `--device` (cuda by default;
it raises when there is no card). `--resume` continues from OUTPUT_DIR's
newest checkpoint, `--synthetic` trains on generated frame pairs (no ILSVRC
tree needed) and `--torch-weights` loads a torchvision ResNet state_dict
file into the backbone.
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
    (the trainer has already saved `ckpt_autosave`)."""
    argv = list(sys.argv)
    if "--resume" not in argv:
        argv.append("--resume")
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
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from .config import load_config
    from .models import DetectTrackModule
    from .trainer import DetectTrackTrainer
    from .utils import resolve_device

    cfg = load_config(args.cfg)
    device = resolve_device(args.device)
    if os.environ.get("WANDB_MODE", "disabled") != "disabled":
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
