"""evaluation entry point of the port (the root `evaluate.py`'s
counterpart): detection mAP for a trained checkpoint.

    python -m detect_to_track_tpu_torch.evaluate -c cfg/default.yaml --ckpt output/ckpt
    python -m detect_to_track_tpu_torch.evaluate --ckpt output/ckpt --all-ckpts
    python -m detect_to_track_tpu_torch.evaluate --synthetic --device cpu   # smoke

Runs on `--device` (cuda by default; it raises when there is no card). With
`--all-ckpts` it scores every rotating `ckpt_step_*` beside `--ckpt`, oldest
first, then `--ckpt` itself, through one Detector whose weights are swapped
per checkpoint.
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import List, Optional, Sequence


def _step_of(p: Path) -> Optional[int]:
    """the step of a `ckpt_step_<n>` name, None for another suffix (a
    user's ckpt_step_250.bak beside the history is skipped, not fatal)."""
    try:
        return int(p.name.rsplit("_", 1)[1])
    except ValueError:
        return None


def checkpoint_paths(ckpt: str, all_ckpts: bool, min_step: int = 0) -> List[Path]:
    """the checkpoints to score: with `all_ckpts` the rotating history
    beside `ckpt` at steps >= min_step, oldest first, then `ckpt` itself
    unless it is one of them. Paths are resolved, so a symlinked or
    '..'-spelled `ckpt` that is a history entry is scored once."""
    main_path = Path(ckpt).resolve()
    paths = []
    if all_ckpts:
        paths = [
            p.resolve()
            for p in sorted(main_path.parent.glob("ckpt_step_*"))
            if (s := _step_of(p)) is not None and s >= min_step
        ]
    if main_path not in paths:
        paths.append(main_path)
    return paths


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """parse `argv` (sys.argv[1:] when None), evaluate, print one line per
    checkpoint and return those metrics (with "ckpt" and "step" keys)."""
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--cfg", default="cfg/default.yaml")
    parser.add_argument("--ckpt", default=None, help="checkpoint file written by the port's trainer")
    parser.add_argument(
        "--reference-weights", default=None, help="torch state_dict (.pt) saved by the reference trainer"
    )
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--n-samples", type=int, default=100)
    parser.add_argument(
        "--all-ckpts",
        action="store_true",
        help="also evaluate every rotating ckpt_step_* next to --ckpt (mAP against step)",
    )
    parser.add_argument(
        "--min-step", type=int, default=0, help="with --all-ckpts: skip rotating checkpoints below this step"
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.reference_weights and args.ckpt:
        # both would set the weights, and whichever won would misattribute the mAP
        parser.error("--reference-weights and --ckpt are mutually exclusive")

    import torch

    from .config import load_config
    from .evaluation import evaluate_detector
    from .inference import Detector
    from .models import DetectTrackModule
    from .utils import resolve_device

    cfg = load_config(args.cfg)
    device = resolve_device(args.device)
    model = DetectTrackModule.from_config(cfg, device=device)  # seeded init: the smoke run's weights
    if args.reference_weights:
        from .models.convert import load_reference_state_dict

        sd = torch.load(args.reference_weights, map_location="cpu", weights_only=False)
        model.load_state_dict(load_reference_state_dict(sd))

    if args.synthetic:
        from .data.synthetic import SyntheticVIDManager

        manager = SyntheticVIDManager(
            n_samples=args.n_samples, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES, seed=1
        )
    else:
        # the val manager alone: the training split's snippet partition,
        # without parsing every DET annotation
        from .data.imagenet import setup_val_manager

        manager = setup_val_manager(cfg.DATA_ROOT, cfg.VID_PARTITION_SIZES, args.n_samples)

    detector = Detector(model, cfg, device)
    results = []
    for path in checkpoint_paths(args.ckpt, args.all_ckpts, args.min_step) if args.ckpt else [None]:
        step = None
        if path is not None:
            state = torch.load(path, map_location=device, weights_only=True)
            detector.model.load_state_dict(state["model"])
            step = int(state["step"])
        metrics = evaluate_detector(detector, manager, cfg.N_CLASSES)
        tag = None if path is None else (path.name if path.name != "ckpt" else "ckpt(best)")
        results.append({"ckpt": tag, "step": step} | metrics)
        print({"ckpt": tag, "step": step} | {k: round(v, 4) for k, v in sorted(metrics.items())}, flush=True)
    return results


if __name__ == "__main__":
    main()
