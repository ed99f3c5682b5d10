"""manual sanity checks of the port (the root `checks.py`'s counterpart):

    python -m detect_to_track_tpu_torch.checks --sampler -c cfg/default.yaml   # dump sampled pairs
    python -m detect_to_track_tpu_torch.checks --anchors -c cfg/default.yaml   # anchor statistics
    python -m detect_to_track_tpu_torch.checks --synthetic --sampler           # no ILSVRC needed

The sampler check draws 4 frame pairs (VIDSampler over DATA_ROOT, or the
synthetic dataset), draws their labelled boxes and writes the frames as PNG
files under `--out` (default OUTPUT_DIR/checks). The anchor check reads the
anchors and boundary mask the training step puts on `--device` (cuda by
default; it raises when there is no card).
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def check_sampler(cfg, synthetic: bool, out_dir: Path) -> List[Path]:
    """write 4 sampled pairs with their labels drawn; returns the files."""
    from PIL import Image

    from .vis import draw_detections

    if synthetic:
        from .data.synthetic import SyntheticVIDManager

        manager = SyntheticVIDManager(n_samples=4, image_hw=(128, 192), n_classes=cfg.N_CLASSES)
        pairs = [manager[i] for i in range(4)]

        def to_pil(a):
            return Image.fromarray((a * 255).astype(np.uint8))
    else:
        from .data.imagenet import VIDSampler, find_vid_trn_snippet_ids

        ids = find_vid_trn_snippet_ids(cfg.DATA_ROOT)
        sampler = VIDSampler(cfg.DATA_ROOT, ids, cfg.A)
        pairs = [sampler.sample() for _ in range(4)]

        def to_pil(im):
            return im.convert("RGB")

    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for n, (i0, i1) in enumerate(pairs):
        for f, inst in enumerate((i0, i1)):
            im = to_pil(inst.im)
            boxes = np.array([lbl.box for lbl in inst.labels]).reshape(-1, 4)
            draw_detections(im, boxes, [lbl.class_name for lbl in inst.labels])
            path = out_dir / f"check_sampler_{n}_{f}.png"
            im.save(path)
            written.append(path)
            print(f"wrote {path} ({len(inst.labels)} objects)")
    return written


def check_anchors(cfg, device=None) -> dict:
    """print and return the statistics of the anchor grid and its
    boundary mask as the training step holds them on `device`."""
    from .trainer import _anchor_tensors
    from .utils import resolve_device

    anchors, crosses = _anchor_tensors(cfg, resolve_device(device))
    stats = {
        "anchors": int(anchors.shape[0]),
        "crossing": int(crosses.sum()),
        "height": (float(anchors[:, 2].min()), float(anchors[:, 2].max())),
        "width": (float(anchors[:, 3].min()), float(anchors[:, 3].max())),
    }
    print(
        f"anchors: {stats['anchors']} ({cfg.fm_shape[0]}x{cfg.fm_shape[1]} cells x "
        f"{cfg.n_anchors_per_cell}/cell)"
    )
    print(f"boundary-crossing (ignored in training): {stats['crossing']} "
          f"({100 * stats['crossing'] / stats['anchors']:.1f}%)")
    print(f"height range: [{stats['height'][0]:.4f}, {stats['height'][1]:.4f}]")
    print(f"width range:  [{stats['width'][0]:.4f}, {stats['width'][1]:.4f}]")
    return stats


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--cfg", default="cfg/default.yaml")
    parser.add_argument("--sampler", action="store_true")
    parser.add_argument("--anchors", action="store_true")
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--out", default=None, help="where the sampler check writes (default OUTPUT_DIR/checks)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .config import load_config
    from .utils import resolve_device

    cfg = load_config(args.cfg)
    if not (args.sampler or args.anchors):
        parser.error("nothing to check: pass --sampler and/or --anchors")
    device = resolve_device(args.device)
    if args.sampler:
        check_sampler(cfg, args.synthetic, Path(args.out or Path(cfg.OUTPUT_DIR) / "checks"))
    if args.anchors:
        check_anchors(cfg, device)


if __name__ == "__main__":
    main()
