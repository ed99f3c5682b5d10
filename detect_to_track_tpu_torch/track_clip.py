"""clip tracking entry point of the port (after `examples/track_clip.py`):
frames -> detections -> tubelets.

    python -m detect_to_track_tpu_torch.track_clip -c cfg/default.yaml [--ckpt output/ckpt]
        [--frames DIR] [--n-frames 8] [--frame-chunk 4] [--host-linking] [--device cpu]

With no --frames, a synthetic clip of moving rectangles is generated, so it
runs anywhere, with or without a trained checkpoint; with no --ckpt the
package's seeded init is used (the mechanics are the same, the detections
noise). `ClipTracker` chunks the clip, runs the shared-backbone clip
forward, link-scores and Viterbi-links on the device (or on the host with
--host-linking) and returns tubelets. Runs on `--device` (cuda by default;
it raises when there is no card).
"""

from __future__ import annotations

from argparse import ArgumentParser
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def synthetic_clip(h: int, w: int, n_frames: int, seed: int = 0) -> List[np.ndarray]:
    """uint8 frames of three rectangles moving at constant velocity over
    faint noise."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(3, 2) * 0.5 + 0.25
    sizes = rng.rand(3, 2) * 0.15 + 0.1
    vel = (rng.rand(3, 2) - 0.5) * 0.04
    colors = (rng.rand(3, 3) * 0.7 + 0.3) * 255

    def frame(t: int) -> np.ndarray:
        im = (rng.rand(h, w, 3) * 25).astype(np.uint8)
        for o in range(3):
            ci, cj = centers[o] + t * vel[o]
            oh, ow = sizes[o]
            i0, i1 = int((ci - oh / 2) * h), int((ci + oh / 2) * h)
            j0, j1 = int((cj - ow / 2) * w), int((cj + ow / 2) * w)
            im[max(i0, 0) : max(i1, 1), max(j0, 0) : max(j1, 1)] = colors[o]
        return im

    return [frame(t) for t in range(n_frames)]


def main(argv: Optional[Sequence[str]] = None):
    """parse `argv` (sys.argv[1:] when None), track the clip, print the
    tubelets and return them."""
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--cfg", default="cfg/default.yaml")
    parser.add_argument("--ckpt", default=None, help="checkpoint file written by the port's trainer")
    parser.add_argument("--frames", default=None, help="directory of image frames (sorted lexically); default: synthetic")
    parser.add_argument("--n-frames", type=int, default=8)
    parser.add_argument("--frame-chunk", type=int, default=4, help="frames per detect_clip call")
    parser.add_argument(
        "--host-linking", action="store_true", help="use the host (native) Viterbi linker instead of the device one"
    )
    parser.add_argument("--min-len", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from .clip import ClipTracker
    from .config import load_config
    from .inference import Detector
    from .models import DetectTrackModule
    from .utils import resolve_device

    cfg = load_config(args.cfg)
    device = resolve_device(args.device)
    model = DetectTrackModule.from_config(cfg, device=device)
    if args.ckpt:
        state = torch.load(Path(args.ckpt), map_location=device, weights_only=True)
        model.load_state_dict(state["model"])

    if args.frames:
        from PIL import Image

        paths = sorted(p for p in Path(args.frames).iterdir() if p.suffix.lower() in (".jpeg", ".jpg", ".png"))
        clip = [Image.open(p).convert("RGB") for p in paths[: args.n_frames]]
    else:
        clip = synthetic_clip(*cfg.INPUT_SHAPE, args.n_frames)

    tracker = ClipTracker(
        Detector(model, cfg, device),
        min_len=args.min_len,
        frame_chunk=args.frame_chunk,
        device_linking=not args.host_linking,
    )
    tubelets = tracker(clip)
    print(f"{len(clip)} frames -> {len(tubelets)} tubelets")
    for (start, end), boxes in tubelets:
        print(f"  frames [{start}, {end}]: {end - start + 1} boxes, first ijhw={np.round(boxes[0], 3).tolist()}")
    return tubelets


if __name__ == "__main__":
    main()
