"""time the port's three end-to-end paths in one process and print one JSON
line of medians: Detector.detect_pairs at BATCH_SIZE pairs, a ClipTracker
call on chip_smoke.py's 22-frame clip (frame_chunk 8) and a training step
(make_train_step at BATCH_SIZE pairs), at chip_smoke.py's full-width
configuration (cfg/default.yaml, random weights from seed 0, synthetic
inputs). Each call is synced and timed on the host clock after warm-up
calls, so the medians include the host's pace.

    python tools/e2e_ab.py [--root DIR] [--reps N]

--root takes the package, the configuration and the chip_smoke.py helpers
from another checkout (default: this one), so an A/B of two commits runs
each in its own processes, in turns, in one call. Needs a CUDA card;
imports no JAX.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _median_ms(fn, reps: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout whose package and chip_smoke.py run (default: this one)")
    ap.add_argument("--reps", type=int, default=15, help="timed calls of each path (clips: a third as many)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.clip import ClipTracker
    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.inference import Detector

    smi = cs.phase_device()
    cs.phase_build()
    cfg = load_config(str(root / "cfg" / "default.yaml"))
    det = Detector(cs.slice_model(cfg), cfg)
    pairs = cs.slice_pairs(cfg)
    pair_ms = _median_ms(lambda: det.detect_pairs(pairs), args.reps, 3)
    frames = cs.clip_frames(*cfg.INPUT_SHAPE, cs.CLIP_FRAMES)
    tracker = ClipTracker(det, frame_chunk=cs.CLIP_CHUNK, min_len=2)
    clip_ms = _median_ms(lambda: tracker(frames), max(args.reps // 3, 1), 2)
    del det, tracker
    model = cs.train_model(cfg)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model))
    batch = cs.train_batches(cfg, 1)[0]
    step_ms = _median_ms(lambda: step(batch), args.reps, 2)
    p = cfg.BATCH_SIZE
    print(json.dumps({"root": str(root), "card": smi, "pairs_per_s": p / pair_ms * 1e3,
                      "clip_frames_per_s": cs.CLIP_FRAMES / clip_ms * 1e3, "train_pairs_per_s": p / step_ms * 1e3,
                      "pair_call_ms": pair_ms, "clip_ms": clip_ms, "step_ms": step_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
