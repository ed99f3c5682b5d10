"""the readings a cell's limits are set from, for many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... --seconds <s> [--faults]

For each seed, as a run does: set-up, warm-up, `--seconds` of timed calls,
the sample of calls the run would judge, and the numbers compared for the
program's outputs. Then the control: the plain reference with every
operand rounded to float8 e4m3 (the precision one step below the
configuration's bfloat16) put in the program's place for the same calls,
judged the same way. With `--faults`, also the numbers of the sampled
calls run again with a fault planted in the program (FAULTS) or in its
outputs (OUTPUT_FAULTS). Prints one JSON line a seed:
{"seed", "calls", "program": {...}, "detections" (the program's valid
detections a frame), "faults": {...}, "control": {...}}.
The benchmark's runs do not run this.
"""

import argparse
import contextlib
import dataclasses
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def nms_skipped(state):
    """the program's proposal filter without NMS: its op keeps every valid
    candidate."""
    from detect_to_track_tpu_torch.ops import nms

    real = nms.nms_mask
    nms.nms_mask = lambda boxes, valid, iou_thresh: valid.clone()
    try:
        yield
    finally:
        nms.nms_mask = real


@contextlib.contextmanager
def gate_skipped(state):
    """the program's detections without the foreground gate."""
    cfg = state.detector.cfg
    state.detector.cfg = dataclasses.replace(cfg, EVAL_RCNN_CONF_THRESH=-1.0)
    try:
        yield
    finally:
        state.detector.cfg = cfg


def all_but_one(out):
    """every frame's valid detections but the first marked invalid."""
    confs, boxes, valid, tracks = (x.clone() for x in out)
    valid[..., 1:] = False
    return confs, boxes, valid, tracks


FAULTS = {"nms_skipped": nms_skipped, "gate_skipped": gate_skipped}
OUTPUT_FAULTS = {"all_but_one": all_but_one}


def _judged(runner, state, chosen, outputs) -> dict:
    """the numbers for the chosen calls had they returned `outputs`."""
    kept = state.outputs
    state.outputs = {**kept, **outputs}
    try:
        return runner.check(state, chosen)
    finally:
        state.outputs = kept


def readings(cell, seed: int, seconds: float, device="cuda", faults=False) -> dict:
    """one seed's numbers for the program, the control and, with `faults`,
    the planted faults."""
    import gc

    import numpy as np
    import torch

    from benchmark import spec
    from benchmark.reference import model as ref

    runner = spec.runner(cell)
    state = runner.setup(cell, seed, device)
    runner.warmup(state)
    calls = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or not calls:
        state.outputs[len(calls)] = runner.call(state, len(calls))
        calls.append(len(calls))
    chosen = runner.sample(state, calls, np.random.default_rng([abs(int(seed)), 1]))
    broken = {}
    if faults:
        for name, fault in FAULTS.items():
            with fault(state):
                broken[name] = {i: runner.call(state, i) for i in chosen}
    runner.release(state)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "calls": len(calls), "program": runner.check(state, chosen),
           "detections": float(np.mean([float(state.outputs[i][2].sum(-1).float().mean()) for i in chosen]))}
    if faults:
        for name, fault in OUTPUT_FAULTS.items():
            broken[name] = {i: fault(state.outputs[i]) for i in chosen}
        out["faults"] = {name: _judged(runner, state, chosen, o) for name, o in broken.items()}
    runner.substitute(state, chosen, ref.FP8)
    out["control"] = runner.check(state, chosen)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true", help="also read the planted faults")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import run, spec

    if not torch.cuda.is_available():
        print("calibrate.py: needs a CUDA device", file=sys.stderr)
        return 2
    run.build_kernels()
    cell = spec.load(args.workload, REPO)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, faults=args.faults)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
