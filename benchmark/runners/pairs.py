"""traffic of kind `pairs`: batched detect-and-track calls in a closed loop
with one client.

Each call is `Detector.detect_pairs` on `pairs_per_call` host uint8 frame
pairs, timed from its start until its outputs (`confs`, `boxes`, `valid`,
`tracks`) are on the host. `batches` pre-made batches cycle. The traffic
file's keys: `pairs_per_call`, `batches`, `n_objects`, `warmup_calls`,
`kept_share` (the seeded share of calls whose outputs are kept),
`check_calls` (kept calls judged against the reference),
`profiled_calls` (calls under the profiler in a traced run).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import frames, weights
from ..counts import bounds, flops
from ..reference import judge as ref_judge
from ..reference import model as ref
from ..reference import ops as ref_ops


@dataclasses.dataclass
class State:
    cell: object
    sizes: ref.Sizes
    weights: Dict[str, torch.Tensor]
    batches: List[np.ndarray]
    device: torch.device
    detector: object = None
    outputs: Dict[int, tuple] = dataclasses.field(default_factory=dict)


def port_config(keys: Dict):
    """the program's Config from the configuration file's keys."""
    from detect_to_track_tpu_torch.config import Config

    tuples = {f.name for f in dataclasses.fields(Config) if isinstance(f.default, tuple)}
    return Config(**{k: tuple(v) if k in tuples else v for k, v in keys.items()})


def build_detector(cfg, w: Dict[str, torch.Tensor], device):
    from detect_to_track_tpu_torch.inference import Detector
    from detect_to_track_tpu_torch.models import DetectTrackModule

    model = DetectTrackModule.from_config(cfg, device=device)
    model.load_state_dict(w, strict=True)
    return Detector(model, cfg, device)


def setup(cell, seed: int, device) -> State:
    keys = cell.config["config"]
    cfg = port_config(keys)
    t = cell.traffic
    p, nb = t["pairs_per_call"], t["batches"]
    sizes = ref.Sizes.from_config(keys)
    w = weights.make(cell.config, seed, device)
    data = frames.pairs(seed, p * nb, tuple(keys["INPUT_SHAPE"]), t["n_objects"])
    weights.set_background(w, torch.from_numpy(data[0, 0]).to(device), sizes)
    state = State(cell, sizes, w, [data[i * p:(i + 1) * p] for i in range(nb)], torch.device(device))
    if state.device.type == "cuda":  # the reference's pass above sets no part of the program's peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(state.device)
    state.detector = build_detector(cfg, w, device)
    return state


def end_to_end(items: int, window_s: float, latencies: List[float]) -> Dict[str, float]:
    """pairs whose outputs reached the host over the window's time, and the
    nearest-rank 95th percentile of every call's time."""
    ordered = sorted(latencies)
    p95 = ordered[max(-(-95 * len(ordered) // 100) - 1, 0)]
    return {"pairs_per_s": items / window_s, "pairs_call_p95_ms": p95 * 1e3}


def items_per_call(state: State) -> int:
    return state.cell.traffic["pairs_per_call"]


def call(state: State, i: int):
    """the timed call: batch i mod `batches`, outputs on the host."""
    out = state.detector.detect_pairs(state.batches[i % len(state.batches)])
    return tuple(x.cpu() for x in out)


def warmup(state: State) -> None:
    for i in range(state.cell.traffic["warmup_calls"]):
        call(state, i)


def release(state: State) -> None:
    """free the program's state before the reference runs."""
    state.detector = None


def flops_per_item(state: State) -> float:
    return flops.pair_forward(state.cell.config["config"])


def _pair_outputs(host: tuple, p: int, device) -> ref.PairOutputs:
    return ref.PairOutputs(*(x[p].to(device) for x in host))


def sample(state: State, calls: List[int], rng: np.random.Generator) -> List[int]:
    """`check_calls` of the window's calls whose outputs were kept, drawn by
    rng."""
    n = min(state.cell.traffic["check_calls"], len(calls))
    return sorted(rng.choice(np.asarray(calls), size=n, replace=False).tolist())


def _anchors(state: State) -> torch.Tensor:
    s = state.sizes
    return torch.from_numpy(ref_ops.build_anchors(s.fm_hw, s.anchor_areas, s.anchor_ratios)).to(state.device)


def check(state: State, chosen: List[int]) -> Dict[str, float]:
    """the widest gaps between the outputs of the chosen calls and the
    reference (reference/judge.py); confidences are compared where the
    bins are stable within the cell's `box_gap` limit."""
    pairs, outs = [], []
    for i in chosen:
        batch = torch.from_numpy(state.batches[i % len(state.batches)]).to(state.device)
        for p in range(batch.shape[0]):
            pairs.append(batch[p])
            outs.append(_pair_outputs(state.outputs[i], p, state.device))
    slack = state.cell.limits.get("box_gap", 0.0)  # none before the cell's limits are set
    return ref_judge.judge(state.weights, pairs, _anchors(state), state.sizes, outs, slack)


def substitute(state: State, chosen: List[int], q: ref.Quant) -> None:
    """put the reference computed with operand rounding q in the program's
    place: the chosen calls' outputs become its outputs."""
    anchors = _anchors(state)
    with torch.no_grad(), ref.no_tf32():
        for i in chosen:
            batch = torch.from_numpy(state.batches[i % len(state.batches)]).to(state.device)
            outs = [ref.detect_pair(state.weights, pair, anchors, state.sizes, q) for pair in batch]
            state.outputs[i] = tuple(torch.stack([getattr(o, f) for o in outs]).cpu() for f in ref.PairOutputs._fields)


class _OpInputs(TorchDispatchMode):
    """records the arguments and output of each call of the named ops."""

    def __init__(self, names) -> None:
        super().__init__()
        self.names, self.seen = names, defaultdict(list)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._schema.name in self.names:
            self.seen[func._schema.name].append((args, out))
        return out


def kernel_bounds_ms(state: State, calls: List[int]) -> Dict[str, float]:
    """the least time of the hand-written kernels over `calls`, by the
    copied bound arithmetic: `corr_fwd` (3 launches a call) from the
    shapes; `nms_mask` and `psroi_fwd` (class and box head) from the
    inputs the program's ops took. Each batch of `calls` runs once more,
    untimed, with the ops' arguments recorded; the program is
    deterministic, so they are the inputs of the timed calls."""
    s = state.sizes
    p = state.cell.traffic["pairs_per_call"]
    fh, fw = s.fm_hw
    corr = sum(bounds.corr_bound_ms(p, fh, fw, c, s.d_max, 2, False)[0] for c in (512, 1024, 2048))
    per_batch = {}
    for b in sorted({i % len(state.batches) for i in calls}):
        with _OpInputs(("d2t::nms_mask", "d2t::psroi_fwd")) as seen:
            call(state, b)
        nms = sum(bounds.nms_bound_ms(boxes.float(), valid, keep, iou)[0]
                  for (boxes, valid, iou), keep in seen.seen["d2t::nms_mask"])
        psroi = sum(bounds.psroi_fwd_bound_ms(bd, n_t, bd.shape[-1], fg.shape[1], fg.shape[2])[0]
                    for (fg, bd, n_t), _ in seen.seen["d2t::psroi_fwd"])
        per_batch[b] = nms, psroi
    return {"corr_fwd": corr * len(calls),
            "nms_mask": sum(per_batch[i % len(state.batches)][0] for i in calls),
            "psroi_fwd": sum(per_batch[i % len(state.batches)][1] for i in calls)}
