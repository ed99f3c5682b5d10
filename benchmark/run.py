"""run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic, runner, limits and per-layer readers
are found by name (spec.py). One run: set-up (the kernels built or loaded
from build/ in the checkout, weights and inputs made from the seed, the
cell's shapes warmed up), then `--seconds` of calls in a closed loop, then
the comparison of a sample of the window's outputs with the plain
reference. `--trace 0` prints the cell's end-to-end metrics; `--trace 1`
runs half the window unprofiled (for `mfu` and the idle share), then
`profiled_calls` calls under torch.profiler, then the profiled calls'
batches once more, untimed, to record the inputs of the hand-written
kernels for their bounds, and prints the per-layer metrics, the device's busy
and window seconds and a breakdown. The numbers compared and their limits
end standard error and the result line. Exits non-zero, printing no
result, without enough CUDA devices, or if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "detect_to_track_tpu")


def forbidden_modules():
    """loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def build_kernels() -> None:
    """build every kernel library of the program at once (nvcc in parallel)
    into the checkout's build/, or find them there."""
    from detect_to_track_tpu_torch.ops import _build

    _build.build()


def measure(cell, seed: int, seconds: float, trace: bool, device="cuda", t_start: float = T_START) -> dict:
    """one run of `cell`; returns the result line's object."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import spec
    from benchmark.trace import Context, Profile

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    runner = spec.runner(cell)
    state = runner.setup(cell, seed, device)
    runner.warmup(state)
    sync()
    setup_s = time.perf_counter() - t_start

    per_call = runner.items_per_call(state)
    calls, latencies = [], []
    # the outputs of a seeded share of the calls are kept for the comparison
    # (the first call always): holding every call's would grow the
    # collector's work through the window
    keep_share = cell.traffic.get("kept_share", 1.0)
    keep_draws = np.random.default_rng([abs(int(seed)), 2])

    def run_call():
        i = len(calls)
        out = runner.call(state, i)
        if i == 0 or keep_draws.random() < keep_share:
            state.outputs[i] = out
        calls.append(i)

    def loop(until: float):
        start = time.perf_counter()
        end = start
        while end - start < until:
            t0 = time.perf_counter()
            run_call()
            end = time.perf_counter()
            latencies.append(end - t0)
        return end - start

    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        window_s = loop(seconds)
        values = runner.end_to_end(len(calls) * per_call, window_s, latencies)
        values["setup_s"] = setup_s
    else:
        seconds_unprofiled = loop(seconds / 2)
        items_unprofiled = len(calls) * per_call
        n_prof = cell.traffic["profiled_calls"]
        with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * on_card) as prof:
            sync()
            t0 = time.perf_counter()
            for _ in range(n_prof):
                run_call()
            sync()
            wall = time.perf_counter() - t0
        prof_calls = calls[-n_prof:]
        prof_info = Profile(prof, wall, n_prof, n_prof * per_call)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if trace:
        kernel_bounds = runner.kernel_bounds_ms(state, prof_calls)
    runner.release(state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    got = runner.check(state, runner.sample(state, sorted(state.outputs), np.random.default_rng([abs(int(seed)), 1])))
    print(f"run.py: the comparison took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    checks = {k: {"value": float(v), "limit": float(cell.limits.get(k, math.nan))} for k, v in got.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    if not trace:
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    else:
        ctx = Context(cell, runner, state, items_unprofiled, seconds_unprofiled, prof_info, kernel_bounds)
        for m in cell.per_layer:
            v = spec.reader(cell, m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    result["correct"] = bool(correct)
    result["attempted"] = len(calls)
    result["device"] = {
        "platform": "gpu" if on_card else torch.device(device).type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        result["device"]["busy_s"] = prof_info.busy_s
        result["device"]["window_s"] = prof_info.wall_s
        result["breakdown"] = {"device_ops": prof_info.top_ops(), "idle_gaps": prof_info.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the program at a fixed path in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(REPO / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(REPO / "build" / "triton")
    sys.path.insert(0, str(REPO))
    import torch

    from benchmark import spec

    cell = spec.load(args.workload, REPO)
    import detect_to_track_tpu_torch  # noqa: F401 -- the program under test; a checkout without it fails here

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    build_kernels()
    result = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
