"""chip smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles every kernel of the port with nvcc (in parallel) into
     build/torch_kernels/ and prints the build seconds.
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it, with its time, the plain version's
     time and the least time the card could take (the bound).
  4. slice: the full-width detect-and-track path (cfg/default.yaml: ResNet-50,
     608x1200, bf16) with random weights from a seed, through
     Detector.__call__ and Detector.detect_pairs on a batch of BATCH_SIZE
     pairs; the kernel launch counters are reset before and read after;
     the tracks are held against the same run with the plain correlation.
The line before the last is the kernels JSON; the last line is the device
JSON. Any failed check raises, so the script exits non-zero.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; the port's smoke test needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    # f32 checks compare like with like: no TF32 in convolutions or matmuls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build():
    from detect_to_track_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    total = time.perf_counter() - t0
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.2f} s -> {info['path'].name}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {total:.2f} s")


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """mean ms per call on the card, by CUDA events after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def corr_bound_ms(b, h, w, c, d_max, itemsize, f32_math):
    """least time for one correlation forward: each input read once and the
    (2d+1)^2 f32 planes written once, against the multiply-adds of the
    (2d)^2 planes that are not always zero (peak of the input's type)."""
    k2 = (2 * d_max + 1) ** 2
    nbytes = 2 * b * h * w * c * itemsize + b * k2 * h * w * 4
    flops = 2.0 * b * h * w * c * (2 * d_max) ** 2
    peak = F32_FLOPS if f32_math else BF16_TENSOR_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(pairs: int):
    """K1 against the plain version at the tracker's shapes (pairs x 38x75,
    C = 512 / 1024 / 2048, d 8), bf16 and f32, plus stride 2 and C = 384."""
    import torch

    from detect_to_track_tpu_torch.ops.correlation import corr_fwd_cuda, pointwise_correlation

    gen = torch.Generator(device="cuda").manual_seed(0)
    h, w, d = 38, 75, 8
    cases = [(c, dt, 1) for c in (512, 1024, 2048) for dt in (torch.bfloat16, torch.float32)]
    cases += [(384, torch.bfloat16, 2), (384, torch.float32, 2), (384, torch.float32, 1)]
    rows = []
    for c, dt, stride in cases:
        fm0 = torch.randn(pairs, h, w, c, device="cuda", generator=gen).to(dt)
        fm1 = torch.randn(pairs, h, w, c, device="cuda", generator=gen).to(dt)
        got = pointwise_correlation(fm0, fm1, d, stride, impl="cuda", layout="k2hw")
        ref = pointwise_correlation(fm0, fm1, d, stride, impl="torch", layout="k2hw")
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        # both sum the same products in f32, in another order: the error is
        # f32 rounding of a C-term sum, relative to the largest magnitude
        tol = 1e-5 * scale + 1e-5
        ok = err <= tol and got.shape == ref.shape
        ms = cuda_time_ms(lambda: corr_fwd_cuda(fm0, fm1, d, stride))
        plain_ms = cuda_time_ms(
            lambda: pointwise_correlation(fm0, fm1, d, stride, impl="torch", layout="k2hw"),
            iters=3, warmup=1,
        )
        bound, by = corr_bound_ms(pairs, h, w, c, d, fm0.element_size(), dt == torch.float32)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        log(f"[kernels] corr_fwd C={c} {name} stride={stride}: max_abs_err={err:.3e} "
            f"(tol {tol:.3e}, max|ref| {scale:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound:.4f} ({by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"corr_fwd disagrees with the plain version at C={c} {name} stride={stride}")
        rows.append(dict(c=c, dtype=name, stride=stride, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by))
    return rows


def phase_slice(smi: str):
    """the full-width main path: Detector.__call__ on single pairs and
    Detector.detect_pairs on BATCH_SIZE pairs, kernel counters read around
    it; then the same batch with the plain correlation, for the tracks."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.inference import Detector
    from detect_to_track_tpu_torch.models import DetectTrackModule
    from detect_to_track_tpu_torch.models.convert import load_reference_state_dict, random_reference_state_dict
    from detect_to_track_tpu_torch.ops.correlation import corr_fwd_cuda

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    t0 = time.perf_counter()
    sd = random_reference_state_dict(cfg, seed=0)
    # box-regression heads at trained-net magnitudes so decodes stay inside
    # the clamp (as the JAX package's pipeline parity test does)
    for k in ("rpn.reg_fc.weight", "rpn.reg_fc.bias", "rcnn.reg_head.sm_conv.weight", "rcnn.reg_head.sm_conv.bias"):
        sd[k] = sd[k] * 0.002
    model = DetectTrackModule.from_config(cfg)
    model.load_state_dict(load_reference_state_dict(sd))
    det = Detector(model, cfg)
    h, w = cfg.INPUT_SHAPE
    p = cfg.BATCH_SIZE
    rng = np.random.default_rng(0)
    pairs = rng.integers(0, 256, (p, 2, h, w, 3), dtype=np.uint8)
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"[slice] {cfg.BACKBONE_ARCH} {h}x{w} fm {cfg.fm_shape} anchors {cfg.n_anchors} "
        f"pre-NMS {cfg.pre_nms_cap_eval}/{cfg.pre_nms_topk_eval} MAX_ROIS {cfg.MAX_ROIS} MAX_DETS {cfg.MAX_DETS} "
        f"d_max {cfg.D_MAX} k {cfg.K} {cfg.COMPUTE_DTYPE}; {n_params} weights from seed 0 "
        f"(set-up {time.perf_counter() - t0:.1f} s)")

    def launched(fn):
        before = corr_fwd_cuda.launches
        out = fn()
        torch.cuda.synchronize()
        delta = corr_fwd_cuda.launches - before
        if delta != 3:
            raise AssertionError(f"expected 3 correlation kernel launches per batched call, got {delta}")
        return out

    # ---- the main path: counters from 0, read right after ----
    corr_fwd_cuda.launches = 0
    n_calls = 0
    call_s = []
    for r in range(3):
        t = time.perf_counter()
        confs0, confs1, boxes0, boxes1, tracks = launched(lambda: det(pairs[r % p, 0], pairs[r % p, 1]))
        call_s.append(time.perf_counter() - t)
        n_calls += 1
        for name, a, cols in (("confs0", confs0, cfg.N_CLASSES + 1), ("confs1", confs1, cfg.N_CLASSES + 1),
                              ("boxes0", boxes0, 4), ("boxes1", boxes1, 4), ("tracks", tracks, 4)):
            if a.ndim != 2 or a.shape[1] != cols or not np.isfinite(a).all():
                raise AssertionError(f"__call__ output {name} has shape {a.shape} or is not finite")
        if len(boxes0) == 0 or len(boxes1) == 0:
            raise AssertionError("__call__ returned no valid detection in a frame")
        log(f"[slice] __call__ {r}: {len(boxes0)} + {len(boxes1)} detections, {call_s[-1] * 1e3:.1f} ms")
    batch_s = []
    for r in range(3):
        t = time.perf_counter()
        out = launched(lambda: det.detect_pairs(pairs))
        batch_s.append(time.perf_counter() - t)
        n_calls += 1
    launches = corr_fwd_cuda.launches
    if launches != 3 * n_calls:
        raise AssertionError(f"corr_fwd launched {launches} times in {n_calls} batched calls")

    d = cfg.max_dets
    shapes = {"confs": (p, 2, d, cfg.N_CLASSES + 1), "boxes": (p, 2, d, 4), "valid": (p, 2, d), "tracks": (p, d, 4)}
    for name, shape in shapes.items():
        a = getattr(out, name)
        if tuple(a.shape) != shape:
            raise AssertionError(f"detect_pairs {name} shape {tuple(a.shape)} != {shape}")
        if a.dtype != torch.bool and not torch.isfinite(a).all():
            raise AssertionError(f"detect_pairs {name} is not finite")
    n_valid = out.valid.sum(-1)
    if (n_valid == 0).any():
        raise AssertionError(f"a frame of the batch has no valid detection: {n_valid.tolist()}")
    pairs_per_s = p / min(batch_s[1:])
    log(f"[slice] detect_pairs x{p}: valid per frame {n_valid.tolist()}, "
        f"{[round(s * 1e3, 1) for s in batch_s]} ms per call (first one warms up)")
    log(f"[slice] kernel launches on the main path: corr_fwd={launches} in {n_calls} batched calls")

    # ---- the same batch with the plain correlation (not the main path) ----
    det.model.c_tracker.corr_impl = "torch"
    ref = det.detect_pairs(pairs)
    torch.cuda.synchronize()
    det.model.c_tracker.corr_impl = "auto"
    if not torch.equal(ref.valid, out.valid) or not torch.equal(ref.boxes, out.boxes):
        raise AssertionError("the detections differ between kernel and plain correlation runs")
    v0 = out.valid[:, 0]
    scale = ref.tracks[v0].abs().max().item()
    err = (out.tracks[v0] - ref.tracks[v0]).abs().max().item()
    # the kernel's and the plain volumes agree to f32 rounding, but the
    # fused head rounds them to bf16, which can flip single roundings:
    # tolerance 1e-3 of the largest track magnitude
    tol = 1e-3 * scale
    log(f"[slice] tracks kernel vs plain correlation: max_abs_err={err:.3e} (tol {tol:.3e}, max|ref| {scale:.3e})")
    if not err <= tol:
        raise AssertionError("tracks disagree between the kernel and the plain correlation")
    log(f"[slice] {pairs_per_s:.2f} pairs/s at batch {p} ({min(batch_s[1:]) * 1e3:.1f} ms per batch); "
        f"__call__ {min(call_s[1:]) * 1e3:.1f} ms per pair; card: {smi}")
    phase_profile(det, pairs)
    return launches


def phase_profile(det, pairs, top: int = 15):
    """where the time of one warm detect_pairs call goes on the card:
    torch.profiler's device time by pipeline stage (the port's `d2t::`
    ranges) and by kernel, the device's busy share of the call's wall time,
    and the proposal filter's fixed-point NMS iterations (its
    `torch.equal` convergence tests). Outside the main-path launch count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        det.detect_pairs(pairs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    stages = [e for e in events if e.device_type != cuda and e.key.startswith("d2t::")]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy = sum(dev_us(e) for e in kernels)
    log(f"[profile] detect_pairs x{len(pairs)}: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, {len(kernels)} kernel names")
    for e in stages:
        log(f"[profile]   stage {e.key[5:]:<16s} device {e.device_time_total / 1e3:8.3f} ms "
            f"{100 * e.device_time_total / max(busy, 1e-9):5.1f}% of busy, host {e.cpu_time_total / 1e3:8.3f} ms")
    nms_iters = sum(e.count for e in events if e.key == "aten::equal")
    log(f"[profile]   fixed-point NMS iterations (torch.equal calls): {nms_iters}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:top]:
        log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {100 * dev_us(e) / max(busy, 1e-9):5.1f}%  x{e.count:<4d} {e.key[:90]}")


def main() -> int:
    import torch

    if not (ROOT / "detect_to_track_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository (detect_to_track_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    rows = phase_kernels(pairs=4)
    launches = phase_slice(smi)
    # K1 per batched call at the working point: the three scales' shapes
    main_rows = [r for r in rows if r["dtype"] == "bf16" and r["stride"] == 1]
    kernels = [{
        "name": "corr_fwd",
        "route": "cuda",
        "source": "detect_to_track_tpu_torch/ops/csrc/corr_fwd.cu",
        "replaces": "detect_to_track_tpu/ops/correlation.py:92",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": main_rows[0]["bound_by"],
        "library_ms": None,
    }]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
