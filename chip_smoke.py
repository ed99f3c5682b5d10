"""chip smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each printing a line:
  1. device: needs CUDA; prints the card's name and power limit.
  2. build: compiles every kernel of the port with nvcc (in parallel) into
     build/torch_kernels/ and prints the build seconds, each kernel's
     registers and spills (ptxas) and its tensor-core instructions (SASS).
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it, with its time, the plain version's
     time and the least time the card could take (the bound); the bf16
     tensor-core kernels (K1 and both backward kernels) also at d_max 1
     and 12, stride 3, C = 33 and a 5x7 map, with the bytes they stage
     from L2.
  4. slice: the full-width detect-and-track path (cfg/default.yaml: ResNet-50,
     608x1200, bf16) with random weights from a seed, through
     Detector.__call__ and Detector.detect_pairs on a batch of BATCH_SIZE
     pairs; the kernel launch counters are reset before and read after;
     the tracks are held against the same run with the plain correlation.
  5. clip: ClipTracker (frame_chunk 8) on a 22-frame clip with the slice
     phase's Detector: 3 chunks, each one detect_clip call (3 K1 launches)
     and the clip's link scores, then one launch of the linker kernel
     (ops/csrc/viterbi.cu); frames/s, device- against host-linked
     tubelets, the kernel against its plain version on the clip's score
     matrices and against the native linker on a 64-frame linking-only
     case, detect_clip's tracks against the plain correlation, and the
     call's device time by stage.
  6. train: full-width joint training steps (the same configuration, the
     package's seeded init, synthetic frame pairs at INPUT_SHAPE): one
     warm-up step, then
     timed steps with the launch counters reset before and read after;
     finite losses, frozen stages bitwise unchanged, the track loss's
     gradients with respect to c4 and c5 held against the plain
     correlation, and one step's device time by stage.
The kernels phase also holds the backward kernels (corr_bwd_fm0,
corr_bwd_fm1) against autograd through the plain version; the linker
kernel is held in the clip phase. The line before
the last is the kernels JSON; the last line is the device JSON. Any failed
check raises, so the script exits non-zero.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
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


def _demangle(names):
    """C++ names for mangled kernel symbols (c++filt where the machine has
    it, else the symbols as they are)."""
    import shutil

    if not names or not shutil.which("c++filt"):
        return {n: n for n in names}
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True).stdout
    return dict(zip(names, out.splitlines()))


def _kernel_short(name: str) -> str:
    """`void (anonymous namespace)::corr_fwd_mma_kernel<4>(...)` -> `corr_fwd_mma_kernel<4>`."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].removeprefix("void ")


def phase_build():
    """compile every kernel library, print each kernel's registers, stack
    and spills from ptxas, and count each kernel's tensor-core (HMMA /
    HGMMA) instructions in the SASS (cuobjdump). The bf16 kernels of the
    forward and of both backward gradients (every `*mma_kernel`) must have
    some."""
    import re

    from detect_to_track_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build()
    total = time.perf_counter() - t0
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    for name, info in built.items():
        log(f"[build] {name}: {info['seconds']:.2f} s -> {info['path'].name}")
        # ptxas -v: "Compiling entry function '<sym>'", then its stack/spill
        # line and its "Used N registers" line
        report, current = {}, None
        for line in info["log"].splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                current = m.group(1)
                report[current] = []
            elif current and ("spill" in line or "registers" in line):
                report[current].append(line.split(":", 1)[-1].strip() if "registers" in line else line.strip())
        names = _demangle(list(report))
        for sym, lines in report.items():
            log(f"[build]   {_kernel_short(names[sym])}: {'; '.join(lines)}")
        if info["log"] == "cached":
            log("[build]   (cached library: no ptxas report)")
        if not cuobjdump.exists():
            log(f"[build]   {cuobjdump} not found: tensor-core instructions not counted")
            continue
        sass = subprocess.run([str(cuobjdump), "-sass", str(info["path"])], capture_output=True, text=True,
                              check=True).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = m.group(1)
                counts[current] = {}
            elif current:
                op = re.search(r"\b(H[G]?MMA[.\w]*)", line)
                if op:
                    counts[current][op.group(1)] = counts[current].get(op.group(1), 0) + 1
        names = _demangle(list(counts))
        for sym, ops in counts.items():
            short = _kernel_short(names[sym])
            log(f"[build]   {short}: tensor-core instructions {ops or 'none'}")
            if "mma_kernel" in short and not ops:
                raise AssertionError(f"{short} has no tensor-core instruction in its SASS")
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
    """least time for one correlation kernel, forward or one backward map:
    two (B, H, W, C) maps and the (2d+1)^2 f32 planes each move once (the
    forward reads both maps and writes the planes; a backward kernel reads
    the planes' cotangent and the other map and writes one gradient),
    against the multiply-adds of the (2d)^2 planes that are not always zero
    (peak of the input's type)."""
    k2 = (2 * d_max + 1) ** 2
    nbytes = 2 * b * h * w * c * itemsize + b * k2 * h * w * 4
    flops = 2.0 * b * h * w * c * (2 * d_max) ** 2
    peak = F32_FLOPS if f32_math else BF16_TENSOR_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def staged_bytes(kernel, b, h, w, c, d, stride):
    """bytes a bf16 tensor-core kernel copies from L2 into shared memory in
    one call, from its staging geometry (corr_fwd.cu, corr_bwd.cu): every
    live fm1 window row (16 + 8 NT columns) and the fm0 tile per 32 output
    columns of a row for K1; for each live (output row, di) the map row's
    window (16 + 16 KS columns) and the 2 x 16 x 2d band values of g per 32
    output columns and 128 channels for the backward kernels (dFM1: di is
    live on the source row y - di + d; dFM0: on the output row). Each map
    byte is re-read about 2d times."""
    def live(p, r):  # correlation_window_masks along the height
        src = p + r - d
        return r < 2 * d and 0 <= src < h and (src - max(0, p - d)) % stride == 0

    tiles = -(-w // 32)
    if kernel == "corr_fwd":
        nt = -(-(15 + 2 * d) // 8)
        rows = sum(live(i, r) for i in range(h) for r in range(2 * d))
        return b * tiles * (rows * (16 + 8 * nt) + h * 32) * c * 2
    ks = -(-(15 + 2 * d) // 16)
    if kernel == "corr_bwd_fm1":
        rows = sum(0 <= y - r + d < h and live(y - r + d, r) for y in range(h) for r in range(2 * d))
    else:
        rows = sum(live(y, r) for y in range(h) for r in range(2 * d))
    return b * tiles * rows * ((16 + 16 * ks) * c * 2 + -(-c // 128) * 2 * 16 * 2 * d * 4)


def _odd_cases(dt):
    """shapes off the working point, each a case of the bf16 tensor-core
    kernels: (H, W, C, d_max, stride) at d_max 1 and 12, stride 3, C = 33
    (scalar staging, a partial chunk) and a 5x7 map smaller than the window."""
    return [(38, 75, 384, 1, 1, dt), (38, 75, 384, 12, 1, dt), (38, 75, 384, 8, 3, dt),
            (38, 75, 33, 8, 1, dt), (5, 7, 64, 8, 1, dt)]


def phase_kernels(pairs: int):
    """K1 against the plain version at the tracker's shapes (pairs x 38x75,
    C = 512 / 1024 / 2048, d 8), bf16 and f32, plus stride 2 and C = 384,
    and the bf16 odd cases."""
    import torch

    from detect_to_track_tpu_torch.ops.correlation import corr_fwd_cuda, pointwise_correlation

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(38, 75, c, 8, 1, dt) for c in (512, 1024, 2048) for dt in (torch.bfloat16, torch.float32)]
    cases += [(38, 75, 384, 8, 2, torch.bfloat16), (38, 75, 384, 8, 2, torch.float32),
              (38, 75, 384, 8, 1, torch.float32)]
    cases += _odd_cases(torch.bfloat16)
    rows = []
    for h, w, c, d, stride, dt in cases:
        fm0 = torch.randn(pairs, h, w, c, device="cuda", generator=gen).to(dt)
        fm1 = torch.randn(pairs, h, w, c, device="cuda", generator=gen).to(dt)
        got = pointwise_correlation(fm0, fm1, d, stride, impl="cuda", layout="k2hw")
        ref = pointwise_correlation(fm0, fm1, d, stride, impl="torch", layout="k2hw")
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        # both sum the same products in f32 (bf16 products are exact in f32;
        # bf16 sums on the tensor cores), in another order: the error is f32
        # rounding of a C-term sum, relative to the largest magnitude
        tol = 1e-5 * scale + 1e-5
        ok = err <= tol and got.shape == ref.shape
        ms = cuda_time_ms(lambda: corr_fwd_cuda(fm0, fm1, d, stride))
        plain_ms = cuda_time_ms(
            lambda: pointwise_correlation(fm0, fm1, d, stride, impl="torch", layout="k2hw"),
            iters=3, warmup=1,
        )
        bound, by = corr_bound_ms(pairs, h, w, c, d, fm0.element_size(), dt == torch.float32)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        staged = ""
        if dt == torch.bfloat16:
            nbytes = staged_bytes("corr_fwd", pairs, h, w, c, d, stride)
            staged = f" staged {nbytes / 1e6:.1f} MB = {nbytes / ms / 1e9:.2f} TB/s"
        log(f"[kernels] corr_fwd {h}x{w} C={c} d={d} {name} stride={stride}: max_abs_err={err:.3e} "
            f"(tol {tol:.3e}, max|ref| {scale:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={bound:.4f} ({by}){staged} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"corr_fwd disagrees with the plain version at {h}x{w} C={c} d={d} {name} "
                                 f"stride={stride}")
        rows.append(dict(h=h, c=c, d=d, dtype=name, stride=stride, err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by))
    return rows


def phase_bwd_kernels(pairs: int):
    """corr_bwd_fm0 and corr_bwd_fm1 against autograd through the plain
    version (the same inputs, the same f32 cotangent g) at the training
    step's shapes (pairs x 38x75, C = 1024 / 2048, d 8), bf16 and f32, plus
    stride 2 and H = 48 (the height the TPU package sends to its halo'd
    dFM1 kernel) at C = 384, and the bf16 odd cases."""
    import torch

    from detect_to_track_tpu_torch.ops import correlation as corr

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(38, 75, c, 8, 1, dt) for c in (1024, 2048) for dt in (torch.bfloat16, torch.float32)]
    cases += [(38, 75, 384, 8, 2, torch.bfloat16), (48, 75, 384, 8, 1, torch.bfloat16),
              (48, 75, 384, 8, 1, torch.float32)]
    cases += _odd_cases(torch.bfloat16)
    kernels = {
        "corr_bwd_fm0": (corr.corr_bwd_fm0_cuda, corr.corr_bwd_fm0_ref),
        "corr_bwd_fm1": (corr.corr_bwd_fm1_cuda, corr.corr_bwd_fm1_ref),
    }
    rows = []
    for h, w, c, d, stride, dt in cases:
        fm = torch.randn(pairs, h, w, c, device="cuda", generator=gen).to(dt)
        g = torch.randn(pairs, (2 * d + 1) ** 2, h, w, device="cuda", generator=gen)
        name = "bf16" if dt == torch.bfloat16 else "f32"
        for kname, (kernel, plain) in kernels.items():
            got = kernel(g, fm, d, stride)
            ref = plain(g, fm, d, stride)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            # f32: the same f32 products summed in another order; bf16: each
            # side rounds its f32 sum to bf16 once, one bf16 rounding apart,
            # and both tensor-core kernels round g to bf16 as the TPU kernels do
            tol = (8e-3 if dt == torch.bfloat16 else 1e-5) * scale + 1e-6
            ok = err <= tol and got.shape == ref.shape and got.dtype == ref.dtype
            ms = cuda_time_ms(lambda: kernel(g, fm, d, stride))
            plain_ms = cuda_time_ms(lambda: plain(g, fm, d, stride), iters=3, warmup=1)
            bound, by = corr_bound_ms(pairs, h, w, c, d, fm.element_size(), dt == torch.float32)
            staged = ""
            if dt == torch.bfloat16:
                nbytes = staged_bytes(kname, pairs, h, w, c, d, stride)
                staged = f" staged {nbytes / 1e6:.1f} MB = {nbytes / ms / 1e9:.2f} TB/s"
            log(f"[kernels] {kname} {h}x{w} C={c} d={d} {name} stride={stride}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}, max|ref| {scale:.3e}) ms={ms:.4f} plain_ms={plain_ms:.3f} "
                f"bound_ms={bound:.4f} ({by}){staged} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kname} disagrees with the plain version at {h}x{w} C={c} d={d} {name} "
                                     f"stride={stride}")
            rows.append(dict(kernel=kname, h=h, c=c, d=d, dtype=name, stride=stride, err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=bound, bound_by=by))
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
    phase_profile(f"detect_pairs x{len(pairs)}", lambda: det.detect_pairs(pairs))
    return launches, det


CLIP_FRAMES = 22
CLIP_CHUNK = 8


def clip_frames(h, w, n):
    """a seed-0 uint8 noise frame; frame t is it rolled by 4 t columns, so
    adjacent frames overlap."""
    import numpy as np

    base = np.random.default_rng(0).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return [np.roll(base, 4 * t, axis=1) for t in range(n)]


def link_problem(seed, t, d):
    """padded (T-1, D, D) link scores and (D,) init scores for a linking-only
    case: per frame a random count of live slots in [D/2, D], -inf outside
    them, scores multiples of 1/4 in [0, 2) (every DP sum exact in f32 and
    f64, so the native linker's f64 sums must give the kernel's paths)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dims = rng.integers(d // 2, d + 1, size=t)
    seq = np.full((t - 1, d, d), -np.inf, np.float32)
    for i in range(t - 1):
        seq[i, : dims[i], : dims[i + 1]] = rng.integers(0, 8, (dims[i], dims[i + 1])) / 4.0
    init = np.full(d, -np.inf, np.float32)
    init[: dims[0]] = rng.integers(0, 4, dims[0]) / 4.0
    return seq, init


def linker_dp_steps(spans):
    """DP steps the linker kernel runs for extractions with these spans, in
    extraction order (it re-runs the DP from max(0, start - 1) of the
    previous path), and the steps of a DP from step 0 per extraction (the
    plain version's)."""
    dirty = steps = full = 0
    for start, final in spans:
        if final == 0:  # the length-1 paths at t = 0 run no DP
            continue
        steps += max(0, final - dirty)
        full += final
        dirty = max(0, start - 1)
    return steps, full


def linker_bound_ms(t1, d, dp_steps):
    """least time for one extraction: the score matrices and init scores
    read once and the outputs (spans, scores, nodes of T * D rows) written
    once, against an add and a compare per matrix entry per DP step the
    extraction runs, at the f32 peak."""
    t = t1 + 1
    nbytes = (t1 * d * d + d) * 4 + t * d * (3 + t) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * dp_steps * d * d / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _same_paths(got, ref):
    import torch

    return (int(got.n_paths) == int(ref.n_paths) and torch.equal(got.spans, ref.spans)
            and torch.equal(got.nodes, ref.nodes) and torch.equal(got.scores.view(torch.int32), ref.scores.view(torch.int32)))


def _trimmed(paths):
    """DevicePaths -> [((start, end), score, nodes)] as the host linkers give them."""
    n = int(paths.n_paths)
    spans, scores, nodes = (x[:n].cpu().numpy() for x in (paths.spans, paths.scores, paths.nodes))
    return [((int(s), int(e)), float(sc), nd[s : e + 1].tolist()) for (s, e), sc, nd in zip(spans, scores, nodes)]


def phase_clip(smi: str, det):
    """the clip path: ClipTracker(det, frame_chunk=CLIP_CHUNK, min_len=2) on
    CLIP_FRAMES frames, one warm-up call, then two timed calls with the
    kernel counters reset before and read after (3 K1 launches per chunk, 1
    linker launch per clip). Then, outside the count: a valid detection in
    every frame, device- against host-linked tubelets, the linker kernel
    against its plain version on the clip's score matrices and against the
    native linker on a 64-frame linking-only case, detect_clip's tracks
    against the plain correlation, and a profiled call. Returns the
    launches and the linker row of the kernels line."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch import viterbi_device as vd
    from detect_to_track_tpu_torch.clip import ClipTracker
    from detect_to_track_tpu_torch.ops.correlation import corr_fwd_cuda
    from detect_to_track_tpu_torch.viterbi import viterbi_multi_link

    cfg = det.cfg
    h, w = cfg.INPUT_SHAPE
    n, chunk = CLIP_FRAMES, CLIP_CHUNK
    frames = clip_frames(h, w, n)
    starts = list(range(0, n - chunk, chunk - 1)) + [n - chunk]
    # the random weights predict transforms near 1e10, which puts every
    # track box off the frame and psi at 0; the tracker's Linear scaled by a
    # power of two (exact) brings them near 0.1, so links have structure.
    # The confidences stay as they are: saturated, exactly 1.0, so every link
    # score is an integer and f32 and f64 linking agree exactly.
    probe = det.detect_clip(np.stack(frames[:2]))
    mag = probe.tracks[0][probe.valid[0]].abs().max().item()
    scale = 2.0 ** round(math.log2(0.1 / mag))
    with torch.no_grad():
        det.model.c_tracker.reg_fc.weight.mul_(scale)
        det.model.c_tracker.reg_fc.bias.mul_(scale)
    log(f"[clip] {n} frames (seed-0 noise frame rolled 4 columns per frame), chunk {chunk}: starts {starts}; "
        f"tracker Linear x2^{round(math.log2(scale))} (transforms up to {mag:.3e} -> {mag * scale:.3e})")

    tracker = ClipTracker(det, frame_chunk=chunk, min_len=2)
    t = time.perf_counter()
    tracker(frames)
    log(f"[clip] warm-up call {(time.perf_counter() - t) * 1e3:.1f} ms")

    # ---- the main path: counters from 0, read right after ----
    corr_fwd_cuda.launches = 0
    vd.viterbi_multi_link_cuda.launches = 0
    clip_s = []
    for r in range(2):
        before = (corr_fwd_cuda.launches, vd.viterbi_multi_link_cuda.launches)
        t = time.perf_counter()
        tubes = tracker(frames)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t)
        delta = (corr_fwd_cuda.launches - before[0], vd.viterbi_multi_link_cuda.launches - before[1])
        if delta != (3 * len(starts), 1):
            raise AssertionError(f"clip call {r}: launches (corr_fwd, linker) = {delta}, expected ({3 * len(starts)}, 1)")
        log(f"[clip] call {r}: {clip_s[-1] * 1e3:.1f} ms, {len(tubes)} tubelets, host upload time {tracker.last_upload_s * 1e3:.1f} ms")
    launches = {"corr_fwd": corr_fwd_cuda.launches, "viterbi_multi_link": vd.viterbi_multi_link_cuda.launches}
    log(f"[clip] kernel launches on the main path: {launches} in 2 clip calls")
    if not tubes:
        raise AssertionError("the clip gave no tubelet")
    lengths = [e - s + 1 for (s, e), _ in tubes]
    log(f"[clip] tubelets: {len(tubes)}, length min {min(lengths)} / median {sorted(lengths)[len(lengths) // 2]} / "
        f"max {max(lengths)}; {n / min(clip_s):.2f} clip frames/s ({min(clip_s) * 1e3:.1f} ms per {n}-frame clip, "
        f"best of 2); card: {smi}")

    # ---- checks, outside the main-path count ----
    # the chunks' detections and the clip's score matrices, first chunk
    # first for a frame two chunks share, as ClipTracker assembles them
    outs = [det.detect_clip(np.stack(frames[s : s + chunk])) for s in starts]
    n_valid, seq_slots, init = [None] * n, [None] * (n - 1), None
    for s, out in zip(starts, outs):
        seq, ini = tracker._chunk_scores(out)
        init = ini if s == 0 else init
        for fi in range(chunk):
            if n_valid[s + fi] is None:
                n_valid[s + fi] = int(out.valid[fi].sum())
            if fi < chunk - 1 and seq_slots[s + fi] is None:
                seq_slots[s + fi] = seq[fi]
    if min(n_valid) == 0:
        raise AssertionError(f"a frame has no valid detection: {n_valid}")
    seq = torch.stack(seq_slots)
    live = torch.isfinite(seq)
    log(f"[clip] valid detections per frame {n_valid}; score matrices {tuple(seq.shape)}: {int(live.sum())} live links, "
        f"{int((seq[live] >= 2.5).sum())} with psi = 1")

    host = ClipTracker(det, frame_chunk=chunk, min_len=2, device_linking=False)
    t = time.perf_counter()
    host_tubes = host(frames)
    host_s = time.perf_counter() - t
    same = len(host_tubes) == len(tubes) and all(
        sa == sb and ba.shape == bb.shape and np.abs(ba - bb).max() <= 1e-6 for (sa, ba), (sb, bb) in zip(tubes, host_tubes)
    )
    log(f"[clip] device-linked vs host-linked (native) tubelets: {len(tubes)} vs {len(host_tubes)}, "
        f"{'identical order, spans and boxes (1e-6)' if same else 'DIFFERENT'}; host-linked call {host_s * 1e3:.1f} ms")
    if not same:
        raise AssertionError("device- and host-linked tubelets differ")

    got = vd.viterbi_multi_link_cuda(seq, init)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ref = vd.viterbi_multi_link_ref(seq, init)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if not _same_paths(got, ref):
        raise AssertionError("the linker kernel disagrees with its plain version on the clip's score matrices")
    ms = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(seq, init), iters=10, warmup=2)
    seq_host, init_host = list(seq.double().cpu().numpy()), init.double().cpu().tolist()
    t = time.perf_counter()
    viterbi_multi_link(seq_host, init_host, use_native=True)
    native_ms = (time.perf_counter() - t) * 1e3
    paths = _trimmed(got)
    steps, full = linker_dp_steps([p[0] for p in paths])
    bound, by = linker_bound_ms(n - 1, cfg.max_dets, steps)
    log(f"[clip] linker {n - 1}x{cfg.max_dets}x{cfg.max_dets}: kernel = plain version (n_paths, spans, nodes, "
        f"bitwise scores); {len(paths)} paths ({sum(e > 0 for (_, e), _, _ in paths)} extractions), {steps} DP steps "
        f"run ({full} from step 0); ms={ms:.4f} plain_ms={plain_ms:.1f} native_ms={native_ms:.2f} bound_ms={bound:.6f} "
        f"({by}: the score matrices read once, outputs written once, an add and a compare per entry per DP step)")

    # the linking-only case: 64 frames, D 128, against the native linker
    seq64, init64 = link_problem(0, 64, cfg.max_dets)
    s64, i64 = torch.from_numpy(seq64).cuda(), torch.from_numpy(init64).cuda()
    got64 = _trimmed(vd.viterbi_multi_link_cuda(s64, i64))
    t = time.perf_counter()
    nat64 = viterbi_multi_link(list(seq64), list(init64), use_native=True)
    native64_ms = (time.perf_counter() - t) * 1e3
    if got64 != nat64:
        raise AssertionError("the linker kernel disagrees with the native linker at T = 64")
    ms64 = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(s64, i64), iters=5, warmup=1)
    steps64, full64 = linker_dp_steps([p[0] for p in got64])
    bound64, by64 = linker_bound_ms(seq64.shape[0], cfg.max_dets, steps64)
    log(f"[clip] linker {seq64.shape[0]}x{cfg.max_dets}x{cfg.max_dets} (dyadic scores, {100 * float(np.isinf(seq64).mean()):.1f}% -inf): "
        f"kernel = native linker (spans, nodes, scores); {len(got64)} paths ({sum(e > 0 for (_, e), _, _ in got64)} "
        f"extractions), {steps64} DP steps run ({full64} from step 0); ms={ms64:.4f} native_ms={native64_ms:.2f} "
        f"bound_ms={bound64:.6f} ({by64})")

    # detect_clip's tracks against the plain correlation (not the main path)
    det.model.c_tracker.corr_impl = "torch"
    plain = det.detect_clip(np.stack(frames[:chunk]))
    torch.cuda.synchronize()
    det.model.c_tracker.corr_impl = "auto"
    if not torch.equal(plain.valid, outs[0].valid) or not torch.equal(plain.boxes, outs[0].boxes):
        raise AssertionError("detect_clip's detections differ between kernel and plain correlation runs")
    v = outs[0].valid[:-1]
    scale = plain.tracks[v].abs().max().item()
    err = (outs[0].tracks[v] - plain.tracks[v]).abs().max().item()
    tol = 1e-3 * scale  # as the slice phase: bf16 rounding of the volumes in the fused head
    log(f"[clip] detect_clip tracks kernel vs plain correlation: max_abs_err={err:.3e} (tol {tol:.3e}, max|ref| {scale:.3e})")
    if not err <= tol:
        raise AssertionError("detect_clip's tracks disagree between the kernel and the plain correlation")

    phase_profile(f"ClipTracker {n} frames, chunk {chunk}", lambda: tracker(frames))
    row = dict(launches=launches["viterbi_multi_link"], err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    return launches, row


def phase_train(smi: str, steps: int = 3):
    """the full-width training path: make_train_step on cfg/default.yaml
    (ResNet-50, 608x1200, bf16, BATCH_SIZE pairs, FIRST_TRAINABLE_STAGE 3)
    from the seeded init, synthetic pairs at INPUT_SHAPE packed as uint8. One
    warm-up step, then `steps` timed steps with the kernel counters reset
    before and read after: 3 corr_fwd, 2 corr_bwd_fm0 and 2 corr_bwd_fm1
    launches per step (c3 comes from frozen stages, so its correlation has
    no backward). Returns the counts."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager
    from detect_to_track_tpu_torch.models import DetectTrackModule
    from detect_to_track_tpu_torch.ops import correlation as corr

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    p = cfg.BATCH_SIZE
    t0 = time.perf_counter()
    # the package's own seeded init (lecun-normal, identity FrozenBatchNorm),
    # as the JAX package starts training: the reference-keyed random
    # weights of the slice phase grow c5 to ~4e3 and the track loss to ~1e8,
    # and the first lr 1e-2 update diverges. Box heads scaled as there.
    model = DetectTrackModule.from_config(cfg, seed=0)
    with torch.no_grad():
        for head in (model.rpn.reg_fc, model.rcnn.reg_sm_conv):
            head.weight.mul_(0.002)
            head.bias.mul_(0.002)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model))
    manager = SyntheticVIDManager(n_samples=p * (steps + 1), image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES)
    loader = trainer.BatchLoader(manager, p, cfg, seed=0)
    try:
        # uint8 frames, as PIL sources pack: the /255 runs on the card
        batches = [b._replace(images=np.rint(b.images * 255.0).astype(np.uint8)) for b in loader]
    finally:
        loader.close()
    n_train = sum(t.numel() for t in model.parameters() if t.requires_grad)
    log(f"[train] {cfg.BACKBONE_ARCH} {cfg.INPUT_SHAPE} x{p} pairs {cfg.COMPUTE_DTYPE}, "
        f"FIRST_TRAINABLE_STAGE {cfg.FIRST_TRAINABLE_STAGE}: {n_train} trainable weights, "
        f"{len(batches)} synthetic batches (set-up {time.perf_counter() - t0:.1f} s)")
    watch = ("backbone.conv1.weight", "backbone.layer1.0.conv1.weight", "backbone.layer2.3.conv3.weight",
             "backbone.layer3.0.conv1.weight")
    before = {k: model.state_dict()[k].clone() for k in watch}

    def checked(dtl, what):
        vec = dtl.vector()
        if not bool(torch.isfinite(vec).all()):
            raise AssertionError(f"{what}: a loss is not finite: {dtl!r}")
        return vec.tolist()

    t = time.perf_counter()
    checked(step(batches[0]), "warm-up step")
    torch.cuda.synchronize()
    log(f"[train] warm-up step {(time.perf_counter() - t) * 1e3:.1f} ms")

    # ---- the main path: counters from 0, read right after ----
    counters = {"corr_fwd": corr.corr_fwd_cuda, "corr_bwd_fm0": corr.corr_bwd_fm0_cuda,
                "corr_bwd_fm1": corr.corr_bwd_fm1_cuda}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(steps):
        start = [fn.launches for fn in counters.values()]
        t = time.perf_counter()
        dtl = step(batches[1 + i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        delta = [fn.launches - s0 for fn, s0 in zip(counters.values(), start)]
        if delta != [3, 2, 2]:
            raise AssertionError(f"step {i}: launches (corr_fwd, corr_bwd_fm0, corr_bwd_fm1) = {delta}, expected [3, 2, 2]")
        o, a, c, r, tr = checked(dtl, f"step {i}")
        log(f"[train] step {i}: {step_s[-1] * 1e3:.1f} ms, losses o {o:.4e} a {a:.4e} c {c:.4e} r {r:.4e} t {tr:.4e}")
    launches = {name: fn.launches for name, fn in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if step.steps != steps + 1:
        raise AssertionError(f"{step.steps} updates counted after {steps + 1} steps")
    after = model.state_dict()
    for k in watch[:3]:
        if not torch.equal(before[k], after[k]):
            raise AssertionError(f"frozen weight {k} moved")
    if torch.equal(before[watch[3]], after[watch[3]]):
        raise AssertionError(f"trainable weight {watch[3]} did not move")
    log(f"[train] kernel launches on the main path: {launches} in {steps} steps; frozen stem and layer1-2 "
        "unchanged, layer3 moved")
    log(f"[train] {p / min(step_s):.2f} training pairs/s at batch {p} ({min(step_s) * 1e3:.1f} ms per step, "
        f"steps {[round(x * 1e3, 1) for x in step_s]} ms); peak memory {peak_gib:.2f} GiB; card: {smi}")

    train_track_grads(model, cfg, batches[0])
    phase_profile(f"train step x{p}", lambda: step(batches[1]))
    return launches


def train_track_grads(model, cfg, batch):
    """the track loss alone (COEFS weighs it 1e-4 in the step, so a wrong
    correlation gradient hardly shows in the parameters): its gradients with
    respect to the c4 and c5 maps through the kernels and through the plain
    correlation, on the same maps. Outside the main-path launch count."""
    import torch

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.encoding import track_encode
    from detect_to_track_tpu_torch.losses import track_loss
    from detect_to_track_tpu_torch.utils import split_pairs

    b = trainer.batch_to_device(batch, next(model.parameters()).device)
    n, two, h, w, c = b.images.shape
    with torch.no_grad():
        fmaps = model.backbone((b.images.float() / 255.0).reshape(n * two, h, w, c))
        _, _, fm_reg = model.rpn(fmaps["c4"])
    lbl = b.labels
    tt = track_encode(*(getattr(lbl, f)[:, fr] for fr in (0, 1) for f in ("boxes", "classes", "track_ids", "mask")))

    def grads(impl):
        model.c_tracker.corr_impl = impl
        leaves = {k: fmaps[k].detach().clone().requires_grad_() for k in ("c4", "c5")}
        pyr = {k: split_pairs(v) for k, v in {"c3": fmaps["c3"][:, ::2, ::2], **leaves}.items()}
        t_hat = model.c_tracker({k: v[0] for k, v in pyr.items()}, {k: v[1] for k, v in pyr.items()},
                                *split_pairs(fm_reg), tt.rois)
        loss = track_loss(t_hat, tt.t_star, tt.valid).mean()
        return (loss, *torch.autograd.grad(loss, [leaves["c4"], leaves["c5"]]))

    try:
        got = grads("auto")
        ref = grads("torch")
    finally:
        model.c_tracker.corr_impl = "auto"
    torch.cuda.synchronize()
    loss_err = abs(got[0].item() - ref[0].item())
    if not loss_err <= 1e-3 * abs(ref[0].item()) or ref[0].item() <= 0:
        raise AssertionError(f"track loss {got[0].item()} (kernels) vs {ref[0].item()} (plain)")
    for name, x, r in (("c4", got[1], ref[1]), ("c5", got[2], ref[2])):
        scale = r.float().abs().max().item()
        err = (x.float() - r.float()).abs().max().item()
        # bf16 maps: each side rounds its f32 gradient sums to bf16 once
        # (one rounding apart, 2^-8 relative), and the loss's cotangent
        # depends on t_hat, whose correlation volumes differ by f32
        # rounding: 1e-2 of the largest magnitude
        tol = 1e-2 * scale
        log(f"[train] track-loss gradient wrt {name}, kernels vs plain correlation: max_abs_err={err:.3e} "
            f"(tol {tol:.3e}, max|ref| {scale:.3e}); track loss {got[0].item():.6e} vs {ref[0].item():.6e}")
        if not (scale > 0 and err <= tol and x.dtype == r.dtype):
            raise AssertionError(f"the track loss's gradient wrt {name} disagrees between kernels and plain correlation")


def phase_profile(label, fn, top: int = 15):
    """where the time of one warm call of fn goes on the card:
    torch.profiler's device time by pipeline stage (the port's `d2t::`
    ranges; the backward's kernels are launched from autograd's engine
    thread, so they are summed over its `evaluate_function` nodes instead)
    and by kernel, the device's busy share of the call's wall time, and the
    proposal filter's fixed-point NMS iterations (its `torch.equal`
    convergence tests). Outside the main-path launch count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda and not getattr(e, "is_user_annotation", False)]
    stages = [e for e in events if e.device_type != cuda and e.key.startswith("d2t::")]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy = sum(dev_us(e) for e in kernels)
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, {len(kernels)} kernel names")
    for e in stages:
        log(f"[profile]   stage {e.key[5:]:<16s} device {e.device_time_total / 1e3:8.3f} ms "
            f"{100 * e.device_time_total / max(busy, 1e-9):5.1f}% of busy, host {e.cpu_time_total / 1e3:8.3f} ms")
    bwd = [e for e in events if e.device_type != cuda and e.key.startswith("autograd::engine::evaluate_function")]
    if bwd:
        bwd_us = sum(e.device_time_total for e in bwd)
        log(f"[profile]   autograd backward nodes device {bwd_us / 1e3:8.3f} ms "
            f"{100 * bwd_us / max(busy, 1e-9):5.1f}% of busy, {sum(e.count for e in bwd)} nodes")
    nms_iters = sum(e.count for e in events if e.key == "aten::equal")
    log(f"[profile]   fixed-point NMS iterations (torch.equal calls): {nms_iters}")
    ranked = sorted(kernels, key=dev_us, reverse=True)
    # the top kernels, then the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < top or "corr_" in e.key or "viterbi" in e.key:
            log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {100 * dev_us(e) / max(busy, 1e-9):5.1f}%  x{e.count:<4d} "
                f"#{rank + 1:<3d} {e.key[:90]}")


def main() -> int:
    import torch

    if not (ROOT / "detect_to_track_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository (detect_to_track_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    rows = phase_kernels(pairs=4)
    bwd_rows = phase_bwd_kernels(pairs=4)
    slice_launches, det = phase_slice(smi)
    clip_launches, linker_row = phase_clip(smi, det)
    del det
    train_launches = phase_train(smi)
    # per call or step at the working point (bf16, 38x75, d 8, stride 1):
    # K1 over the three scales' channels, the backward kernels over c4 and c5
    def at_working_point(r, channels):
        return r["dtype"] == "bf16" and r["stride"] == 1 and r["h"] == 38 and r["d"] == 8 and r["c"] in channels

    main_rows = {"corr_fwd": [r for r in rows if at_working_point(r, (512, 1024, 2048))]}
    for name in ("corr_bwd_fm0", "corr_bwd_fm1"):
        main_rows[name] = [r for r in bwd_rows if r["kernel"] == name and at_working_point(r, (1024, 2048))]
    errs = {"corr_fwd": [r["err"] for r in rows]}
    for name in ("corr_bwd_fm0", "corr_bwd_fm1"):
        errs[name] = [r["err"] for r in bwd_rows if r["kernel"] == name]
    meta = {
        "corr_fwd": ("detect_to_track_tpu_torch/ops/csrc/corr_fwd.cu", "detect_to_track_tpu/ops/correlation.py:92",
                     slice_launches + clip_launches["corr_fwd"] + train_launches["corr_fwd"]),
        "corr_bwd_fm0": ("detect_to_track_tpu_torch/ops/csrc/corr_bwd.cu", "detect_to_track_tpu/ops/correlation.py:187",
                         train_launches["corr_bwd_fm0"]),
        # one kernel for both TPU dFM1 kernels: K3 (:378, H <= 40) and K4 (:267)
        "corr_bwd_fm1": ("detect_to_track_tpu_torch/ops/csrc/corr_bwd.cu",
                         "detect_to_track_tpu/ops/correlation.py:378,267", train_launches["corr_bwd_fm1"]),
    }
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max(errs[name]),
        "ms": sum(r["ms"] for r in main_rows[name]),
        "plain_ms": sum(r["plain_ms"] for r in main_rows[name]),
        "bound_ms": sum(r["bound_ms"] for r in main_rows[name]),
        "bound_by": main_rows[name][0]["bound_by"],
        "library_ms": None,
    } for name, (source, replaces, launches) in meta.items()]
    kernels.append({
        "name": "viterbi_multi_link",
        "route": "cuda",
        "source": "detect_to_track_tpu_torch/ops/csrc/viterbi.cu",
        "replaces": "detect_to_track_tpu/viterbi_device.py:155 (viterbi_multi_link_scan, an XLA program, not a Pallas kernel)",
        "launches": linker_row["launches"],
        "max_abs_err": linker_row["err"],
        "ms": linker_row["ms"],
        "plain_ms": linker_row["plain_ms"],
        "bound_ms": linker_row["bound_ms"],
        "bound_by": linker_row["bound_by"],
        "library_ms": None,
    })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
