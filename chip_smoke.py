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
     from L2; K1 and both backward kernels in both dtypes at d_max 20, 24
     and 32 on a 20x45 map (the forwards tiled in 16 x 16 displacements
     from d_max 17 / 20, the bf16 backward at KS = 4 and 5).
  4. psroi: PSROIPool's two kernels (ops/csrc/psroi.cu) at the R-FCN
     head's shapes (8 frames, 38x75, 256 rois, k 7; the class head's 1519
     and the box head's 196 channels) on bin-major maps gathered by both
     channel maps, in both storages (contiguous NHWC, the main path's,
     checked on the head's own convolutions, and NCHW), rois past the
     border and empty bins: the forward against the plain einsum form and
     the backward against autograd through it within 1e-5 of the largest
     magnitude, the backward bitwise the same on a repeat; each kernel's
     time beside its bound (reference-layout and bin-major elements), the
     plain version's time, one head's memory, and the R-FCN's bin-major
     weight gather and its gradient's fold (bitwise on a repeat).
  5. roipool: ROIPool's kernels (ops/csrc/roipool.cu) at the main paths'
     shapes (38x75, k 7, proposal-like rois past the border, with empty
     bins and larger than the frame, the corner-clamped bounds): the
     tracker's fused head (4 outputs) at BATCH_SIZE pairs with MAX_DETS
     rois (a pair call) and MAX_LABELS (a training step), and the
     materialized pooling at the oracle head's 1891 channels; each forward against its plain einsum form and each backward
     against autograd through it within 1e-5 of the largest magnitude, the
     backwards bitwise the same on a repeat; each kernel's time (kernel
     time and events) beside its bound, the plain version's time and the
     peak MiB of a forward and backward.
  6. slice: the full-width detect-and-track path (cfg/default.yaml: ResNet-50,
     608x1200, bf16) with random weights from a seed, through
     Detector.__call__ and Detector.detect_pairs on a batch of BATCH_SIZE
     pairs (3 corr_fwd, 1 nms_mask, 2 psroi_fwd and 1 roipool_linear_fwd
     launches per call); the kernel launch counters are reset before and
     read after; PSROIPool's maps contiguous NHWC (the train phase checks a
     step's too); the tracks are held against the same run with the plain
     correlation. A profile of the call, then one with the tracker's fused
     ROIPool head as its einsum form (the parent's), split the tracker
     stage (`d2t::roi_pool_linear`); the clip and train phases do the same.
  7. nms: the NMS kernel (ops/csrc/nms.cu) against its plain fixed-point
     loop, keep-masks bitwise, at the working point (8 frames x 3072
     slots, 3000 eligible) on the slice phase's decoded RPN boxes and on
     random boxes at IoU 0.3 and 0.5, at k = 1, 63, 64, 65 and 1000, at
     2 x 4096 (all valid, dense clusters) and 1 x 16,384, and against
     nms_np on one frame; its time, its two launches' times, the plain
     loop's time and the bound. Its first launch alone (the IoU bits,
     nms_iou_bits_cuda) into a poisoned scratch at the working point: the
     words at or above the diagonal bitwise compute_ious > t (t = 0.3, 0.5,
     IoUs of pairs and a float32 step below each; also with NaN, inf,
     subnormal and negative boxes mixed in), the words below it unwritten;
     its time against its own bound.
  8. export: export_detector on the slice phase's model at pair_batch
     BATCH_SIZE (torch.export; the program written to a temporary
     directory and deleted after the load), load_detector serving the slice
     phase's uint8 pairs: 3 corr_fwd, 1 nms_mask, 2 psroi_fwd and 1
     roipool_linear_fwd launches per served call, its outputs bitwise
     Detector.detect_pairs's, served against live pairs/s; the same for the HOST_S2D program against the HOST_S2D
     Detector. Prints the export and load seconds and the program's bytes.
  9. clip: ClipTracker (frame_chunk 8) on a 22-frame clip with the slice
     phase's Detector: 3 chunks, each one detect_clip call (3 K1, 1 NMS,
     2 PSROIPool forward and 1 fused ROIPool forward launches)
     and the clip's link scores, then one launch of the linker kernel
     (ops/csrc/viterbi.cu); frames/s, device- against host-linked
     tubelets, the kernel against its plain version on the clip's score
     matrices and against the native linker on a 64-frame linking-only
     case, the kernel against its plain version at D 1500 and 2048 (several
     slots per thread), each with the score matrices unchanged after the
     launch and the bytes its DP steps read, the clip and the D 1500 / 2048
     cases again with the removed bitmap and the path forced into the
     global scratch (the layout of clips too long for shared memory), a
     3,100-frame clip at D 512 whose bitmap does not fit in shared memory
     (a kernel that kept it there refused such a clip) against its plain
     version, detect_clip's
     tracks against the plain correlation, the fused tracker head against
     the materialized one (roipool_fwd on the 1891-channel features) on a
     chunk in bf16 and in f32, and the call's device time by stage.
  10. train: full-width joint training steps (the same configuration, the
     package's seeded init, synthetic frame pairs at INPUT_SHAPE): one
     warm-up step, then
     timed steps with the launch counters reset before and read after (a
     step: 3 K1, 2 + 2 correlation backward, 1 NMS, 2 + 2 PSROIPool and 1
     + 1 fused ROIPool launches); finite losses, frozen stages bitwise
     unchanged, the track loss's
     gradients with respect to c4 and c5 held against the plain
     correlation, and one step's device time by stage.
  11. trainer: the training entry point at full width (cfg/default.yaml with
     DATA_ROOT a fixture ILSVRC tree from tools/make_fixture_tree.py,
     TRN_SIZE 16, VAL_SIZE 8, REP_SIZE 2): `train.main` for 16 pairs (one
     epoch of 4 steps, validation, report overlays, checkpoints) with the
     kernel counters reset before and read after, a `--resume` to 24 pairs
     that must restore the saved weights and momentum bitwise, then
     `evaluate.main --all-ckpts` over the rotated checkpoints.
  12. ddp: data parallelism on the one card, a check of correctness and not
     of scaling: make_parallel_train_step (DistributedDataParallel) at world
     size 1 over NCCL against make_train_step, then two ranks (child
     processes of this script, `--ddp-rank`) sharing the card over gloo: a
     2-pair-per-rank step against the single-process 4-pair step,
     make_parallel_detect against Detector.detect_pairs, and train.main with
     NUM_DEVICES 2 for one epoch (ranks bitwise equal, rank 0 alone writes).
  13. options: HOST_S2D's Detector against the plain stem, a REMAT step
     against the plain step, sat against einsum pooling (the PSROIPool
     kernels on the card) at the R-FCN head's shapes, and checked_loss_fn
     naming a poisoned loss component.
The kernels phase also holds the backward kernels (corr_bwd_fm0,
corr_bwd_fm1) against autograd through the plain version; the linker
kernel is held in the clip phase. The script prints
its total time, then the card's name and power limit, then the kernels
JSON, and last the device JSON. Any failed check raises, so the script
exits non-zero.

`python3 chip_smoke.py --linker` runs the device and build phases and then
the linker kernel alone (a clip-like 22-frame problem at D 128 against its
plain version, then the clip phase's linking-only cases): a quick check of
a linker change, not the smoke test. `python3 chip_smoke.py --nms` runs
the device and build phases and then the NMS kernel alone, held against
its plain loop and timed at 8 x 3072 (clustered random boxes and the
default anchors moved by random offsets) and 2 x 4096, its IoU launch's
words held as in the nms phase and timed against its own bound, with the
IoU kernel's SASS instructions an IoU. `python3 chip_smoke.py --psroi` runs
the device and build phases and then the psroi phase alone, and
`python3 chip_smoke.py --roipool` the roipool phase alone.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
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
        rows = sum(live(i, r) for i in range(h) for r in range(2 * d))
        if d <= 19:  # one block for all displacements
            nt = -(-(15 + 2 * d) // 8)
            return b * tiles * (rows * (16 + 8 * nt) + h * 32) * c * 2
        # 16 x 16 displacement tiles (NT = 4): each row in each column band
        n = -(-2 * d // 16)
        return b * tiles * (n * rows * 48 + n * n * h * 32) * c * 2
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


def _wide_cases():
    """wide windows in both dtypes on a small map: d_max 20, 24, 32."""
    import torch

    return [(20, 45, 256, d, 1, dt) for d in (20, 24, 32) for dt in (torch.bfloat16, torch.float32)]


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
    cases += _odd_cases(torch.bfloat16) + _wide_cases()
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
    cases += _odd_cases(torch.bfloat16) + _wide_cases()
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


def slice_model(cfg, device="cuda"):
    """the slice phase's model: reference-keyed random weights (seed 0) with
    the box-regression heads at trained-net magnitudes (x 0.002), so decodes
    stay inside the clamp (as the JAX package's pipeline parity test does)."""
    from detect_to_track_tpu_torch.models import DetectTrackModule
    from detect_to_track_tpu_torch.models.convert import load_reference_state_dict, random_reference_state_dict

    sd = random_reference_state_dict(cfg, seed=0)
    for k in ("rpn.reg_fc.weight", "rpn.reg_fc.bias", "rcnn.reg_head.sm_conv.weight", "rcnn.reg_head.sm_conv.bias"):
        sd[k] = sd[k] * 0.002
    model = DetectTrackModule.from_config(cfg, device=device)
    model.load_state_dict(load_reference_state_dict(sd))
    return model


def slice_pairs(cfg):
    """BATCH_SIZE seed-0 uint8 noise pairs at INPUT_SHAPE."""
    import numpy as np

    h, w = cfg.INPUT_SHAPE
    return np.random.default_rng(0).integers(0, 256, (cfg.BATCH_SIZE, 2, h, w, 3), dtype=np.uint8)


def phase_slice(smi: str):
    """the full-width main path: Detector.__call__ on single pairs and
    Detector.detect_pairs on BATCH_SIZE pairs, kernel counters read around
    it; then the same batch with the plain correlation, for the tracks."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.inference import Detector
    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    t0 = time.perf_counter()
    model = slice_model(cfg)
    det = Detector(model, cfg)
    h, w = cfg.INPUT_SHAPE
    p = cfg.BATCH_SIZE
    pairs = slice_pairs(cfg)
    n_params = sum(t.numel() for t in model.state_dict().values())
    log(f"[slice] {cfg.BACKBONE_ARCH} {h}x{w} fm {cfg.fm_shape} anchors {cfg.n_anchors} "
        f"pre-NMS {cfg.pre_nms_cap_eval}/{cfg.pre_nms_topk_eval} MAX_ROIS {cfg.MAX_ROIS} MAX_DETS {cfg.MAX_DETS} "
        f"d_max {cfg.D_MAX} k {cfg.K} {cfg.COMPUTE_DTYPE}; {n_params} weights from seed 0 "
        f"(set-up {time.perf_counter() - t0:.1f} s)")

    def launched(fn):
        before = _read_counts()
        out = fn()
        torch.cuda.synchronize()
        delta = {k: v - before[k] for k, v in _read_counts().items()}
        if delta != _launches(3, 0, 0, 1, 2, 0):
            raise AssertionError(f"expected 3 correlation, 1 NMS, 2 PSROIPool and 1 fused ROIPool forward kernel "
                                 f"launches per batched call, got {delta}")
        return out

    # ---- the main path: counters from 0, read right after ----
    _zero_counts()
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
    launches = _read_counts()
    if launches != _launches(3 * n_calls, 0, 0, n_calls, 2 * n_calls, 0):
        raise AssertionError(f"kernel launches {launches} in {n_calls} batched calls")
    check_map_layouts("[slice] detect_pairs", lambda: det.detect_pairs(pairs))

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
    log(f"[slice] kernel launches on the main path: {launches} in {n_calls} batched calls")
    rois = out.boxes[:, 0].reshape(-1, 4)
    large = (rois[:, 2] > 1) | (rois[:, 3] > 1)
    log(f"[slice] the tracker's rois (frame-0 boxes, valid or not): {int(large.sum())} of {len(rois)} taller or "
        f"wider than the frame (largest h {rois[:, 2].max().item():.3g}, w {rois[:, 3].max().item():.3g}): ROIPool's "
        f"corner clamp fills their bin (0, 0) with up to the whole map")

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
    with einsum_roi_pool_linear():
        phase_profile(f"detect_pairs x{len(pairs)}, roi_pool_linear as its einsum form", lambda: det.detect_pairs(pairs),
                      top=0)
    return launches, det


# float32 operations per IoU compare in nms.cu (2 min, 2 max, 2 subtractions,
# 2 clamps, the intersection, the union's add and subtraction, its sign test,
# the division and the threshold compare)
NMS_IOU_FLOPS = 14
# the largest k of the nms phase: the plain loop's IoUs and their
# intermediates are a few (k, k) float32 tensors, 1 GiB each at 16,384
NMS_LARGEST_K = 16384


def nms_bound_ms(boxes, valid, keep, iou):
    """least time for one greedy NMS call on these inputs: the IoU compares
    this data needs (each kept slot, in order, against every later slot
    still standing, as a sequential greedy NMS does) at the card's float32
    rate, against the boxes and the valid mask read once and the keep-mask
    written once. Returns (ms, "bytes" | "operations", compares)."""
    import numpy as np

    from detect_to_track_tpu_torch.boxes import compute_ious

    over = (compute_ious(boxes, boxes) > iou).cpu().numpy()
    standing_all, kept = valid.cpu().numpy().copy(), keep.cpu().numpy()
    compares = 0
    for f in range(over.shape[0]):
        standing = standing_all[f]
        for i in np.flatnonzero(kept[f]):
            compares += int(standing[i + 1 :].sum())
            standing[i + 1 :] &= ~over[f, i, i + 1 :]
    t_ops = NMS_IOU_FLOPS * compares / F32_FLOPS * 1e3
    t_bytes = (boxes.numel() * 4 + valid.numel() + keep.numel()) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations"), compares


def nms_iou_bound_ms(b, k):
    """least time for the NMS op's first launch alone (the IoU bits) on b
    frames of k boxes: its IoUs above the diagonal, NMS_IOU_FLOPS each at
    the card's float32 rate, against the boxes read once and the words at or
    above the diagonal written once. Returns (ms, "bytes" | "operations",
    IoUs)."""
    nw = -(-k // 64)
    ious = b * k * (k - 1) // 2
    words = b * sum(nw - i // 64 for i in range(k))
    t_ops = NMS_IOU_FLOPS * ious / F32_FLOPS * 1e3
    t_bytes = (b * k * 16 + words * 8) / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops else "operations"), ious


# boxes (ijhw) that the IoU-bit checks mix into a frame: NaN and +-inf in
# each field, inf - inf corners, subnormal, zero, negative and huge sizes
NMS_SPECIAL_BOXES = [
    [float("nan"), 0.5, 0.2, 0.3], [0.5, float("nan"), 0.2, 0.3], [0.5, 0.5, float("nan"), 0.3],
    [0.5, 0.5, 0.2, float("nan")], [float("inf"), 0.5, 0.2, 0.3], [0.5, -float("inf"), 0.2, 0.3],
    [0.5, 0.5, float("inf"), 0.3], [0.5, 0.5, 0.2, float("inf")], [float("inf"), 0.5, float("inf"), 0.3],
    [0.5, 0.5, 1e-40, 1e-40], [1e-39, 2e-39, 3e-39, 4e-39], [0.5, 0.5, 0.0, 0.0], [0.5, 0.5, -0.2, 0.3],
    [0.5, 0.5, -0.2, -0.3], [0.5, 0.5, 1e30, 1e30], [3e38, 3e38, 3e38, 3e38],
]


def with_special_boxes(boxes):
    """a copy of (B, k, 4) boxes with NMS_SPECIAL_BOXES in every 97th slot
    of each frame (from slot 5 on)."""
    import torch

    out = boxes.clone()
    special = torch.tensor(NMS_SPECIAL_BOXES, dtype=torch.float32, device=boxes.device)
    slots = torch.arange(5, boxes.shape[1], 97, device=boxes.device)
    out[:, slots] = special[torch.arange(len(slots), device=boxes.device) % len(special)]
    return out


def nms_iou_bits_check(boxes, thresholds) -> int:
    """the NMS op's first launch alone (nms_iou_bits_cuda) into a poisoned
    scratch, at each threshold: its words at or above the diagonal bitwise
    the plain nms_iou_bits_ref's (compute_ious > t, packed), the words below
    it still poisoned (not written). Returns the words compared."""
    import torch

    from detect_to_track_tpu_torch.ops.nms import nms_iou_bits_cuda, nms_iou_bits_ref

    b, k = boxes.shape[:2]
    nw = -(-k // 64)
    poison = 0x5A5A5A5A5A5A5A5A
    upper = torch.arange(nw, device=boxes.device)[None] >= (torch.arange(k, device=boxes.device) // 64)[:, None]
    for t in thresholds:
        out = torch.full((b, k, nw), poison, dtype=torch.int64, device=boxes.device)
        nms_iou_bits_cuda(boxes, t, out)
        ref = nms_iou_bits_ref(boxes, t)
        torch.cuda.synchronize()
        if not torch.equal(out[:, upper], ref[:, upper]):
            raise AssertionError(f"the IoU launch's words differ from compute_ious > {t!r} at {b} x {k}: "
                                 f"{int((out[:, upper] != ref[:, upper]).sum())} words")
        if not bool((out[:, ~upper] == poison).all()):
            raise AssertionError(f"the IoU launch wrote words below the diagonal at {b} x {k}, t = {t!r}")
    return len(thresholds) * b * int(upper.sum())


def thresholds_at_ious(boxes, iou):
    """iou, and float32 IoUs that compute_ious gives pairs above the
    diagonal of frame 0 (quantiles 0.1, 0.5, 0.9 of the positive ones) with
    the float32 step below each."""
    import torch

    from detect_to_track_tpu_torch.boxes import compute_ious

    ious = compute_ious(boxes[0], boxes[0])
    pos = ious[torch.ones_like(ious, dtype=torch.bool).triu(1) & (ious > 0)]
    vals = torch.quantile(pos.double().cpu(), torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64),
                          interpolation="nearest").float()
    below = torch.nextafter(vals, torch.zeros_like(vals))
    return [iou] + [float(x) for pair in zip(vals, below) for x in pair]


def _nms_boxes(seed, b, k, n_valid, per_center=12):
    """(b, k, 4) clustered random ijhw boxes on the card (long suppression
    chains; about per_center boxes a cluster), the first n_valid slots of
    each frame valid."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    centers = rng.random((max(k // per_center, 1), 2))
    ij = centers[rng.integers(0, len(centers), (b, k))] + rng.standard_normal((b, k, 2)) * 0.03
    boxes = np.concatenate([ij, rng.random((b, k, 2)) * 0.2 + 0.02], -1).astype(np.float32)
    valid = np.arange(k)[None].repeat(b, 0) < n_valid
    return torch.from_numpy(boxes).cuda(), torch.from_numpy(valid).cuda()


def nms_launch_ms(fn) -> dict:
    """ms per launch of each of the NMS op's two kernels over 5 calls of fn
    (profiler): {"nms_mask_kernel": ms, "nms_sweep_kernel": ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    return {_kernel_short(e.key): getattr(e, "self_device_time_total", 0.0) / e.count / 1e3
            for e in prof.key_averages() if "nms_" in e.key}


def nms_iou_launch_ms(boxes, iou):
    """the NMS op's first launch alone (nms_iou_bits_cuda into one scratch),
    ms per launch by CUDA events, with its own bound: (ms, bound_ms,
    bound_by, IoUs)."""
    import torch

    from detect_to_track_tpu_torch.ops.nms import nms_iou_bits_cuda

    b, k = boxes.shape[:2]
    out = torch.empty((b, k, -(-k // 64)), dtype=torch.int64, device=boxes.device)
    ms = cuda_time_ms(lambda: nms_iou_bits_cuda(boxes, iou, out))
    return (ms, *nms_iou_bound_ms(b, k))


def phase_nms(smi: str, det):
    """the NMS kernel (ops/csrc/nms.cu) against the plain fixed-point loop
    (nms_mask_ref) on the card, keep-masks bitwise: at the working point (2
    x BATCH_SIZE frames x pre_nms_topk_eval slots, pre_nms_cap_eval of them
    eligible) on the slice phase's decoded RPN boxes (score-descending, as
    the proposal filter gives them) and on clustered random boxes, at IoU
    EVAL_NMS_IOU_THRESH and TRAIN_NMS_IOU_THRESH; at k = 1, 63, 64, 65 and
    1000; at k 4096 (2 frames, all valid, dense clusters: kept slots whose
    rows reach across many words) and at k NMS_LARGEST_K (1 frame, the
    largest k whose k x k IoU tensor the plain loop holds comfortably on
    the card); against nms_np on one frame. Runs after the slice phase, whose
    model gives the RPN boxes; outside the main-path counts. Times the
    kernel (CUDA events), its two launches (profiler) and the plain loop
    (host reads included). Returns the kernels line's row."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch.encoding import frcnn_box_decode
    from detect_to_track_tpu_torch.ops.nms import nms_mask_cuda, nms_mask_ref, nms_np, top_k_proposals

    cfg = det.cfg
    k, cap = cfg.pre_nms_topk_eval, cfg.pre_nms_cap_eval
    x = torch.from_numpy(slice_pairs(cfg)).cuda()
    x = x.reshape(-1, *x.shape[2:])
    with torch.inference_mode():
        fmaps = det.model.backbone(x.float() / 255.0)
        o_hat, b_hat, _ = det.model.rpn(fmaps["c4"])
        props = top_k_proposals(o_hat[:, :, 1], frcnn_box_decode(det.anchors[None], b_hat),
                                cfg.EVAL_ROI_CONF_THRESH, k)
    rpn = (props.boxes.contiguous(), props.valid & (torch.arange(k, device="cuda") < cap))
    inputs = {"decoded RPN": rpn, "random": _nms_boxes(0, x.shape[0], k, cap)}
    ious = (cfg.EVAL_NMS_IOU_THRESH, cfg.TRAIN_NMS_IOU_THRESH)
    row = None
    for name, (boxes, valid) in inputs.items():
        words = sum(nms_iou_bits_check(bx, thresholds_at_ious(boxes, iou)) for bx in (boxes, with_special_boxes(boxes))
                    for iou in ious)
        log(f"[nms] {name} boxes {tuple(boxes.shape[:2])}: the IoU launch's words bitwise compute_ious > t at or "
            f"above the diagonal, poison below ({words} words; t = {', '.join(map(str, ious))}, IoUs at 0.1 / 0.5 "
            f"/ 0.9 and a float32 step below; also with NaN, inf, subnormal and negative boxes mixed in)")
        for iou in ious:
            got = nms_mask_cuda(boxes, valid, iou)
            ref = nms_mask_ref(boxes, valid, iou)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"the NMS kernel's keep-mask differs from the plain loop's on {name} boxes at "
                                     f"IoU {iou}: {int((got != ref).sum())} slots")
            ms = cuda_time_ms(lambda: nms_mask_cuda(boxes, valid, iou))
            plain_ms = cuda_time_ms(lambda: nms_mask_ref(boxes, valid, iou), iters=3, warmup=1)
            bound, by, compares = nms_bound_ms(boxes, valid, got, iou)
            split = nms_launch_ms(lambda: nms_mask_cuda(boxes, valid, iou))
            iou_ms, iou_bound, iou_by, n_ious = nms_iou_launch_ms(boxes, iou)
            log(f"[nms] {name} boxes {tuple(boxes.shape[:2])}, {int(valid.sum())} eligible, IoU {iou}: kernel = plain "
                f"loop (bitwise), {int(got.sum())} kept; ms={ms:.4f} (per launch: "
                f"{', '.join(f'{n} {t:.4f}' for n, t in split.items())}) plain_ms={plain_ms:.3f} "
                f"bound_ms={bound:.6f} ({by}: {compares} IoU compares); the IoU launch alone {iou_ms:.4f} ms against "
                f"its own bound {iou_bound:.6f} ({iou_by}: {n_ious} IoUs above the diagonal), "
                f"{iou_ms / iou_bound:.1f}x; card: {smi}")
            if row is None:  # the serving path's case: decoded RPN boxes at the eval IoU
                row = dict(err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    for kk in (1, 63, 64, 65, 1000):
        boxes, valid = _nms_boxes(kk, 3, kk, kk - kk // 10)
        for iou in ious:
            if not torch.equal(nms_mask_cuda(boxes, valid, iou), nms_mask_ref(boxes, valid, iou)):
                raise AssertionError(f"the NMS kernel differs from the plain loop at k = {kk}, IoU {iou}")
    # long kept chains across words, and the largest k of the plain loop
    for b, kk, per_center in ((2, 4096, 64), (1, NMS_LARGEST_K, 12)):
        boxes, valid = _nms_boxes(kk, b, kk, kk, per_center)
        for iou in ious:
            got = nms_mask_cuda(boxes, valid, iou)
            ref = nms_mask_ref(boxes, valid, iou)
            if not torch.equal(got, ref):
                raise AssertionError(f"the NMS kernel differs from the plain loop at {b} x {kk}, IoU {iou}: "
                                     f"{int((got != ref).sum())} slots")
            ms = cuda_time_ms(lambda: nms_mask_cuda(boxes, valid, iou), iters=5, warmup=1)
            nz = torch.nonzero(got)
            words = len(torch.unique(nz[:, 0] * kk + nz[:, 1] // 64))
            log(f"[nms] {b} x {kk} clustered boxes ({per_center} a cluster), all valid, IoU {iou}: kernel = plain loop "
                f"(bitwise), {len(nz)} kept, in {words} of the {b * -(-kk // 64)} mask words; ms={ms:.4f}")
        del boxes, valid, got, ref
        torch.cuda.empty_cache()
    boxes, valid = rpn[0][0], rpn[1][0]
    idx = torch.nonzero(valid).flatten().cpu().numpy()
    scores = np.linspace(1.0, 0.0, len(idx), dtype=np.float32)
    kept = idx[nms_np(scores, boxes.cpu().numpy()[idx], ious[0])]
    got = torch.nonzero(nms_mask_cuda(boxes, valid, ious[0])).flatten().cpu().numpy()
    if not np.array_equal(got, kept):
        raise AssertionError("the NMS kernel differs from nms_np on the first frame's RPN boxes")
    log(f"[nms] k = 1, 63, 64, 65, 1000 (3 frames each) at IoU {ious}: kernel = plain loop (bitwise); frame 0's RPN "
        f"boxes: kernel = nms_np ({len(kept)} kept)")
    return row


def phase_export(smi: str, det):
    """the serving export at full width: export_detector on the slice
    phase's model at pair_batch BATCH_SIZE (into a temporary directory under
    build/, deleted after the load), then load_detector serving the slice
    phase's uint8 pairs, with the kernel counters reset before and read
    after each served call (3 corr_fwd, 1 nms_mask, 2 psroi_fwd); its four outputs
    held bitwise against Detector.detect_pairs on the same pairs, and its
    pairs/s beside the live call's. The same for the HOST_S2D program
    (space_to_depth2 frames) against the HOST_S2D Detector. Returns the
    launches of the served calls."""
    import shutil
    import tempfile

    import torch

    from detect_to_track_tpu_torch.export import export_detector, load_detector
    from detect_to_track_tpu_torch.inference import Detector
    from detect_to_track_tpu_torch.utils import space_to_depth2

    pairs = slice_pairs(det.cfg)
    p = len(pairs)
    total = {name: 0 for name in _counters()}
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_export_", dir=ROOT / "build"))
    try:
        for variant in ("plain", "HOST_S2D"):
            cfg = det.cfg.replace(HOST_S2D=variant == "HOST_S2D")
            live = det if variant == "plain" else Detector(det.model, cfg)
            x = pairs if variant == "plain" else space_to_depth2(pairs)
            path = work / f"detector_{variant}.pt2"
            t = time.perf_counter()
            export_detector(det.model, cfg, str(path), pair_batch=p)
            export_s = time.perf_counter() - t
            nbytes = path.stat().st_size
            t = time.perf_counter()
            serve = load_detector(str(path))
            load_s = time.perf_counter() - t
            path.unlink()
            serve(x)  # warm-up
            torch.cuda.synchronize()

            # ---- the main path: counters from 0, read right after ----
            _zero_counts()
            got = serve(x)
            torch.cuda.synchronize()
            launches = _read_counts()
            for key, v in launches.items():
                total[key] += v
            if launches != _launches(3, 0, 0, 1, 2, 0):
                raise AssertionError(f"the served {variant} call launched {launches}, expected 3 corr_fwd, 1 "
                                     "nms_mask, 2 psroi_fwd")

            ref = live.detect_pairs(pairs)
            diffs = {f: (a.float() - b.float()).abs().max().item() for f, a, b in zip(ref._fields, got, ref)}
            same = all(torch.equal(a, b) for a, b in zip(got, ref))
            log(f"[export] {variant}: input {tuple(x.shape)} {x.dtype}; export {export_s:.1f} s, program "
                f"{nbytes} bytes, load {load_s:.1f} s; served call launches {launches}; outputs vs "
                f"Detector.detect_pairs: {'bitwise equal' if same else f'DIFFERENT, largest differences {diffs}'}; "
                f"valid per frame {got[2].sum(-1).tolist()}")
            if not same:
                raise AssertionError(f"the served {variant} program differs from Detector.detect_pairs: {diffs}")
            # timed on the same input: the HOST_S2D Detector takes the packed
            # frames as they are, so its host packing is outside both times
            served_s, live_s = [], []
            for _ in range(3):  # in turns: served, live
                for fn, out in ((lambda: serve(x), served_s), (lambda: live.detect_pairs(x), live_s)):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    out.append(time.perf_counter() - t)
            log(f"[export] {variant}: served {p / min(served_s):.2f} pairs/s ({[round(s * 1e3, 1) for s in served_s]} "
                f"ms per {p}-pair call), live detect_pairs {p / min(live_s):.2f} pairs/s "
                f"({[round(s * 1e3, 1) for s in live_s]} ms); card: {smi}")
            del serve, live
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return total


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


def linker_stream(dp_steps, d, ms):
    """the bytes of the score matrices the linker's DP steps read (one D x D
    f32 matrix a step) and that rate at `ms` per call."""
    nbytes = dp_steps * d * d * 4
    return f"dp_bytes={nbytes} dp_rate={nbytes / (ms * 1e-3) / 1e9:.1f} GB/s"


def checked_linker(seq, init):
    """one linker launch outside the main-path count, with the check that
    the kernel left the caller's score matrices and init scores as they
    were (it reads them in place)."""
    import torch

    from detect_to_track_tpu_torch import viterbi_device as vd

    seq_before, init_before = seq.clone(), init.clone()
    got = vd.viterbi_multi_link_cuda(seq, init)
    torch.cuda.synchronize()
    if not (torch.equal(seq.view(torch.int32), seq_before.view(torch.int32))
            and torch.equal(init.view(torch.int32), init_before.view(torch.int32))):
        raise AssertionError("the linker kernel changed its input score matrices")
    return got


def global_bitmap_linker(seq, init, iters):
    """the linker kernel with its removed-node bitmap and path forced into
    the global scratch (the layout of clips too long for shared memory, as
    the size rule gives it past about 1,037 frames at D 1500), the step
    tables where the size rule puts them; outside the main-path count.
    Returns its paths (input checked unchanged) and its ms per call."""
    from detect_to_track_tpu_torch import viterbi_device as vd

    in_smem = vd._bitmap_in_smem
    vd._bitmap_in_smem = lambda lib, t1, d: False
    try:
        got = checked_linker(seq, init)
        ms = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(seq, init), iters=iters, warmup=1)
    finally:
        vd._bitmap_in_smem = in_smem
    return got, ms


def _same_paths(got, ref):
    import torch

    return (int(got.n_paths) == int(ref.n_paths) and torch.equal(got.spans, ref.spans)
            and torch.equal(got.nodes, ref.nodes) and torch.equal(got.scores.view(torch.int32), ref.scores.view(torch.int32)))


def _trimmed(paths):
    """DevicePaths -> [((start, end), score, nodes)] as the host linkers give them."""
    n = int(paths.n_paths)
    spans, scores, nodes = (x[:n].cpu().numpy() for x in (paths.spans, paths.scores, paths.nodes))
    return [((int(s), int(e)), float(sc), nd[s : e + 1].tolist()) for (s, e), sc, nd in zip(spans, scores, nodes)]


def linker_cases(d):
    """the linker kernel on linking-only cases, outside the main-path count:
    64 frames at D d against the native linker, 3 frames at D 1500 and
    2048 (several slots per thread) against its plain version, the latter
    also with the bitmap forced into the global scratch, and a clip past
    the shared-memory bitmap (linker_past_shared_bitmap); each with its time
    and the DP's streamed bytes."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch import viterbi_device as vd
    from detect_to_track_tpu_torch.viterbi import viterbi_multi_link

    # the linking-only case: 64 frames against the native linker
    seq64, init64 = link_problem(0, 64, d)
    s64, i64 = torch.from_numpy(seq64).cuda(), torch.from_numpy(init64).cuda()
    got64 = _trimmed(checked_linker(s64, i64))
    t = time.perf_counter()
    nat64 = viterbi_multi_link(list(seq64), list(init64), use_native=True)
    native64_ms = (time.perf_counter() - t) * 1e3
    if got64 != nat64:
        raise AssertionError("the linker kernel disagrees with the native linker at T = 64")
    ms64 = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(s64, i64), iters=5, warmup=1)
    steps64, full64 = linker_dp_steps([p[0] for p in got64])
    bound64, by64 = linker_bound_ms(seq64.shape[0], d, steps64)
    log(f"[clip] linker {seq64.shape[0]}x{d}x{d} (dyadic scores, {100 * float(np.isinf(seq64).mean()):.1f}% -inf): "
        f"kernel = native linker (spans, nodes, scores), input unchanged; {len(got64)} paths "
        f"({sum(e > 0 for (_, e), _, _ in got64)} extractions), {steps64} DP steps run ({full64} from step 0); "
        f"ms={ms64:.4f} {linker_stream(steps64, d, ms64)} native_ms={native64_ms:.2f} "
        f"bound_ms={bound64:.6f} ({by64})")

    # several slots per thread: D 1500 and 2048 on a short dyadic clip
    for d_big in (1500, 2048):
        seq_b, init_b = (torch.from_numpy(x).cuda() for x in link_problem(d_big, 3, d_big))
        got_b = checked_linker(seq_b, init_b)
        t = time.perf_counter()
        ref_b = vd.viterbi_multi_link_ref(seq_b, init_b)
        torch.cuda.synchronize()
        plain_b = (time.perf_counter() - t) * 1e3
        if not _same_paths(got_b, ref_b):
            raise AssertionError(f"the linker kernel disagrees with its plain version at D = {d_big}")
        ms_b = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(seq_b, init_b), iters=3, warmup=1)
        glob_b, glob_ms = global_bitmap_linker(seq_b, init_b, iters=3)
        if not _same_paths(glob_b, ref_b):
            raise AssertionError(f"the linker kernel with a global bitmap disagrees with its plain version at D = {d_big}")
        steps_b, _ = linker_dp_steps([p[0] for p in _trimmed(got_b)])
        log(f"[clip] linker 2x{d_big}x{d_big} (dyadic scores, {-(-d_big // 1024)} slots per thread at most): "
            f"kernel = plain version (n_paths {int(got_b.n_paths)}, spans, nodes, bitwise scores), input unchanged, "
            f"bitmap in shared memory and in the global scratch; {steps_b} DP steps run; ms={ms_b:.4f} "
            f"{linker_stream(steps_b, d_big, ms_b)} global-bitmap ms={glob_ms:.4f} plain_ms={plain_b:.1f}")
        del seq_b, init_b, got_b, ref_b, glob_b
    torch.cuda.empty_cache()
    linker_past_shared_bitmap()


def phase_clip(smi: str, det):
    """the clip path: ClipTracker(det, frame_chunk=CLIP_CHUNK, min_len=2) on
    CLIP_FRAMES frames, one warm-up call, then two timed calls with the
    kernel counters reset before and read after (3 K1, 1 NMS and 2 PSROIPool
    forward launches per chunk, 1 linker launch per clip). Then, outside the count: a valid detection in
    every frame, device- against host-linked tubelets, the linker kernel
    against its plain version on the clip's score matrices and against the
    native linker on a 64-frame linking-only case, detect_clip's tracks
    against the plain correlation, and a profiled call. Returns the
    launches and the linker row of the kernels line."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch import viterbi_device as vd
    from detect_to_track_tpu_torch.clip import ClipTracker
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
    def counts():
        return {**_read_counts(), "viterbi_multi_link": vd.viterbi_multi_link_cuda.launches}

    _zero_counts()
    vd.viterbi_multi_link_cuda.launches = 0
    per_call = {**_launches(3 * len(starts), 0, 0, len(starts), 2 * len(starts), 0), "viterbi_multi_link": 1}
    clip_s = []
    for r in range(2):
        before = counts()
        t = time.perf_counter()
        tubes = tracker(frames)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t)
        delta = {k: v - before[k] for k, v in counts().items()}
        if delta != per_call:
            raise AssertionError(f"clip call {r}: launches {delta}, expected {per_call}")
        log(f"[clip] call {r}: {clip_s[-1] * 1e3:.1f} ms, {len(tubes)} tubelets, host upload time {tracker.last_upload_s * 1e3:.1f} ms")
    launches = counts()
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

    got = checked_linker(seq, init)
    t = time.perf_counter()
    ref = vd.viterbi_multi_link_ref(seq, init)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if not _same_paths(got, ref):
        raise AssertionError("the linker kernel disagrees with its plain version on the clip's score matrices")
    ms = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(seq, init), iters=10, warmup=2)
    glob, glob_ms = global_bitmap_linker(seq, init, iters=10)
    if not _same_paths(glob, ref):
        raise AssertionError("the linker kernel with a global bitmap disagrees with its plain version on the clip")
    seq_host, init_host = list(seq.double().cpu().numpy()), init.double().cpu().tolist()
    t = time.perf_counter()
    viterbi_multi_link(seq_host, init_host, use_native=True)
    native_ms = (time.perf_counter() - t) * 1e3
    paths = _trimmed(got)
    steps, full = linker_dp_steps([p[0] for p in paths])
    bound, by = linker_bound_ms(n - 1, cfg.max_dets, steps)
    log(f"[clip] linker {n - 1}x{cfg.max_dets}x{cfg.max_dets}: kernel = plain version (n_paths, spans, nodes, "
        f"bitwise scores), input unchanged; {len(paths)} paths ({sum(e > 0 for (_, e), _, _ in paths)} extractions), "
        f"{steps} DP steps run ({full} from step 0); ms={ms:.4f} {linker_stream(steps, cfg.max_dets, ms)} "
        f"global-bitmap ms={glob_ms:.4f} (= plain version, bitwise) "
        f"plain_ms={plain_ms:.1f} native_ms={native_ms:.2f} bound_ms={bound:.6f} "
        f"({by}: the score matrices read once, outputs written once, an add and a compare per entry per DP step)")

    linker_cases(cfg.max_dets)

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

    fused_vs_materialized(det, np.stack(frames[:chunk]), outs[0])

    phase_profile(f"ClipTracker {n} frames, chunk {chunk}", lambda: tracker(frames))
    with einsum_roi_pool_linear():
        phase_profile(f"ClipTracker {n} frames, chunk {chunk}, roi_pool_linear as its einsum form",
                      lambda: tracker(frames), top=0)
    row = dict(launches=launches["viterbi_multi_link"], err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    return launches, row


def fused_vs_materialized(det, frames, fused):
    """the tracker's fused head against the materialized one (its oracle:
    the concatenated features ROI-pooled by roipool_fwd_kernel, flattened
    in (C, k, k) order, one Linear) at full width, on one detect_clip
    chunk: in the compute dtype against `fused` (that chunk's main-path
    output), then both heads in f32. The detections are the same; the
    transforms within 1e-2 of the largest magnitude in bf16 (the heads
    round to bf16 at different points: the fused one the maps and volumes
    before the projection, the materialized one the pooled features; 2^-8
    of each of the 92,659 products a transform) and 1e-4 in f32 (the sums
    in another order). The materialized head launches one roipool_fwd a
    call and no fused-head kernel. Outside the main-path launch count."""
    import torch

    from detect_to_track_tpu_torch.ops import pooling

    tracker = det.model.c_tracker
    compute_dtype = tracker.dtype
    results = {}
    try:
        for dtype in (compute_dtype, torch.float32):
            tracker.dtype = dtype
            for fused_head in (True, False):
                if fused_head and dtype == compute_dtype:
                    results[dtype, True] = fused
                    continue
                tracker.fused_head = fused_head
                before = (pooling.roipool_fwd_cuda.launches, pooling.roipool_linear_fwd_cuda.launches)
                results[dtype, fused_head] = det.detect_clip(frames)
                torch.cuda.synchronize()
                after = (pooling.roipool_fwd_cuda.launches, pooling.roipool_linear_fwd_cuda.launches)
                want = (0, 1) if fused_head else (1, 0)
                if (after[0] - before[0], after[1] - before[1]) != want:
                    raise AssertionError(f"the {'fused' if fused_head else 'materialized'} head launched "
                                         f"roipool_fwd / roipool_linear_fwd {after[0] - before[0]} / "
                                         f"{after[1] - before[1]} times, expected {want}")
    finally:
        tracker.dtype, tracker.fused_head = compute_dtype, True
    for dtype, tol_share in ((compute_dtype, 1e-2), (torch.float32, 1e-4)):
        a, m = results[dtype, True], results[dtype, False]
        if not torch.equal(a.valid, m.valid) or not torch.equal(a.boxes, m.boxes):
            raise AssertionError("the detections differ between the fused and the materialized tracker heads")
        v = m.valid[:-1]
        scale = m.tracks[v].abs().max().item()
        err = (a.tracks[v] - m.tracks[v]).abs().max().item()
        log(f"[clip] the fused tracker head vs the materialized one (roipool_fwd at {len(frames) - 1} pairs, "
            f"{tracker.fc_channels // tracker.r_hw ** 2} channels), {str(dtype).removeprefix('torch.')}: "
            f"max_abs_err={err:.3e} (tol {tol_share * scale:.3e}, max|ref| {scale:.3e}) over {int(v.sum())} "
            f"detections")
        if not (scale > 0 and err <= tol_share * scale):
            raise AssertionError(f"the fused tracker head disagrees with the materialized one in {dtype}")


def phase_train(smi: str, steps: int = 3):
    """the full-width training path: make_train_step on cfg/default.yaml
    (ResNet-50, 608x1200, bf16, BATCH_SIZE pairs, FIRST_TRAINABLE_STAGE 3)
    from the seeded init, synthetic pairs at INPUT_SHAPE packed as uint8. One
    warm-up step, then `steps` timed steps with the kernel counters reset
    before and read after: 3 corr_fwd, 2 corr_bwd_fm0, 2 corr_bwd_fm1, 1
    nms_mask, 2 psroi_fwd, 2 psroi_bwd, 1 roipool_linear_fwd and 1
    roipool_linear_bwd launches per step (c3 comes from frozen stages, so
    its correlation has no backward). Returns the counts."""
    import torch

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.config import load_config

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    p = cfg.BATCH_SIZE
    t0 = time.perf_counter()
    model = train_model(cfg)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model))
    batches = train_batches(cfg, steps + 1)
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
    _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(steps):
        start = _read_counts()
        t = time.perf_counter()
        dtl = step(batches[1 + i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        delta = {k: v - start[k] for k, v in _read_counts().items()}
        if delta != _launches(3, 2, 2, 1, 2, 2):
            raise AssertionError(f"step {i}: launches {delta}, expected 3 / 2 / 2 / 1 / 2 / 2")
        o, a, c, r, tr = checked(dtl, f"step {i}")
        log(f"[train] step {i}: {step_s[-1] * 1e3:.1f} ms, losses o {o:.4e} a {a:.4e} c {c:.4e} r {r:.4e} t {tr:.4e}")
    launches = _read_counts()
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
    check_map_layouts("[train] a training step", lambda: step(batches[1]))
    phase_profile(f"train step x{p}", lambda: step(batches[1]))
    with einsum_roi_pool_linear():
        phase_profile(f"train step x{p}, roi_pool_linear as its einsum form", lambda: step(batches[1]), top=0)
    return launches


def train_model(cfg, device="cuda"):
    """the train phase's model: the package's own seeded init (seed 0;
    lecun-normal, identity FrozenBatchNorm), as the JAX package starts
    training -- the reference-keyed random weights of the slice phase grow
    c5 to ~4e3 and the track loss to ~1e8, and the first lr 1e-2 update
    diverges -- with the box heads scaled by 0.002 as there."""
    import torch

    from detect_to_track_tpu_torch.models import DetectTrackModule

    model = DetectTrackModule.from_config(cfg, device=device, seed=0)
    with torch.no_grad():
        for head in (model.rpn.reg_fc, model.rcnn.reg_sm_conv):
            head.weight.mul_(0.002)
            head.bias.mul_(0.002)
    return model


def train_batches(cfg, n):
    """n synthetic batches of BATCH_SIZE pairs at INPUT_SHAPE (seed 0),
    packed as uint8 as PIL sources pack: the /255 runs on the card."""
    import numpy as np

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.data.synthetic import SyntheticVIDManager

    manager = SyntheticVIDManager(n_samples=cfg.BATCH_SIZE * n, image_hw=cfg.INPUT_SHAPE, n_classes=cfg.N_CLASSES)
    loader = trainer.BatchLoader(manager, cfg.BATCH_SIZE, cfg, seed=0)
    try:
        return [b._replace(images=np.rint(b.images * 255.0).astype(np.uint8)) for b in loader]
    finally:
        loader.close()


def phase_trainer(smi: str):
    """the training entry point at full width on a fixture ILSVRC tree:
    train.main for 16 pairs (4 steps, 2 validation batches, 2 report pairs)
    with the kernel counters reset before and read after (3 corr_fwd, 2
    corr_bwd_fm0, 2 corr_bwd_fm1, 1 nms_mask, 2 psroi_fwd, 2 psroi_bwd and
    1 + 1 roipool_linear_fwd / _bwd launches per step, 3 corr_fwd, 1
    nms_mask, 2 psroi_fwd and 1 roipool_linear_fwd per validation batch and
    per report pair), then a --resume to 24 pairs that
    must restore the saved weights and momentum bitwise, then evaluate.main
    --all-ckpts over the rotated checkpoints. Returns the counts."""
    import shutil

    import torch

    from detect_to_track_tpu_torch import evaluate, train
    from detect_to_track_tpu_torch.config import load_config, save_config
    from detect_to_track_tpu_torch.trainer import DetectTrackTrainer, TrainStep

    work = ROOT / "build" / "chip_smoke_trainer"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_fixture_tree.py"), str(work / "ILSVRC"),
                    "--snippets", "4", "--frames", "8", "--det", "4"], check=True, capture_output=True, text=True)
    cfg = load_config(str(ROOT / "cfg" / "default.yaml")).replace(
        DATA_ROOT=str(work / "ILSVRC"), TRN_SIZE=16, VAL_SIZE=8, REP_SIZE=2, OUTPUT_DIR=str(work / "output"),
        LOG_EVERY=4, CHECKPOINT_KEEP=2)
    yaml_path = work / "trainer.yaml"
    save_config(cfg, str(yaml_path))
    p = cfg.BATCH_SIZE
    steps, val_batches, rep_pairs = cfg.TRN_SIZE // p, cfg.VAL_SIZE // p, cfg.REP_SIZE
    log(f"[trainer] fixture ILSVRC tree (4 snippets x 8 frames, 4 DET stills, 1280x720 JPEGs) and config "
        f"written in {time.perf_counter() - t0:.1f} s; {cfg.BACKBONE_ARCH} {cfg.INPUT_SHAPE} x{p} pairs "
        f"{cfg.COMPUTE_DTYPE}, TRN_SIZE {cfg.TRN_SIZE}, VAL_SIZE {cfg.VAL_SIZE}, REP_SIZE {cfg.REP_SIZE}")

    # ---- the main path: counters from 0, read right after ----
    _zero_counts()
    # where the loop's wall time goes: each call of these methods, timed to
    # a device sync. The four trainer methods do not nest; the steps run
    # inside `train`, whose rest is waiting for batches (sampling, JPEG
    # decoding), the loss reads and the log (which `report` calls too). The
    # rest of the wall is set-up.
    calls = {name: [] for name in ("train", "validate", "report", "checkpoint", "step", "log")}
    targets = {name: (DetectTrackTrainer, name) for name in ("train", "validate", "report", "checkpoint")}
    targets["step"] = (TrainStep, "__call__")
    targets["log"] = (DetectTrackTrainer, "_default_logger")  # inside train and report
    originals = {name: getattr(cls, attr) for name, (cls, attr) in targets.items()}

    def timed(name, fn):
        def call(self, *args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                calls[name].append(time.perf_counter() - t)
        return call

    for name, (cls, attr) in targets.items():
        setattr(cls, attr, timed(name, originals[name]))
    try:
        t = time.perf_counter()
        trainer = train.main(["-c", str(yaml_path), "--max-iters", str(cfg.TRN_SIZE)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        for name, (cls, attr) in targets.items():
            setattr(cls, attr, originals[name])
    launches = _read_counts()
    forwards = steps + val_batches + rep_pairs  # one forward each
    expected = _launches(3 * forwards, 2 * steps, 2 * steps, forwards, 2 * forwards, 2 * steps)
    log(f"[trainer] train.main: {steps} steps, {val_batches} validation batches, {rep_pairs} report pairs in "
        f"{wall:.2f} s wall = {cfg.TRN_SIZE / wall:.2f} training pairs/s over the whole loop (JPEG decoding, "
        f"validation, report and checkpoints included); card: {smi}")
    sec = {name: sum(v) for name, v in calls.items()}
    log(f"[trainer] wall by part: train {sec['train']:.2f} s (the steps {sec['step']:.2f} s: "
        f"{[round(1e3 * x, 1) for x in calls['step']]} ms; waiting for batches and the rest "
        f"{sec['train'] - sec['step']:.2f} s; logging {sec['log']:.2f} s in all), validate {sec['validate']:.2f} s, report {sec['report']:.2f} s, "
        f"checkpoint {sec['checkpoint']:.2f} s ({len(calls['checkpoint'])} saves), set-up and the rest "
        f"{wall - sec['train'] - sec['validate'] - sec['report'] - sec['checkpoint']:.2f} s "
        "(model, data managers, trainer)")
    log(f"[trainer] kernel launches on the main path: {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"trainer launches {launches} != {expected}")
    if trainer.step_count != steps:
        raise AssertionError(f"{trainer.step_count} updates after {steps} steps")
    out = Path(cfg.OUTPUT_DIR)
    entries = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    if not entries or not all(math.isfinite(v) for e in entries for v in e.values()):
        raise AssertionError(f"metrics.jsonl has no entry or a non-finite value: {entries}")
    files = sorted(x.name for x in out.iterdir())
    log(f"[trainer] metrics.jsonl: {len(entries)} entries, all finite; output: {files}")
    for name in ("ckpt", "ckpt_final", f"ckpt_step_{steps:08d}", "report"):
        if name not in files:
            raise AssertionError(f"{name} missing from {files}")

    # ---- resume: the restored state equals the saved one before a new step ----
    saved = torch.load(out / "ckpt", map_location="cuda", weights_only=True)
    run = DetectTrackTrainer.run
    seen = {}

    def checked_run(self, max_iters):
        model_sd, opt_sd = self.model.state_dict(), self.optimizer.state_dict()
        same_w = all(torch.equal(model_sd[k], v) for k, v in saved["model"].items())
        same_m = all(torch.equal(opt_sd["state"][i]["momentum_buffer"], st["momentum_buffer"])
                     for i, st in saved["optimizer"]["state"].items())
        seen.update(weights=same_w, momentum=same_m, step=self.step_count, n_iters=self.n_iters,
                    n_momentum=len(saved["optimizer"]["state"]))
        return run(self, max_iters)

    DetectTrackTrainer.run = checked_run
    try:
        t = time.perf_counter()
        resumed = train.main(["-c", str(yaml_path), "--resume", "--max-iters", str(cfg.TRN_SIZE + 2 * p)])
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t
    finally:
        DetectTrackTrainer.run = run
    final = torch.load(out / "ckpt_final", map_location="cpu", weights_only=True)
    log(f"[trainer] resume: restored step {seen['step']}, n_iters {seen['n_iters']}; weights bitwise equal "
        f"{seen['weights']}, momentum ({seen['n_momentum']} buffers) bitwise equal {seen['momentum']}; "
        f"step counter {resumed.step_count} after the resume ({resume_s:.2f} s), ckpt_final at step {final['step']}")
    if not (seen["weights"] and seen["momentum"] and seen["step"] == steps and seen["n_iters"] == cfg.TRN_SIZE):
        raise AssertionError(f"the resume did not restore the saved state: {seen}")
    if resumed.step_count != steps + 2 or final["step"] != steps + 2:
        raise AssertionError(f"the step counter did not continue: {resumed.step_count}, {final['step']}")

    # ---- evaluate every rotated checkpoint ----
    t = time.perf_counter()
    results = evaluate.main(["-c", str(yaml_path), "--ckpt", str(out / "ckpt"), "--all-ckpts", "--n-samples", "8"])
    eval_s = time.perf_counter() - t
    rotated = sorted(x.name for x in out.glob("ckpt_step_*"))
    scored = [r["ckpt"] for r in results]
    log(f"[trainer] evaluate --all-ckpts ({eval_s:.2f} s): " + "; ".join(
        f"{r['ckpt']} step {r['step']} mAP {r['mAP']:.4f}" for r in results))
    if scored[: len(rotated)] != rotated or not all(0.0 <= r["mAP"] <= 1.0 for r in results):
        raise AssertionError(f"evaluate scored {scored}, rotated {rotated}; mAPs {[r['mAP'] for r in results]}")
    shutil.rmtree(work, ignore_errors=True)
    return launches

def _counters():
    from detect_to_track_tpu_torch.ops import correlation as corr
    from detect_to_track_tpu_torch.ops import pooling
    from detect_to_track_tpu_torch.ops.nms import nms_mask_cuda

    return {"corr_fwd": corr.corr_fwd_cuda, "corr_bwd_fm0": corr.corr_bwd_fm0_cuda,
            "corr_bwd_fm1": corr.corr_bwd_fm1_cuda, "nms_mask": nms_mask_cuda, "psroi_fwd": pooling.psroi_fwd_cuda,
            "psroi_bwd": pooling.psroi_bwd_cuda, "roipool_linear_fwd": pooling.roipool_linear_fwd_cuda,
            "roipool_linear_bwd": pooling.roipool_linear_bwd_cuda, "roipool_fwd": pooling.roipool_fwd_cuda,
            "roipool_bwd": pooling.roipool_bwd_cuda}


def _launches(corr_fwd, corr_bwd_fm0, corr_bwd_fm1, nms_mask, psroi_fwd, psroi_bwd) -> dict:
    """the launches of every counted kernel: the tracker's fused ROIPool head
    runs once a tracker call (three K1 launches: c3, c4, c5) and its
    backward once a tracker backward (two dFM0 launches: c4, c5); the
    materialized ROIPool (the oracle head) never on the main paths."""
    return {"corr_fwd": corr_fwd, "corr_bwd_fm0": corr_bwd_fm0, "corr_bwd_fm1": corr_bwd_fm1, "nms_mask": nms_mask,
            "psroi_fwd": psroi_fwd, "psroi_bwd": psroi_bwd, "roipool_linear_fwd": corr_fwd // 3,
            "roipool_linear_bwd": corr_bwd_fm0 // 2, "roipool_fwd": 0, "roipool_bwd": 0}


def _zero_counts() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def check_map_layouts(what: str, fn) -> None:
    """run fn with the R-FCN's PSROIPool calls (the op d2t::psroi_fwd on its
    bin-major maps) watched; fail unless every call gets contiguous NHWC
    maps, the layout the psroi phase times as the main path's."""
    from detect_to_track_tpu_torch.models import rfcn

    seen, pool = [], rfcn.psroi_fwd

    def watched(fg, *args, **kwargs):
        seen.append("NHWC" if fg.is_contiguous() else "NCHW" if fg.permute(0, 3, 1, 2).is_contiguous()
                    else str(fg.stride()))
        return pool(fg, *args, **kwargs)

    rfcn.psroi_fwd = watched
    try:
        fn()
    finally:
        rfcn.psroi_fwd = pool
    if not seen or set(seen) != {"NHWC"}:
        raise AssertionError(f"{what}: PSROIPool got maps of storage {seen}, expected contiguous NHWC")
    log(f"{what}: PSROIPool's maps contiguous NHWC in all {len(seen)} calls")


def _trainable(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def _update_err(got: dict, ref: dict, init: dict):
    """the largest difference of two updated weight sets, per tensor as a
    share of the reference's largest update of that tensor: (worst share,
    its tensor's name)."""
    worst, name = 0.0, None
    for k, r in ref.items():
        upd = (r.float() - init[k].float()).abs().max().item()
        err = (got[k].float() - r.float()).abs().max().item()
        share = err / upd if upd > 0 else (0.0 if err == 0 else math.inf)
        if share > worst:
            worst, name = share, k
    return worst, name


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


DDP_JOIN_S = 300.0
# bf16 tolerances of the data-parallel checks: each rank's convolutions sum
# 2 pairs where the single process sums 4, and DDP's all-reduce adds the two
# halves, so the gradients differ by bf16 rounding (2^-8 relative per term)
DDP_LOSS_RTOL = 2e-2
DDP_UPDATE_SHARE = 5e-2  # of each tensor's largest update


def phase_ddp(smi: str):
    """data parallelism on the one card. This checks correctness, not
    scaling: the machine has one H100, and two ranks that share it measure
    nothing about several cards.

    - world size 1, NCCL: make_parallel_train_step (DistributedDataParallel)
      at full width from the train phase's init and batch against
      make_train_step: the losses equal, the updated weights within 1e-2 of
      each tensor's largest update, 3 / 2 / 2 / 1 / 2 / 2 kernel launches
      (corr_fwd, corr_bwd_fm0, corr_bwd_fm1, nms_mask, psroi_fwd,
      psroi_bwd).
    - world size 2 on the one card, gloo named explicitly (NCCL refuses two
      ranks on one device): two child processes (ranks) run one step at 2
      pairs per rank against the single-process 4-pair step (losses rtol
      DDP_LOSS_RTOL, weights within DDP_UPDATE_SHARE of each tensor's
      largest update), make_parallel_detect on the slice phase's pairs
      against Detector.detect_pairs (bitwise on each rank's rows called
      alone; the 4-pair call's valid counts), and train.main with NUM_DEVICES 2 over
      a fixture ILSVRC tree for one 4-step epoch: the ranks end bitwise
      equal and only rank 0 wrote the checkpoints and metrics.jsonl.
    Returns the kernel launches of the phase, the ranks' included."""
    import os
    import shutil

    import torch
    import torch.distributed as dist

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.config import load_config, save_config
    from detect_to_track_tpu_torch.parallel import init_distributed, make_mesh, make_parallel_train_step

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    work = ROOT / "build" / "chip_smoke_ddp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    batch = train_batches(cfg, 1)[0]
    log(f"[ddp] correctness on one card, not scaling: {cfg.BACKBONE_ARCH} {cfg.INPUT_SHAPE} x{cfg.BATCH_SIZE} pairs "
        f"{cfg.COMPUTE_DTYPE}; card: {smi}")

    # ---- the single-process reference step ----
    model = train_model(cfg)
    step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model))
    init = _trainable(model)
    ref_losses = step(batch).vector()
    ref = _trainable(model)
    del model, step

    # ---- world size 1, NCCL: counters from 0, read right after ----
    init_distributed(torch.device("cuda", 0), backend="nccl", init_method=f"file://{work / 'store_nccl'}",
                     world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        model = train_model(cfg)
        step = make_parallel_train_step(model, cfg, trainer.make_optimizer(cfg, model), mesh)
        _zero_counts()
        t = time.perf_counter()
        losses = step(batch).vector()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = _read_counts()
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    share, worst = _update_err(_trainable(model), ref, init)
    log(f"[ddp] world size 1 ({backend}): DDP step {ms:.1f} ms (its first, warm-up included), launches {launches}; "
        f"losses {losses.tolist()} vs make_train_step {ref_losses.tolist()}; weights' largest difference "
        f"{share:.3e} of the tensor's largest update ({worst}; tol 1e-2)")
    if launches != _launches(3, 2, 2, 1, 2, 2):
        raise AssertionError(f"world-size-1 DDP step launches {launches}, expected 3 / 2 / 2 / 1 / 2 / 2")
    if not torch.equal(losses, ref_losses):
        raise AssertionError("world-size-1 DDP step losses differ from make_train_step's")
    if not share <= 1e-2:
        raise AssertionError(f"world-size-1 DDP step weights differ from make_train_step's: {share} ({worst})")
    del model, step
    saved = {"losses": ref_losses.cpu(), "init": {k: v.cpu() for k, v in init.items()},
             "ref": {k: v.cpu() for k, v in ref.items()}}
    del init, ref
    torch.cuda.empty_cache()

    # ---- world size 2 on the one card, gloo ----
    subprocess.run([sys.executable, str(ROOT / "tools" / "make_fixture_tree.py"), str(work / "ILSVRC"),
                    "--snippets", "4", "--frames", "8", "--det", "4"], check=True, capture_output=True, text=True)
    tcfg = cfg.replace(DATA_ROOT=str(work / "ILSVRC"), TRN_SIZE=16, VAL_SIZE=8, REP_SIZE=2,
                       OUTPUT_DIR=str(work / "output"), LOG_EVERY=4, CHECKPOINT_KEEP=2, NUM_DEVICES=2)
    save_config(tcfg, str(work / "trainer.yaml"))
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    logs = [work / f"rank{r}.log" for r in range(2)]
    procs = []
    t = time.perf_counter()
    try:
        for r in range(2):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-rank", str(work)],
                                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                                              stdout=f, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DDP_JOIN_S
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t
    codes = [proc.returncode for proc in procs]
    if codes != [0, 0]:
        tails = "\n".join(f"--- rank {r} (exit {c}) ---\n{logs[r].read_text()[-4000:]}" for r, c in enumerate(codes))
        raise AssertionError(f"the world-size-2 ranks failed or outlived {DDP_JOIN_S} s:\n{tails}")
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    log(f"[ddp] world size 2 on one card (gloo): both ranks done in {wall:.1f} s wall (start-up included)")
    for r, rk in enumerate(ranks):
        log(f"[ddp]   rank {r}: step ms {rk['step']['ms']} (first, then second), launches {rk['step']['launches']} "
            f"in 2 steps; detect launches {rk['detect']['launches']}; train.main launches {rk['train']['launches']} "
            f"in {rk['train']['steps']} steps ({rk['train']['seconds']:.1f} s); card: {smi}")

    # 1. one step at 2 pairs per rank against the single process's 4-pair step
    got = torch.load(work / "rank0_params.pt", weights_only=True)
    share, worst = _update_err(got, saved["ref"], saved["init"])
    loss = torch.tensor(ranks[0]["step"]["losses"])
    loss_err = ((loss - saved["losses"]).abs() / saved["losses"].abs().clamp(min=1e-12)).max().item()
    log(f"[ddp]   step vs the single-process 4-pair step: losses {loss.tolist()} vs {saved['losses'].tolist()} "
        f"(largest relative difference {loss_err:.3e}, tol {DDP_LOSS_RTOL}); weights' largest difference "
        f"{share:.3e} of the tensor's largest update ({worst}; tol {DDP_UPDATE_SHARE})")
    if any(ranks[0]["step"][k] != ranks[1]["step"][k] for k in ("digest", "losses")):
        raise AssertionError("the two ranks' weights or losses differ after the DDP step")
    if not (loss_err <= DDP_LOSS_RTOL and share <= DDP_UPDATE_SHARE):
        raise AssertionError("the 2-rank step disagrees with the single-process step")
    for rk in ranks:
        if rk["step"]["launches"] != _launches(6, 4, 4, 2, 4, 4):
            raise AssertionError(f"a rank's two DDP steps launched {rk['step']['launches']}")
    # 2. make_parallel_detect against Detector.detect_pairs: bitwise the
    # ranks' rows as their own calls, and the 4-pair call's valid counts
    det = ranks[0]["detect"]
    log(f"[ddp]   make_parallel_detect on {cfg.BATCH_SIZE} pairs: bitwise Detector.detect_pairs on each rank's "
        f"rows {det['rows_equal']}; valid per frame {det['valid_counts']}, the 4-pair call's {det['ref_valid_counts']}")
    if not (det["rows_equal"] and det["valid_counts"] == det["ref_valid_counts"]) \
            or ranks[1]["detect"]["digest"] != det["digest"]:
        raise AssertionError(f"make_parallel_detect disagrees with Detector.detect_pairs: {det}")
    for rk in ranks:
        if rk["detect"]["launches"] != _launches(3, 0, 0, 1, 2, 0):
            raise AssertionError(f"a rank's parallel detect launched {rk['detect']['launches']}")
    # 3. train.main with NUM_DEVICES 2
    out = Path(tcfg.OUTPUT_DIR)
    files = sorted(x.name for x in out.iterdir())
    lines = (out / "metrics.jsonl").read_text().splitlines()
    log(f"[ddp]   train.main NUM_DEVICES 2: steps {[rk['train']['steps'] for rk in ranks]}, weights bitwise equal "
        f"{ranks[0]['train']['digest'] == ranks[1]['train']['digest']}; torch.save by rank "
        f"{[rk['train']['saves'] for rk in ranks]}; metrics.jsonl {len(lines)} lines; output {files}")
    steps, val_batches = tcfg.TRN_SIZE // tcfg.BATCH_SIZE, tcfg.VAL_SIZE // tcfg.BATCH_SIZE
    for r, rk in enumerate(ranks):
        rep_pairs = tcfg.REP_SIZE if r == 0 else 0  # rank 0 alone reports
        calls = steps + val_batches + rep_pairs  # one forward, so 3 K1, 1 NMS and 2 PSROIPool, each
        expected = _launches(3 * calls, 2 * steps, 2 * steps, calls, 2 * calls, 2 * steps)
        if rk["train"]["launches"] != expected or rk["train"]["steps"] != steps:
            raise AssertionError(f"rank {r}: train.main launches {rk['train']['launches']} != {expected}")
    if ranks[0]["train"]["digest"] != ranks[1]["train"]["digest"]:
        raise AssertionError("the ranks' weights differ after train.main")
    if ranks[1]["train"]["saves"] or sorted(ranks[0]["train"]["saves"]) != ["ckpt.tmp", "ckpt_final.tmp"]:
        raise AssertionError("a rank other than 0 wrote a checkpoint, or rank 0 did not write both")
    if len(lines) != 2 or not all(name in files for name in ("ckpt", "ckpt_final", f"ckpt_step_{steps:08d}", "report")):
        raise AssertionError(f"metrics.jsonl has {len(lines)} lines (one stream: 2) or an output is missing: {files}")
    total = dict(launches)
    for rk in ranks:
        for part in ("step", "detect", "train"):
            for k, v in rk[part]["launches"].items():
                total[k] += v
    shutil.rmtree(work, ignore_errors=True)
    return total


def ddp_rank_main(work: Path) -> int:
    """one rank of the ddp phase's world of 2 on the one card (RANK,
    WORLD_SIZE, MASTER_ADDR and MASTER_PORT from the parent): a step and a
    parallel detect in a gloo group over a file store, then train.main,
    which joins its own group through the environment. Writes
    rank{RANK}.json (and rank 0 its updated weights) into `work`."""
    import hashlib
    import os

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from detect_to_track_tpu_torch import train, trainer
    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.inference import Detector
    from detect_to_track_tpu_torch.parallel import (
        init_distributed,
        make_mesh,
        make_parallel_detect,
        make_parallel_train_step,
        shard_batch,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    dev = torch.device("cuda", 0)  # both ranks share the one card

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().float().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    cfg = load_config(str(ROOT / "cfg" / "default.yaml")).replace(NUM_DEVICES=2)
    init_distributed(dev, backend="gloo", init_method=f"file://{work / 'store_gloo'}", world_size=2, rank=rank)
    try:
        mesh = make_mesh(2)
        model = train_model(cfg)
        step = make_parallel_train_step(model, cfg, trainer.make_optimizer(cfg, model), mesh)
        batch = shard_batch(train_batches(cfg, 1)[0], mesh)
        _zero_counts()
        ms, losses = [], None
        for i in range(2):
            t = time.perf_counter()
            dtl = step(batch)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t) * 1e3, 1))
            if i == 0:
                losses = dtl.vector().tolist()
                params = _trainable(model)
                if rank == 0:
                    torch.save({k: v.cpu() for k, v in params.items()}, work / "rank0_params.pt")
                out["step"] = {"losses": losses, "digest": digest(params.values())}
        out["step"].update(ms=ms, launches=_read_counts())
        del model, step, params

        smodel = slice_model(cfg)
        det = Detector(smodel, cfg, dev)
        pairs = slice_pairs(cfg)
        # the 4-pair call, and each rank's 2 pairs as their own calls: the
        # batch a convolution sees changes its algorithm and so the last
        # bits, and the random weights' saturated confidences leave ties
        # that those bits order
        ref = det.detect_pairs(pairs)
        half = len(pairs) // 2
        per_rank = [det.detect_pairs(pairs[r * half : (r + 1) * half]) for r in range(2)]
        detect = make_parallel_detect(smodel, cfg, mesh, dev)
        _zero_counts()
        got = detect(pairs, det.anchors)
        torch.cuda.synchronize()
        launches = _read_counts()
        out["detect"] = {
            "launches": launches,
            "rows_equal": all(torch.equal(g, torch.cat([pr[i] for pr in per_rank])) for i, g in enumerate(got)),
            "valid_counts": got.valid.sum(-1).tolist(), "ref_valid_counts": ref.valid.sum(-1).tolist(),
            "digest": digest(got),
        }
        del smodel, det, detect
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    saves = []
    save = torch.save

    def counted(obj, f, *args, **kwargs):
        saves.append(Path(f).name)
        return save(obj, f, *args, **kwargs)

    torch.save = counted
    _zero_counts()
    t = time.perf_counter()
    try:
        tr = train.main(["-c", str(work / "trainer.yaml"), "--device", "cuda:0", "--dist-backend", "gloo",
                         "--max-iters", "16"])
    finally:
        torch.save = save
    torch.cuda.synchronize()
    out["train"] = {"seconds": time.perf_counter() - t, "launches": _read_counts(), "steps": tr.step_count,
                    "digest": digest(p for p in tr.model.parameters()), "saves": saves}
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def phase_options(smi: str):
    """the configuration switches at full width (cfg/default.yaml):
    - HOST_S2D: the backbone's c3 / c4 / c5 on host-packed frames against
      the plain stem's, within 1e-4 (f32) and 3e-2 (bf16) of the largest
      magnitude, and the bf16 Detector on the slice phase's pairs (3 K1 per
      call, finite outputs, the plain stem's valid counts);
    - REMAT: one training step (bf16, 4 pairs) against the plain step from
      the same weights: the losses equal, 3 / 2 / 2 / 1 / 2 / 2 launches a step, two
      more steps timed, the first step's weights
      within 1e-2 of each tensor's largest update, and the track loss's
      gradients wrt layer3 / layer4 within 1e-2 of their largest magnitude;
    - sat against einsum pooling (on the card the PSROIPool kernels) at the
      R-FCN head's shapes (38x75, MAX_ROIS, k, BATCH_SIZE pairs), forward
      and gradient;
    - checked_loss_fn naming a component made non-finite on purpose.
    Returns the kernel launches of the phase."""
    import torch

    from detect_to_track_tpu_torch import trainer
    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.diagnostics import checked_loss_fn
    from detect_to_track_tpu_torch.inference import Detector
    from detect_to_track_tpu_torch.ops import pooling
    from detect_to_track_tpu_torch.utils import space_to_depth2

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    total = {name: 0 for name in _counters()}

    def add(counts):
        for k, v in counts.items():
            total[k] += v

    # ---- HOST_S2D ----
    # the stems agree to their last bits only, and at random weights the
    # proposal filter's and the compaction's top-k boundaries hold
    # near-ties (objectness near 0.5 at the seeded init, softmaxes
    # saturated to within an ulp at the reference-keyed weights) that those
    # bits reorder: detections are held slot for slot against JAX and the
    # plain stem on the CPU (tests/test_torch_port_options.py); here the
    # features are held, and the Detector's valid counts
    pairs = slice_pairs(cfg)
    x = torch.from_numpy(pairs[0]).cuda().float() / 255.0
    z = torch.from_numpy(space_to_depth2(pairs[0])).cuda().float() / 255.0
    rel = {}
    for dtype, tol in (("float32", 1e-4), ("bfloat16", 3e-2)):
        model = train_model(cfg.replace(COMPUTE_DTYPE=dtype))
        with torch.no_grad():
            fa, fb = model.backbone(x), model.backbone(z)
        rel[dtype] = {k: ((fa[k].float() - fb[k].float()).abs().max() / fa[k].float().abs().max()).item() for k in fa}
        log(f"[options] {dtype} backbone at {tuple(x.shape[1:3])}, pre-s2d stem vs plain stem: largest difference / "
            f"largest magnitude {({k: float(f'{v:.3e}') for k, v in rel[dtype].items()})} (tol {tol})")
        if any(not v <= tol for v in rel[dtype].values()):
            raise AssertionError(f"the {dtype} pre-s2d stem disagrees with the plain stem")
    plain, s2d = Detector(model, cfg), Detector(model, cfg.replace(HOST_S2D=True))
    a = plain.detect_pairs(pairs)
    _zero_counts()
    b = s2d.detect_pairs(pairs)
    confs0, _, boxes0, _, tracks = s2d(pairs[0, 0], pairs[0, 1])
    torch.cuda.synchronize()
    launches = _read_counts()
    add(launches)
    counts_a, counts_b = a.valid.sum(-1).tolist(), b.valid.sum(-1).tolist()
    log(f"[options] HOST_S2D Detector (bf16): detect_pairs x{len(pairs)} and __call__, launches {launches}; valid "
        f"per frame {counts_b}, the plain stem's {counts_a}; __call__ {len(boxes0)} frame-0 detections")
    finite = all(bool(torch.isfinite(f).all()) for f in (b.confs, b.boxes, b.tracks))
    if launches != _launches(6, 0, 0, 2, 4, 0) or counts_a != counts_b or not finite or tracks.shape != (len(boxes0), 4):
        raise AssertionError("the HOST_S2D Detector's launches, valid counts or outputs are wrong")
    del plain, s2d

    # ---- REMAT ----
    model.train()  # the Detectors left it in eval mode
    batch = train_batches(cfg, 1)[0]
    state = {k: v.clone() for k, v in model.state_dict().items()}
    init = _trainable_after_freeze(model, cfg)
    results = {}
    for remat in (False, True):
        model.load_state_dict(state)
        model.backbone.remat = remat
        step = trainer.make_train_step(model, cfg, trainer.make_optimizer(cfg, model))
        _zero_counts()
        losses = step(batch).vector()
        weights = _trainable(model)
        ms = []
        for _ in range(2):  # timed: the same batch again
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            ms.append(round((time.perf_counter() - t) * 1e3, 1))
        launches = _read_counts()
        add(launches)
        results[remat] = (losses, weights)
        log(f"[options] REMAT {remat}: steps 2-3 {ms} ms, launches {launches} in 3 steps, first step's losses "
            f"{losses.tolist()}")
        if launches != _launches(9, 6, 6, 3, 6, 6):
            raise AssertionError(f"REMAT {remat} steps launched {launches}")
    share, worst = _update_err(results[True][1], results[False][1], init)
    log(f"[options] REMAT step vs plain step: losses equal {torch.equal(results[True][0], results[False][0])}, "
        f"weights' largest difference {share:.3e} of the tensor's largest update ({worst}; tol 1e-2)")
    if not torch.equal(results[True][0], results[False][0]) or not share <= 1e-2:
        raise AssertionError("the REMAT step disagrees with the plain step")
    grads = {}
    for remat in (False, True):
        model.load_state_dict(state)
        model.backbone.remat = remat
        model.zero_grad(set_to_none=True)
        anchors, crosses = trainer._anchor_tensors(cfg, torch.device("cuda"))
        trainer.forward_losses(model, batch, anchors, crosses, cfg).t.backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.backbone.named_parameters()
                        if p.grad is not None and n.startswith(("layer3", "layer4"))}
    g_err = max((grads[True][k].float() - g.float()).abs().max().item() / max(g.float().abs().max().item(), 1e-30)
                for k, g in grads[False].items())
    log(f"[options] track loss's gradients wrt {len(grads[False])} layer3 / layer4 weights, REMAT vs plain: "
        f"largest difference {g_err:.3e} of the tensor's largest gradient (tol 1e-2)")
    if len(grads[True]) != len(grads[False]) or not grads[False] or not g_err <= 1e-2:
        raise AssertionError("the REMAT track-loss gradients disagree with the plain ones")
    model.backbone.remat = False

    # ---- checked_loss_fn ----
    anchors, crosses = trainer._anchor_tensors(cfg, torch.device("cuda"))

    def poisoned(b):
        with torch.no_grad():
            dtl = trainer.forward_losses(model, b, anchors, crosses, cfg)
        dtl.c = dtl.c * float("nan")
        return dtl

    clean_err, _ = checked_loss_fn(lambda b: trainer.forward_losses(model, b, anchors, crosses, cfg))(batch)
    err, _ = checked_loss_fn(poisoned)(batch)
    log(f"[options] checked_loss_fn: clean batch {clean_err.get()!r}; the R-FCN class loss made NaN: {err.get()!r}")
    if clean_err.get() is not None or err.get() != "loss component 'c' is non-finite":
        raise AssertionError("checked_loss_fn did not name the poisoned component")
    try:
        err.throw()
        raise AssertionError("checked_loss_fn's error did not raise")
    except FloatingPointError:
        pass
    del model, state, results, grads
    torch.cuda.empty_cache()

    # ---- sat vs einsum (the kernels) at the R-FCN head's shapes ----
    fh, fw = cfg.fm_shape
    n_frames, k, n_t = 2 * cfg.BATCH_SIZE, cfg.K, cfg.N_CLASSES + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    fm = torch.randn(n_frames, fh, fw, n_t * k * k, device="cuda", generator=gen)
    ij = torch.rand(n_frames, cfg.MAX_ROIS, 2, device="cuda", generator=gen) * 0.8 + 0.1
    hw = torch.rand(n_frames, cfg.MAX_ROIS, 2, device="cuda", generator=gen) * 0.5 + 0.02
    rois = torch.cat([ij, hw], -1)
    outs, gs = {}, {}
    for impl in ("einsum", "sat"):
        x = fm.clone().requires_grad_()
        outs[impl] = pooling.ps_roi_pool(x, rois, n_t, k, impl=impl)
        (outs[impl] ** 2).sum().backward()
        gs[impl] = x.grad
    ms = {impl: cuda_time_ms(lambda impl=impl: pooling.ps_roi_pool(fm, rois, n_t, k, impl=impl), iters=10)
          for impl in ("einsum", "sat")}
    o_err = (outs["sat"] - outs["einsum"]).abs().max().item() / outs["einsum"].abs().max().item()
    g_err = (gs["sat"] - gs["einsum"]).abs().max().item() / gs["einsum"].abs().max().item()
    log(f"[options] ps_roi_pool sat vs einsum (the kernels) at {n_frames} x {fh}x{fw} x {n_t * k * k} ch, "
        f"{cfg.MAX_ROIS} rois, k {k}: forward {o_err:.3e}, gradient {g_err:.3e} of the largest magnitude (tol 1e-4); "
        f"forward ms kernel {ms['einsum']:.3f}, sat {ms['sat']:.3f}; card: {smi}")
    if not (o_err <= 1e-4 and g_err <= 1e-4):
        raise AssertionError("sat pooling disagrees with einsum pooling")
    return total


def _trainable_after_freeze(model, cfg) -> dict:
    """the weights a training step moves (the freeze applied), cloned."""
    from detect_to_track_tpu_torch.models import set_trainable_stages

    set_trainable_stages(model, cfg.FIRST_TRAINABLE_STAGE)
    return _trainable(model)



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


# PSROIPool's tolerance: the kernels sum a bin (forward) and a channel's
# terms (backward) in another order than the einsum form, f32 rounding of
# sums of tens of terms: 1e-5 of the largest magnitude
PSROI_TOL = 1e-5


def psroi_rois(seed, b, r):
    """(b, r, 4) float32 ijhw rois on the card, proposal-like (centres in
    [0, 1], sides 0.02-0.62 of the frame), with every 16th past the border
    (centre within 0.03 of a corner, sides 0.5-1.2) and every 32nd empty
    (zero height on a pixel boundary, or outside the map)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rois = np.concatenate([rng.uniform(0.0, 1.0, (b, r, 2)), rng.uniform(0.02, 0.62, (b, r, 2))], -1)
    past = rois[:, 1::16]
    past[..., :2] = rng.choice([0.02, 0.98], past[..., :2].shape)
    past[..., 2:] = rng.uniform(0.5, 1.2, past[..., 2:].shape)
    rois[:, 1::16] = past
    rois[:, 3::32] = [0.5, 0.5, 0.0, 0.3]  # zero height at row 19.0 of 38: every bin empty
    rois[:, 7::32] = [1.4, 0.5, 0.2, 0.2]  # below the map: every bin empty
    return torch.from_numpy(rois.astype(np.float32)).cuda()


def _psroi_bin_pixels(bounds, h, w):
    """(B, R, k, k) pixels of the map in each bin, 0 where n <= 0 (an empty
    bin), and the masks (rmask, cmask) of _bounds_masks."""
    import torch

    from detect_to_track_tpu_torch.ops.pooling import _bounds_masks

    rmask, cmask, numel = _bounds_masks(bounds, h, w, torch.float32)
    pixels = rmask.sum(-1)[..., :, None] * cmask.sum(-1)[..., None, :]
    return torch.where(numel > 0, pixels, torch.zeros_like(pixels)), rmask, cmask


def psroi_fwd_bound_ms(bounds, n_t, k, paper, h, w):
    """least time of the forward on these inputs: each element of the
    reference-layout maps that a bin of its channel holds (some roi's bin
    (i, j) for a (t, i, j) that the channel map sends there) read once, the
    outputs written once, the bounds read once; against an add per pixel of
    a non-empty bin and target and a division per output (f32). Returns
    (ms, bound_by, bin-major ms): the last the same bound for the bin-major
    maps the kernel reads, where (t, i, j) that the quirk sends to one
    channel are separate elements."""
    import torch

    from detect_to_track_tpu_torch.ops.torch_ref import ps_roi_pool_channel_map

    b, r = bounds.shape[:2]
    pixels, rmask, cmask = _psroi_bin_pixels(bounds, h, w)
    cover = (torch.einsum("brih,brjw->bijhw", rmask, cmask) > 0).float().reshape(b, 1, k * k, h * w)
    needed = torch.zeros(b, n_t * k * k, h * w, device=bounds.device)
    needed.index_add_(1, ps_roi_pool_channel_map(n_t, k, paper, bounds.device).reshape(-1),
                      cover.expand(b, n_t, k * k, h * w).reshape(b, n_t * k * k, h * w))
    ops = float(pixels.sum()) * n_t + b * r * n_t * k * k

    def bound(elements):
        nbytes = 4 * (elements + b * r * n_t * k * k + bounds.numel())
        return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / F32_FLOPS * 1e3, "operations"))

    return (*bound(int((needed > 0).sum())), bound(int(cover.sum()) * n_t)[0])


def psroi_bwd_bound_ms(bounds, n_t, k, h, w):
    """least time of the backward: the cotangent read once, the map's
    gradient written once, the bounds read once; against a division and an
    add per pixel of a non-empty bin and target. Returns (ms, bound_by)."""
    b, r = bounds.shape[:2]
    pixels, _, _ = _psroi_bin_pixels(bounds, h, w)
    nbytes = 4 * (b * r * n_t * k * k + b * h * w * n_t * k * k + bounds.numel())
    ops = 2.0 * float(pixels.sum()) * n_t
    return max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / F32_FLOPS * 1e3, "operations"))


def _peak_mib(fn) -> float:
    """MiB that fn allocates at its peak above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 2**20


def phase_psroi(smi: str):
    """PSROIPool's kernels (ops/csrc/psroi.cu) at the R-FCN head's working
    shapes (2 * BATCH_SIZE frames, the 38x75 maps, MAX_ROIS proposal-like
    rois with rois past the border and empty bins, k 7): the class head (31
    targets, 1519 channels) and the box head (4 targets, 196 channels), on
    bin-major maps (random reference-layout maps' channels gathered by
    either channel map, the quirk and the paper's) in both storages
    (contiguous NHWC, the main path's: the R-FCN's convolutions run
    channels-last, checked here on the head itself and in the slice and
    train phases; and NHWC views of NCHW storage). The forward against the
    plain einsum form and the backward against autograd through it, within
    PSROI_TOL of the largest magnitude; empty bins exactly 0; the backward
    bitwise the same on a repeat and through the op's autograd; ps_roi_pool
    on the reference maps bitwise the op on their gather. Each kernel timed
    by CUDA events in every layout, beside its bound (PR 13's count, on the
    reference-layout maps) and the bin-major maps' bound; at the main
    path's layouts (contiguous NHWC, the configured channel map) beside the
    plain version's time, the memory one head's forward and backward take,
    and the R-FCN's weight gather (BinMajorRows) and its gradient's fold on
    the head's 1x1 conv (the fold bitwise on a repeat, within 1e-6 of
    index_add_). Outside the main-path launch count. Returns {kernel: [row
    per head]} and the largest absolute errors."""
    import torch

    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.models.rfcn import RFCN
    from detect_to_track_tpu_torch.ops import pooling

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    fh, fw = cfg.fm_shape
    b, k, r = 2 * cfg.BATCH_SIZE, cfg.K, cfg.MAX_ROIS
    rois = psroi_rois(0, b, r)
    bounds = pooling.psroi_bounds(rois, k, fh, fw)
    i0, i1, j0, j1 = bounds.unbind(2)
    empty = (i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0  # (B, R, k, k)
    # the head's own maps: its convolutions on a contiguous NHWC c5, as the backbone gives it
    torch.manual_seed(0)
    rfcn = RFCN(cfg.N_CLASSES, k=k, paper_channel_layout=cfg.FIX_PSROI_CHANNEL_MAP,
                dtype=cfg.compute_dtype).cuda()
    with torch.no_grad():
        check_map_layouts(f"[psroi] the R-FCN head ({cfg.COMPUTE_DTYPE})",
                          lambda: rfcn(torch.randn(b, fh, fw, 2048, device="cuda"), rois))
    reduce_channels = rfcn.cls_sm_conv.in_channels
    del rfcn
    log(f"[psroi] {b} frames x {fh}x{fw}, {r} rois, k {k}: {int(empty.sum())} of {empty.numel()} bins empty; "
        f"main path: contiguous NHWC bin-major maps, paper layout {cfg.FIX_PSROI_CHANNEL_MAP}; card: {smi}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {"psroi_fwd": [], "psroi_bwd": []}
    errs = {"psroi_fwd": 0.0, "psroi_bwd": 0.0}
    for head, n_t in (("class", cfg.N_CLASSES + 1), ("box", 4)):
        c = n_t * k * k
        for paper in (False, True):
            perm = pooling.bin_major_channels(n_t, k, paper, "cuda")
            for nchw in (False, True):
                ref_maps = torch.randn((b, c, fh, fw) if nchw else (b, fh, fw, c), device="cuda", generator=gen)
                base = ref_maps[:, perm] if nchw else ref_maps[..., perm]  # bin-major, in the same storage
                view = (lambda y: y.permute(0, 2, 3, 1)) if nchw else (lambda y: y)  # (B, H, W, C)
                fg = view(base)
                got = pooling.psroi_fwd_cuda(fg, bounds, n_t)
                ref = pooling.ps_roi_pool_plain(fg, bounds, n_t)
                g = torch.randn(got.shape, device="cuda", generator=gen)
                x = base.detach().requires_grad_()
                (want,) = torch.autograd.grad(pooling.ps_roi_pool_plain(view(x), bounds, n_t), x, g)
                want = view(want)
                d1 = pooling.psroi_bwd_cuda(g, bounds, n_t, fh, fw)
                d2 = pooling.psroi_bwd_cuda(g, bounds, n_t, fh, fw)
                x2 = base.detach().requires_grad_()  # through the op and its autograd, as RFCN.forward calls it
                out = torch.ops.d2t.psroi_fwd(view(x2), bounds, n_t)
                out.backward(g)
                public = pooling.ps_roi_pool(view(ref_maps), rois, n_t, k, paper)  # the gather, then the op
                torch.cuda.synchronize()
                f_scale, b_scale = ref.abs().max().item(), want.abs().max().item()
                f_err, b_err = (got - ref).abs().max().item(), (d1 - want).abs().max().item()
                errs["psroi_fwd"] = max(errs["psroi_fwd"], f_err)
                errs["psroi_bwd"] = max(errs["psroi_bwd"], b_err)
                zeros = bool((got.permute(0, 1, 3, 4, 2)[empty] == 0).all())
                same = (torch.equal(d1, d2) and torch.equal(view(x2.grad), d1) and torch.equal(out, got)
                        and torch.equal(public, got))
                layout = f"{head} head, {'paper' if paper else 'quirk'} map, {'NCHW' if nchw else 'NHWC'} storage"
                if not (f_err <= PSROI_TOL * f_scale and b_err <= PSROI_TOL * b_scale and zeros and same):
                    raise AssertionError(f"PSROIPool kernels, {layout}: forward err {f_err:.3e} (max|ref| "
                                         f"{f_scale:.3e}), backward err {b_err:.3e} (max|ref| {b_scale:.3e}), empty "
                                         f"bins 0 {zeros}, backward repeatable and = autograd's, ps_roi_pool = the "
                                         f"op {same}")
                fwd_ms = cuda_time_ms(lambda: pooling.psroi_fwd_cuda(fg, bounds, n_t))
                bwd_ms = cuda_time_ms(lambda: pooling.psroi_bwd_cuda(g, bounds, n_t, fh, fw))
                fb, fby, fb_bm = psroi_fwd_bound_ms(bounds, n_t, k, paper, fh, fw)
                bb, bby = psroi_bwd_bound_ms(bounds, n_t, k, fh, fw)
                blocks = pooling._psroi_lib().d2t_psroi_bwd_blocks_per_sm(n_t, k)
                msg = (f"[psroi] {layout}: forward {fwd_ms:.4f} ms (bound {fb:.4f}, {fby}, reference-layout "
                       f"elements; bin-major elements {fb_bm:.4f}; err {f_err:.2e}, max|ref| {f_scale:.2e}), "
                       f"backward {bwd_ms:.4f} ms (bound {bb:.4f}, {bby}; err {b_err:.2e}, max|ref| {b_scale:.2e}; "
                       f"{blocks} blocks an SM); backward bitwise on a repeat and through autograd")
                if not nchw and paper == cfg.FIX_PSROI_CHANNEL_MAP:  # the main path's layouts
                    plain_fwd = cuda_time_ms(lambda: pooling.ps_roi_pool_plain(fg, bounds, n_t), iters=5)
                    plain_bwd = cuda_time_ms(lambda: pooling.psroi_bwd_ref(g, bounds, n_t, fh, fw), iters=5)

                    def step(pool):
                        y = base.detach().requires_grad_()
                        pool(view(y)).backward(g)

                    mem_kernel = _peak_mib(lambda: step(lambda y: torch.ops.d2t.psroi_fwd(y, bounds, n_t)))
                    mem_plain = _peak_mib(lambda: step(lambda y: pooling.ps_roi_pool_plain(y, bounds, n_t)))
                    # the backward's cost without hits: rois whose row bins
                    # hold every row and whose column bins lie past the map
                    no_hit = pooling.psroi_bounds(torch.tensor([0.5, 1.4, 1.0, 0.2], device="cuda").expand(b, r, 4),
                                                  k, fh, fw)
                    no_hit_ms = cuda_time_ms(lambda: pooling.psroi_bwd_cuda(g, no_hit, n_t, fh, fw))
                    gather_ms, fold_ms, fold_host_ms = psroi_weight_gather_ms(n_t, k, paper, reduce_channels, gen)
                    rows["psroi_fwd"].append(dict(head=head, ms=fwd_ms, plain_ms=plain_fwd, bound_ms=fb, bound_by=fby))
                    rows["psroi_bwd"].append(dict(head=head, ms=bwd_ms, plain_ms=plain_bwd, bound_ms=bb, bound_by=bby))
                    msg += (f"; plain forward {plain_fwd:.4f} ms, plain backward (psroi_bwd_ref) {plain_bwd:.4f} ms; "
                            f"forward + backward peak {mem_kernel:.1f} MiB (plain {mem_plain:.1f} MiB); backward "
                            f"with rois that hold no pixel (every row bin held, column bins past the map) "
                            f"{no_hit_ms:.4f} ms; the 1x1 conv's weight and bias gathered bin-major: device "
                            f"{gather_ms:.4f} ms, gathered and folded back (forward + backward) device {fold_ms:.4f} "
                            f"ms, host {fold_host_ms:.4f} ms a call")
                log(msg)
                del ref_maps, base, fg, got, ref, g, x, want, d1, d2, x2, out, public
    torch.cuda.empty_cache()
    return rows, errs


def psroi_weight_gather_ms(n_t, k, paper, in_channels, gen):
    """the R-FCN's bin-major weight gather (BinMajorRows) on one head's 1x1
    conv (T k^2 x in_channels weight and its bias): the gradients' fold
    bitwise the same on a repeat and within 1e-6 of the largest magnitude
    of index_add_ (atomics; another order). Returns the device ms of the
    gather and of the gather with its backward (torch.profiler's kernel
    time a call) and the host ms a call of the latter (CUDA events around
    back-to-back calls: the host's pace where it is slower than the card)."""
    import torch

    from detect_to_track_tpu_torch.ops import pooling

    rows = pooling.BinMajorRows(n_t, k, paper).cuda()
    c = n_t * k * k
    params = (torch.randn(c, in_channels, 1, 1, device="cuda", generator=gen).requires_grad_(),
              torch.randn(c, device="cuda", generator=gen).requires_grad_())
    cots = tuple(torch.randn(p.shape, device="cuda", generator=gen) for p in params)

    def fold():
        return torch.autograd.grad(rows(*params), params, cots)

    got, again = fold(), fold()
    for p, cot, d1, d2 in zip(params, cots, got, again):
        want = torch.zeros_like(p).index_add_(0, rows.perm, cot)
        err, scale = (d1 - want).abs().max().item(), want.abs().max().item()
        if not (torch.equal(d1, d2) and err <= 1e-6 * scale):
            raise AssertionError(f"the bin-major gather's fold of a {tuple(p.shape)} gradient: repeatable "
                                 f"{torch.equal(d1, d2)}, err against index_add_ {err:.3e} (max|ref| {scale:.3e})")
    with torch.no_grad():
        gather_ms = device_ms(lambda: rows(*params))
    return gather_ms, device_ms(fold), cuda_time_ms(fold)


# ROIPool's tolerance: the kernels sum a bin (forwards) and an element's
# terms (backwards) in another order than the einsum forms, f32 rounding of
# sums of tens of terms: 1e-5 of the largest magnitude
ROIPOOL_TOL = 1e-5


@contextlib.contextmanager
def einsum_roi_pool_linear():
    """the tracker's fused ROIPool head as its einsum form for the duration
    (roi_pool_linear as it was before its kernels: ROIPool's bounds, then
    roi_pool_linear_plain; its backward autograd's through the einsums):
    the same model and inputs with the parent's arithmetic, so a profile
    splits the tracker stage before and after in one call."""
    from detect_to_track_tpu_torch.models import correlation_tracker
    from detect_to_track_tpu_torch.ops import pooling

    def einsum_form(g, rois, r_hw):
        bounds = pooling.psroi_bounds(rois, r_hw, g.shape[1], g.shape[2], clamp_corner=True)
        return pooling.roi_pool_linear_plain(g, bounds)

    kernels = correlation_tracker.roi_pool_linear
    correlation_tracker.roi_pool_linear = einsum_form
    try:
        yield
    finally:
        correlation_tracker.roi_pool_linear = kernels


def roipool_rois(seed, b, r):
    """psroi_rois with every 8th roi (from the 6th) larger than the frame
    (centre in it, sides 1-4 of it), as the random-weight detector's
    detections are (the slice phase counts them): ROIPool's corner clamp
    puts up to the whole map into their bin (0, 0)."""
    import numpy as np
    import torch

    rois = psroi_rois(seed, b, r)
    rng = np.random.default_rng(seed + 1)
    n = rois[:, 5::8].shape[1]
    big = np.concatenate([rng.uniform(0.0, 1.0, (b, n, 2)), rng.uniform(1.0, 4.0, (b, n, 2))], -1)
    rois[:, 5::8] = torch.from_numpy(big.astype(np.float32)).cuda()
    return rois


def roipool_bound_ms(bounds, h, w, width, linear):
    """least times of ROIPool's forward and backward on these bounds (B, R,
    4, k), `width` values a pixel of a bin (the fused head's O outputs, the
    materialized pooling's C channels). Forward: each map element that some
    roi's bin holds read once (the fused head's map holds one a pixel, bin
    and output; the materialized map one a pixel and channel), the outputs
    written once, the bounds read once; against an add per pixel of a
    non-empty bin and value and a division per bin and value (and the fused
    head's sum of the k^2 bins). Backward: the cotangent read once, the
    map's gradient written once, the bounds read once; against a division
    and an add per pixel of a non-empty bin and value (f32). Returns
    ((ms, bound_by) forward, (ms, bound_by) backward)."""
    import torch

    b, r, _, k = bounds.shape
    pixels, rmask, cmask = _psroi_bin_pixels(bounds, h, w)
    cover = torch.einsum("brih,brjw->bijhw", rmask, cmask) > 0  # (B, k, k, H, W)
    held = int(cover.sum() if linear else cover.any(2).any(1).sum()) * width
    outputs = b * r * width * (1 if linear else k * k)
    maps = b * h * w * width * (k * k if linear else 1)
    fwd_ops = float(pixels.sum()) * width + b * r * k * k * width * (2 if linear else 1)
    bwd_ops = 2.0 * float(pixels.sum()) * width

    def bound(nbytes, ops):
        return max((4 * (nbytes + bounds.numel()) / HBM_BYTES_PER_S * 1e3, "bytes"), (ops / F32_FLOPS * 1e3, "operations"))

    return bound(held + outputs, fwd_ops), bound(outputs + maps, bwd_ops)


def phase_roipool(smi: str):
    """ROIPool's kernels (ops/csrc/roipool.cu) at the main paths' shapes
    (the 38x75 maps, k 7, proposal-like rois with rois past the border,
    empty bins and rois larger than the frame (roipool_rois), ROIPool's
    corner-clamped bounds): the tracker's fused head
    (g (B, H, W, k, k, 4) f32) at a pair call's BATCH_SIZE pairs and
    MAX_DETS rois and at a training step's MAX_LABELS rois, and the
    materialized pooling (the oracle head's 2 x 512 + 3 x 289 = 1891
    channels, contiguous NHWC maps, its cotangent in the head's (C, k, k)
    order) at BATCH_SIZE pairs and MAX_DETS rois. Each forward against its
    plain einsum form and each backward against autograd through it within
    ROIPOOL_TOL of the largest magnitude, empty bins (the fused head: rois
    with every bin empty) exactly 0, the backwards bitwise the same on a
    repeat and through the ops' autograd, roi_pool / roi_pool_linear
    bitwise the ops. Each kernel and each plain version timed by the card's
    kernel time a call (torch.profiler) and by CUDA events around
    back-to-back calls (the host's pace where it is slower), beside the
    kernel's bound, and the peak MiB a forward and backward take (kernels
    and plain). Outside the main-path launch count. Returns {kernel: row of
    the kernels line} and the largest absolute errors."""
    import torch

    from detect_to_track_tpu_torch.config import load_config
    from detect_to_track_tpu_torch.models import DetectTrackModule
    from detect_to_track_tpu_torch.ops import pooling

    cfg = load_config(str(ROOT / "cfg" / "default.yaml"))
    fh, fw = cfg.fm_shape
    p, k, n_out = cfg.BATCH_SIZE, cfg.K, 4
    c = 2 * DetectTrackModule.rpn_channels + 3 * (2 * cfg.D_MAX + 1) ** 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    log(f"[roipool] {p} pairs x {fh}x{fw}, k {k}: the fused head's {n_out} outputs at {cfg.max_dets} rois (a pair "
        f"call) and {cfg.MAX_LABELS} (a training step), the materialized pooling's {c} channels at "
        f"{cfg.max_dets} rois; card: {smi}")
    rows, errs = {}, {}

    def checked(what, fwd, plain_fwd, bwd, op, public, x, cot, empty, stride_cot):
        """forward and backward against the plain form and autograd through it;
        returns the errors (forward, backward)."""
        got = fwd()
        ref = plain_fwd(x)
        xg = x.detach().requires_grad_()
        (want,) = torch.autograd.grad(plain_fwd(xg), xg, cot)
        d1, d2 = bwd(cot), bwd(cot)
        x2 = x.detach().requires_grad_()
        out = op(x2)
        out.backward(cot)
        torch.cuda.synchronize()
        f_scale, b_scale = ref.abs().max().item(), want.abs().max().item()
        f_err, b_err = (got - ref).abs().max().item(), (d1 - want).abs().max().item()
        zeros = bool(empty.any()) and bool((got[empty] == 0).all())
        same = torch.equal(d1, d2) and torch.equal(x2.grad, d1) and torch.equal(out, got) and torch.equal(public(), got)
        log(f"[roipool] {what}: forward err {f_err:.2e} (max|ref| {f_scale:.2e}), backward err {b_err:.2e} (max|ref| "
            f"{b_scale:.2e}; cotangent {stride_cot}); {int(empty.sum())} empty outputs exactly 0 {zeros}; backward "
            f"bitwise on a repeat and through the op's autograd, the public function bitwise the op {same}")
        if not (f_err <= ROIPOOL_TOL * f_scale and b_err <= ROIPOOL_TOL * b_scale and zeros and same):
            raise AssertionError(f"ROIPool kernels, {what}: forward err {f_err:.3e}, backward err {b_err:.3e}, empty "
                                 f"outputs 0 {zeros}, repeatable and = the op's {same}")
        return f_err, b_err

    def timed(what, kernel_fwd, kernel_bwd, plain_fwd, plain_bwd, op_step, plain_step, bounds, width, linear):
        (fb, fby), (bb, bby) = roipool_bound_ms(bounds, fh, fw, width, linear)
        t = {name: (device_ms(fn), cuda_time_ms(fn, iters=20 if name.startswith("kernel") else 5))
             for name, fn in (("kernel forward", kernel_fwd), ("kernel backward", kernel_bwd),
                              ("plain forward", plain_fwd), ("plain backward", plain_bwd))}
        mem_kernel, mem_plain = _peak_mib(op_step), _peak_mib(plain_step)
        log(f"[roipool] {what}: " + ", ".join(f"{name} {dev:.4f} ms (events {ev:.4f})" for name, (dev, ev) in t.items())
            + f"; bounds forward {fb:.6f} ms ({fby}), backward {bb:.6f} ms ({bby}); forward + backward peak "
            f"{mem_kernel:.1f} MiB (plain {mem_plain:.1f} MiB)")
        return (dict(ms=t["kernel forward"][0], plain_ms=t["plain forward"][0], bound_ms=fb, bound_by=fby),
                dict(ms=t["kernel backward"][0], plain_ms=t["plain backward"][0], bound_ms=bb, bound_by=bby))

    # ---- the fused head: a pair call's rois, then a training step's ----
    for label, r in (("pair call", cfg.max_dets), ("training step", cfg.MAX_LABELS)):
        rois = roipool_rois(1, p, r)
        bounds = pooling.psroi_bounds(rois, k, fh, fw, clamp_corner=True)
        g = torch.randn(p, fh, fw, k, k, n_out, device="cuda", generator=gen)
        cot = torch.randn(p, r, n_out, device="cuda", generator=gen)
        i0, i1, j0, j1 = bounds.unbind(2)
        empty = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0).all(-1).all(-1)[..., None].expand(p, r, n_out)
        f_err, b_err = checked(
            f"fused head, {label} ({r} rois)", lambda: pooling.roipool_linear_fwd_cuda(g, bounds),
            lambda x: pooling.roi_pool_linear_plain(x, bounds),
            lambda y: pooling.roipool_linear_bwd_cuda(y, bounds, fh, fw),
            lambda x: torch.ops.d2t.roipool_linear_fwd(x, bounds), lambda: pooling.roi_pool_linear(g, rois, k),
            g, cot, empty, "contiguous")
        errs["roipool_linear_fwd"] = max(errs.get("roipool_linear_fwd", 0.0), f_err)
        errs["roipool_linear_bwd"] = max(errs.get("roipool_linear_bwd", 0.0), b_err)

        def step(pool):
            y = g.detach().requires_grad_()
            pool(y).backward(cot)

        fwd_row, bwd_row = timed(
            f"fused head, {label} ({r} rois)", lambda: pooling.roipool_linear_fwd_cuda(g, bounds),
            lambda: pooling.roipool_linear_bwd_cuda(cot, bounds, fh, fw),
            lambda: pooling.roi_pool_linear_plain(g, bounds),
            lambda: pooling.roipool_linear_bwd_ref(cot, bounds, fh, fw),
            lambda: step(lambda y: torch.ops.d2t.roipool_linear_fwd(y, bounds)),
            lambda: step(lambda y: pooling.roi_pool_linear_plain(y, bounds)), bounds, n_out, True)
        # the kernels line: the forward at a pair call (serving, clips), the
        # backward at a training step (the only path that runs it)
        if label == "pair call":
            rows["roipool_linear_fwd"] = fwd_row
        else:
            rows["roipool_linear_bwd"] = bwd_row
        del g, cot

    # ---- the materialized pooling, the oracle head's features ----
    r = cfg.max_dets
    rois = roipool_rois(2, p, r)
    bounds = pooling.psroi_bounds(rois, k, fh, fw, clamp_corner=True)
    fm = torch.randn(p, fh, fw, c, device="cuda", generator=gen)
    # the head's cotangent: a (C, k, k)-ordered gradient viewed as (k, k, C)
    cot = torch.randn(p, r, c, k, k, device="cuda", generator=gen).permute(0, 1, 3, 4, 2)
    i0, i1, j0, j1 = bounds.unbind(2)
    empty = ((i1 - i0)[..., :, None] * (j1 - j0)[..., None, :] <= 0)[..., None].expand(p, r, k, k, c)
    f_err, b_err = checked(
        f"materialized pooling ({c} channels, {r} rois)", lambda: pooling.roipool_fwd_cuda(fm, bounds),
        lambda x: pooling.roi_pool_plain(x, bounds), lambda y: pooling.roipool_bwd_cuda(y, bounds, fh, fw),
        lambda x: torch.ops.d2t.roipool_fwd(x, bounds), lambda: pooling.roi_pool(fm, rois, k), fm, cot, empty,
        "the head's (C, k, k) order")
    errs["roipool_fwd"], errs["roipool_bwd"] = f_err, b_err

    def mat_step(pool):
        y = fm.detach().requires_grad_()
        pool(y).backward(cot)

    fwd_row, bwd_row = timed(
        f"materialized pooling ({c} channels, {r} rois)", lambda: pooling.roipool_fwd_cuda(fm, bounds),
        lambda: pooling.roipool_bwd_cuda(cot, bounds, fh, fw), lambda: pooling.roi_pool_plain(fm, bounds),
        lambda: pooling.roipool_bwd_ref(cot, bounds, fh, fw),
        lambda: mat_step(lambda y: torch.ops.d2t.roipool_fwd(y, bounds)),
        lambda: mat_step(lambda y: pooling.roi_pool_plain(y, bounds)), bounds, c, False)
    rows["roipool_fwd"], rows["roipool_bwd"] = fwd_row, bwd_row
    del fm, cot
    torch.cuda.empty_cache()
    return rows, errs


def device_ms(fn, iters: int = 10) -> float:
    """the card's kernel time a call of fn, by torch.profiler (the sum of its
    kernels' device times over iters warm calls), whatever the host's pace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == cuda) / iters / 1e3


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
    ops = ("d2t::corr_fwd", "d2t::corr_bwd_fm0", "d2t::corr_bwd_fm1", "d2t::nms_mask", "d2t::psroi_fwd",
           "d2t::psroi_bwd", "d2t::roipool_linear_fwd", "d2t::roipool_linear_bwd", "d2t::roipool_fwd",
           "d2t::roipool_bwd")  # nested in stages (the tracker's `d2t::roi_pool_linear` range prints as a stage)
    stages = [e for e in events if e.device_type != cuda and e.key.startswith("d2t::") and e.key not in ops]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)  # noqa: E731
    busy = sum(dev_us(e) for e in kernels)
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms (profiled), device busy "
        f"{busy / 1e3:.1f} ms = {100 * busy / wall_us:.1f}% of wall, {len(kernels)} kernel names")
    for e in stages:
        log(f"[profile]   stage {e.key[5:]:<16s} device {e.device_time_total / 1e3:8.3f} ms "
            f"{100 * e.device_time_total / max(busy, 1e-9):5.1f}% of busy, host {e.cpu_time_total / 1e3:8.3f} ms")
    for e in events:
        if e.device_type != cuda and e.key in ops:
            log(f"[profile]   op {e.key:<19s} device {e.device_time_total / 1e3:8.3f} ms in {e.count} calls, host "
                f"{e.cpu_time_total / 1e3:8.3f} ms (inside the stages above)")
    bwd = [e for e in events if e.device_type != cuda and e.key.startswith("autograd::engine::evaluate_function")]
    if bwd:
        bwd_us = sum(e.device_time_total for e in bwd)
        log(f"[profile]   autograd backward nodes device {bwd_us / 1e3:8.3f} ms "
            f"{100 * bwd_us / max(busy, 1e-9):5.1f}% of busy, {sum(e.count for e in bwd)} nodes")
    host_reads = sum(e.count for e in events if e.key == "aten::equal")
    log(f"[profile]   torch.equal host reads (the plain NMS loop's iterations; the kernel has none): {host_reads}")
    # torch's sort-based gather backward: PSROIPool's channel-gather
    # backward before its kernel, and any other advanced-index backward
    scatter = [e for e in kernels if "indexing_backward_kernel" in e.key]
    log(f"[profile]   indexing_backward_kernel: {sum(dev_us(e) for e in scatter) / 1e3:.3f} ms in "
        f"{sum(e.count for e in scatter)} launches")
    ranked = sorted(kernels, key=dev_us, reverse=True)
    # the top kernels, then the port's own kernels wherever they rank
    for rank, e in enumerate(ranked):
        if rank < top or any(name in e.key for name in ("corr_", "viterbi", "nms_", "psroi_", "roipool_")):
            log(f"[profile]   {dev_us(e) / 1e3:8.3f} ms {100 * dev_us(e) / max(busy, 1e-9):5.1f}%  x{e.count:<4d} "
                f"#{rank + 1:<3d} {e.key[:90]}")


def clip_like_problem(seed, t, d):
    """a stand-in for the clip phase's score matrices: every link live, each
    score two saturated confidences plus psi (2.0, or 3.0 on 7.8% of links,
    the clip's share), init scores 1.0."""
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = (2.0 + (rng.random((t - 1, d, d)) < 0.078)).astype(np.float32)
    return seq, np.ones(d, np.float32)


# the linking-only clip past the shared-memory bitmap: the bitmap and the
# path of 3,100 frames at D 512 take 3,100 x 17 words, past the 3,041
# frames that fit beside the per-slot state; its score matrices take 3.3 GB
# and its `nodes` output (T * D, T) int32 19.7 GB, twice with the plain
# version's
PAST_CAP_FRAMES, PAST_CAP_SLOTS = 3100, 512


def sparse_link_problem(seed, t, d):
    """(T-1, D, D) scores on the card, all -inf but for 8 chains of 6
    dyadic links (one into the last frame, one from frame 0, the others
    anywhere), and 8 finite init scores: few paths, so the plain version
    runs few extractions."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    seq = torch.full((t - 1, d, d), -math.inf, device="cuda")
    for s0 in [t - 7, 0, *rng.integers(0, t - 7, size=6)]:
        nodes = rng.integers(0, d, size=7)
        for i in range(6):
            seq[s0 + i, nodes[i], nodes[i + 1]] = float(rng.integers(1, 8)) / 4
    init = torch.full((d,), -math.inf, device="cuda")
    init[torch.from_numpy(rng.integers(0, d, size=8)).cuda()] = torch.from_numpy(
        rng.integers(0, 4, size=8) / 4).float().cuda()
    return seq, init


def linker_past_shared_bitmap(t=PAST_CAP_FRAMES, d=PAST_CAP_SLOTS):
    """a linking-only clip whose removed bitmap and path do not fit in
    shared memory, so the wrapper passes the global scratch by the size
    rule (a kernel that kept them there refused such a clip): the kernel
    against its plain version, bitwise. Times a second, warm call (CUDA
    events; its outputs and scratch come from the allocator's cache, so the
    time is the launch's) beside the first call's (allocations
    included)."""
    import torch

    from detect_to_track_tpu_torch import viterbi_device as vd

    if vd._bitmap_in_smem(vd._viterbi_lib(), t - 1, d):
        raise AssertionError(f"{t} frames at D {d} should not fit the shared-memory bitmap")
    seq, init = sparse_link_problem(0, t, d)
    seq_before = seq.clone()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(2):
        got = None  # the first call's outputs go back to the cache
        start.record()
        got = vd.viterbi_multi_link_cuda(seq, init)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    call_ms, ms = times
    if not torch.equal(seq.view(torch.int32), seq_before.view(torch.int32)):
        raise AssertionError("the linker kernel changed its input score matrices")
    del seq_before
    t0 = time.perf_counter()
    ref = vd.viterbi_multi_link_ref(seq, init)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if not _same_paths(got, ref):
        raise AssertionError(f"the linker kernel disagrees with its plain version at {t} frames, D {d}")
    paths = _trimmed(got)
    steps, full = linker_dp_steps([p[0] for p in paths])
    log(f"[clip] linker {t - 1}x{d}x{d} (past the shared-memory bitmap: the global scratch by the size rule; all -inf "
        f"but 8 chains of 6 links): kernel = plain version (n_paths {len(paths)}, spans, nodes, bitwise scores), "
        f"input unchanged; {sum(e > 0 for (_, e), _, _ in paths)} extractions, {steps} DP steps run; ms={ms:.1f} "
        f"(warm call) {linker_stream(steps, d, ms)} first call ms={call_ms:.1f} (allocations included) "
        f"plain_ms={plain_ms:.1f}")
    del seq, init, got, ref
    torch.cuda.empty_cache()


def phase_linker(d: int = 128):
    """the linker kernel alone (`--linker`): a clip-like 22-frame problem at
    D d against the plain version (the bitmap in shared memory and forced
    into the global scratch), then linker_cases(d)."""
    import torch

    from detect_to_track_tpu_torch import viterbi_device as vd

    seq, init = (torch.from_numpy(x).cuda() for x in clip_like_problem(0, CLIP_FRAMES, d))
    got = checked_linker(seq, init)
    t = time.perf_counter()
    ref = vd.viterbi_multi_link_ref(seq, init)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t) * 1e3
    if not _same_paths(got, ref):
        raise AssertionError("the linker kernel disagrees with its plain version on the clip-like problem")
    ms = cuda_time_ms(lambda: vd.viterbi_multi_link_cuda(seq, init), iters=10, warmup=2)
    glob, glob_ms = global_bitmap_linker(seq, init, iters=10)
    if not _same_paths(glob, ref):
        raise AssertionError("the linker kernel with a global bitmap disagrees with its plain version (clip-like)")
    steps, full = linker_dp_steps([p[0] for p in _trimmed(got)])
    log(f"[linker] {CLIP_FRAMES - 1}x{d}x{d} clip-like (scores 2 or 3, all live): kernel = plain version, input "
        f"unchanged, bitmap in shared memory and in the global scratch; {int(got.n_paths)} paths, {steps} DP steps "
        f"run ({full} from step 0); ms={ms:.4f} {linker_stream(steps, d, ms)} global-bitmap ms={glob_ms:.4f} "
        f"plain_ms={plain_ms:.1f}")
    linker_cases(d)


def _anchor_boxes(seed, b, k, n_valid):
    """(b, k, 4) boxes as the RPN's decode spreads them, without the model:
    k of cfg/default.yaml's anchors (38x75 map, its areas and ratios) in a
    random order a frame, moved by small random offsets; the first n_valid
    slots of each frame valid."""
    import numpy as np
    import torch

    from detect_to_track_tpu_torch.anchors import build_anchors
    from detect_to_track_tpu_torch.config import Config
    from detect_to_track_tpu_torch.encoding import frcnn_box_decode

    cfg = Config()
    anchors = torch.from_numpy(np.array(build_anchors((38, 75), cfg.ANCHOR_AREAS, cfg.ANCHOR_ASPECT_RATIOS)))
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(np.stack([rng.permutation(len(anchors))[:k] for _ in range(b)]))
    offsets = torch.from_numpy(rng.standard_normal((b, k, 4)).astype(np.float32) * 0.1)
    boxes = frcnn_box_decode(anchors[idx], offsets).float().contiguous()
    valid = torch.arange(k)[None].repeat(b, 1) < n_valid
    return boxes.cuda(), valid.cuda()


def nms_sass_report(lib_path) -> dict:
    """the SASS (cuobjdump) of each nms_mask_kernel in an NMS kernel library:
    its instructions, and its hot loop (the backward branch's body with the
    most instructions) with its count of FMUL (one per IoU: the
    intersection's product), FCHK (one per IEEE division) and each opcode.
    Per IoU = the loop's instructions over its FMULs. Returns {kernel:
    {"instructions", "loop", "fmul", "fchk", "per_iou", "ops"}}."""
    import re

    from detect_to_track_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    funcs, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1) if "nms_mask_kernel" in m.group(1) else None
            if current:
                funcs[current] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if current and m:
            funcs[current].append((int(m.group(1), 16), m.group(2).strip()))
    names = _demangle(list(funcs))
    report = {}
    for sym, ins in funcs.items():
        best = []
        for addr, text in ins:
            br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if br and int(br.group(1), 16) < addr:  # a backward branch closes a loop
                body = [t for a, t in ins if int(br.group(1), 16) <= a <= addr]
                best = body if len(body) > len(best) else best
        ops = {}
        for text in best:
            op = text.split()[1] if text.startswith("@") else text.split()[0]
            ops[op] = ops.get(op, 0) + 1
        fmul = sum(n for op, n in ops.items() if op.startswith("FMUL"))
        report[_kernel_short(names[sym])] = {
            "instructions": len(ins), "loop": len(best), "fmul": fmul,
            "fchk": sum(n for op, n in ops.items() if op.startswith("FCHK")),
            "per_iou": len(best) / fmul if fmul else None, "ops": ops}
    return report


def phase_nms_design(smi: str):
    """the NMS kernel alone (`--nms`), without the model: at 8 x 3072 slots
    (3000 eligible) on clustered random boxes and on the default anchors
    moved by random offsets, and at 2 x 4096 (all valid, dense clusters),
    IoU 0.3 and 0.5, bitwise the plain loop, with the op's time, each
    launch's and the IoU launch's alone against its own bound; the IoU
    launch's words bitwise compute_ious > t (also at IoUs and a step below,
    and with NaN / inf boxes mixed in); the SASS of the IoU kernel."""
    import torch

    from detect_to_track_tpu_torch.ops import _build, nms

    for name, info in nms_sass_report(_build.library_path("nms")).items():
        top = ", ".join(f"{op} {n}" for op, n in sorted(info["ops"].items(), key=lambda x: -x[1])[:12])
        per_iou = f"{info['per_iou']:.2f}" if info["per_iou"] else "n/a"
        log(f"[nms-sass] {name}: {info['instructions']} instructions; hot loop {info['loop']} ({info['fmul']} FMUL, "
            f"{info['fchk']} FCHK): {per_iou} an IoU; {top}")
    cases = {"8 x 3072 (3000 eligible)": _nms_boxes(0, 8, 3072, 3000),
             "8 x 3072 anchors (3000 eligible)": _anchor_boxes(0, 8, 3072, 3000),
             "2 x 4096 (all valid, 64 a cluster)": _nms_boxes(4096, 2, 4096, 4096, 64)}
    for name, (boxes, valid) in cases.items():
        words = sum(nms_iou_bits_check(bx, thresholds_at_ious(boxes, iou)) for bx in (boxes, with_special_boxes(boxes))
                    for iou in (0.3, 0.5))
        for iou in (0.3, 0.5):
            ref = nms.nms_mask_ref(boxes, valid, iou)
            got = nms.nms_mask_cuda(boxes, valid, iou)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"the NMS kernel differs from the plain loop on {name} at IoU {iou}")
            ms = cuda_time_ms(lambda: nms.nms_mask_cuda(boxes, valid, iou))
            split = nms_launch_ms(lambda: nms.nms_mask_cuda(boxes, valid, iou))
            iou_ms, iou_bound, iou_by, n_ious = nms_iou_launch_ms(boxes, iou)
            log(f"[nms-design] {name}, IoU {iou}: = plain loop (bitwise), {int(ref.sum())} kept; "
                f"ms={ms:.4f} (per launch: {', '.join(f'{n} {t:.4f}' for n, t in split.items())}); IoU launch "
                f"alone {iou_ms:.4f} ms, bound {iou_bound:.6f} ({iou_by}), {iou_ms / iou_bound:.1f}x; IoU words "
                f"bitwise ({words} words checked); card: {smi}")


def main_nms() -> int:
    """`python3 chip_smoke.py --nms`: the device and build phases, then the
    NMS kernel alone, timed without the model. A quick check of
    an NMS change; the full run (no arguments) is the smoke test."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    phase_nms_design(smi)
    log(f"[done] nms phases passed in {time.perf_counter() - t_start:.1f} s")
    return 0


def main_linker() -> int:
    """`python3 chip_smoke.py --linker`: the device and build phases, then
    the linker kernel alone on linking-only cases (no model). A quick check
    of a linker change; the full run (no arguments) is the smoke test."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    phase_device()
    phase_build()
    phase_linker()
    log(f"[done] linker phases passed in {time.perf_counter() - t_start:.1f} s")
    return 0


def main_psroi() -> int:
    """`python3 chip_smoke.py --psroi`: the device and build phases, then
    PSROIPool's kernels alone at the R-FCN head's shapes, held against their
    plain versions and timed without the model. A quick check of a PSROIPool
    change; the full run (no arguments) is the smoke test."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    phase_psroi(smi)
    log(f"[done] psroi phases passed in {time.perf_counter() - t_start:.1f} s")
    return 0


def main_roipool() -> int:
    """`python3 chip_smoke.py --roipool`: the device and build phases, then
    ROIPool's kernels alone at the main paths' shapes, held against their
    plain versions and timed without the model. A quick check of a ROIPool
    change; the full run (no arguments) is the smoke test."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    phase_roipool(smi)
    log(f"[done] roipool phases passed in {time.perf_counter() - t_start:.1f} s")
    return 0


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not (ROOT / "detect_to_track_tpu_torch").is_dir():
        raise SystemExit("chip_smoke: run from a checkout of the repository (detect_to_track_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    phase_build()
    rows = phase_kernels(pairs=4)
    bwd_rows = phase_bwd_kernels(pairs=4)
    psroi_rows, psroi_errs = phase_psroi(smi)
    roipool_rows, roipool_errs = phase_roipool(smi)
    slice_launches, det = phase_slice(smi)
    nms_row = phase_nms(smi, det)
    export_launches = phase_export(smi, det)
    clip_launches, linker_row = phase_clip(smi, det)
    del det
    train_launches = phase_train(smi)
    trainer_launches = phase_trainer(smi)
    ddp_launches = phase_ddp(smi)
    options_launches = phase_options(smi)
    extra = {k: ddp_launches[k] + options_launches[k] for k in ddp_launches}
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
                     slice_launches["corr_fwd"] + export_launches["corr_fwd"] + clip_launches["corr_fwd"]
                     + train_launches["corr_fwd"] + trainer_launches["corr_fwd"] + extra["corr_fwd"]),
        "corr_bwd_fm0": ("detect_to_track_tpu_torch/ops/csrc/corr_bwd.cu", "detect_to_track_tpu/ops/correlation.py:187",
                         train_launches["corr_bwd_fm0"] + trainer_launches["corr_bwd_fm0"] + extra["corr_bwd_fm0"]),
        # one kernel for both TPU dFM1 kernels: K3 (:378, H <= 40) and K4 (:267)
        "corr_bwd_fm1": ("detect_to_track_tpu_torch/ops/csrc/corr_bwd.cu", "detect_to_track_tpu/ops/correlation.py:378,267",
                         train_launches["corr_bwd_fm1"] + trainer_launches["corr_bwd_fm1"] + extra["corr_bwd_fm1"]),
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
    # every path counts NMS launches: slice, export, clip, train, trainer,
    # ddp and options
    nms_launches = sum(x["nms_mask"] for x in (slice_launches, export_launches, clip_launches, train_launches,
                                                trainer_launches, extra))
    kernels.append({
        "name": "nms_mask",
        "route": "cuda",
        "source": "detect_to_track_tpu_torch/ops/csrc/nms.cu",
        "replaces": "detect_to_track_tpu/ops/nms.py:55 (nms_mask, an XLA while_loop, not a Pallas kernel)",
        "launches": nms_launches,
        "max_abs_err": nms_row["err"],
        "ms": nms_row["ms"],
        "plain_ms": nms_row["plain_ms"],
        "bound_ms": nms_row["bound_ms"],
        "bound_by": nms_row["bound_by"],
        "library_ms": None,
    })
    # every path counts PSROIPool launches: 2 forwards a batched call, served
    # call, clip chunk, validation batch and report pair; 2 forwards and 2
    # backwards a training step
    psroi_replaces = "detect_to_track_tpu/ops/pooling.py:154 (_ps_roi_pool_einsum, an XLA program of mask matmuls, "
    for name, what in (("psroi_fwd", "not a Pallas kernel)"),
                       ("psroi_bwd", "its backward: XLA's transposed matmuls and the channel gather's scatter)")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "detect_to_track_tpu_torch/ops/csrc/psroi.cu",
            "replaces": psroi_replaces + what,
            "launches": sum(x[name] for x in (slice_launches, export_launches, clip_launches, train_launches,
                                              trainer_launches, extra)),
            "max_abs_err": psroi_errs[name],
            "ms": sum(r["ms"] for r in psroi_rows[name]),
            "plain_ms": sum(r["plain_ms"] for r in psroi_rows[name]),
            "bound_ms": sum(r["bound_ms"] for r in psroi_rows[name]),
            "bound_by": psroi_rows[name][0]["bound_by"],
            "library_ms": None,
        })
    # every path counts the fused ROIPool head's launches: a forward a
    # batched call, served call, clip chunk, training step, validation batch
    # and report pair; a backward a training step
    for name, what in (("roipool_linear_fwd", "the tracker's fused head"),
                       ("roipool_linear_bwd", "its backward: XLA's transposed mask matmuls")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "detect_to_track_tpu_torch/ops/csrc/roipool.cu",
            "replaces": f"detect_to_track_tpu/ops/pooling.py:118 (roi_pool_linear, {what}; an XLA program of mask "
                        "matmuls, not a Pallas kernel)",
            "launches": sum(x[name] for x in (slice_launches, export_launches, clip_launches, train_launches,
                                              trainer_launches, extra)),
            "max_abs_err": roipool_errs[name],
            **{key: roipool_rows[name][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
        })
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-rank"]:
        sys.exit(ddp_rank_main(Path(sys.argv[2])))
    if sys.argv[1:2] == ["--linker"]:
        sys.exit(main_linker())
    if sys.argv[1:2] == ["--nms"]:
        sys.exit(main_nms())
    if sys.argv[1:2] == ["--psroi"]:
        sys.exit(main_psroi())
    if sys.argv[1:2] == ["--roipool"]:
        sys.exit(main_roipool())
    sys.exit(main())
