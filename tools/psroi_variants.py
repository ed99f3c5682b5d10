"""time variants of PSROIPool's kernels (ops/csrc/psroi.cu) on the card.

Each variant is the source (its header bin_pool.cuh inlined) with some of
its tuning constants replaced (`constexpr int kName = value;`), built with nvcc into
build/psroi_variants/ and called through ctypes at the `psroi` phase's
shapes (8 frames, 38x75, 256 proposal-like rois, k 7; the class head's 31
and the box head's 4 targets; contiguous NHWC bin-major maps). For each
head and variant it prints the forward's and the backward's ms (CUDA
events, 100 launches), the backward's ms with rois that hold no pixel
("no hit": every row bin held, column bins past the map) and with rois
past the map ("no row": no bin holds a row), the errors against the plain
versions and whether the backward is bitwise the first variant's.

    python tools/psroi_variants.py [variant ...]

Needs a CUDA card and nvcc; imports no JAX.
"""

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "psroi_variants"

# name -> constants replaced in psroi.cu; "base" is the source as it is
VARIANTS = {
    "base": {},
    "fwd_warps4": {"kFwdThreads": 128},
    "fwd_warps16": {"kFwdThreads": 512},
    "fwd_batch4": {"kFwdBatch": 4},
    "fwd_batch16": {"kFwdBatch": 16},
    "bwd_pixels16": {"kBlockPixels": 16},
    "bwd_hits2": {"kHitBatch": 2},
    "bwd_hits8": {"kHitBatch": 8},
}


def source(constants: dict) -> str:
    """psroi.cu with its header bin_pool.cuh inlined, the constants replaced."""
    csrc = ROOT / "detect_to_track_tpu_torch" / "ops" / "csrc"
    src = (csrc / "psroi.cu").read_text().replace('#include "bin_pool.cuh"\n', (csrc / "bin_pool.cuh").read_text())
    for name, value in constants.items():
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", src)
        if n != 1:
            raise SystemExit(f"bin_pool.cuh has no constant {name}")
    return src


def build(name: str):
    from detect_to_track_tpu_torch.ops import _build

    cu = OUT / f"psroi_{name}.cu"
    cu.write_text(source(VARIANTS[name]))
    so = OUT / f"libpsroi_{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on variant {name}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    i64, i32, ptr = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.d2t_psroi_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [i64] * 4 + [ptr]
    lib.d2t_psroi_bwd.argtypes = [ptr] + [i64] * 5 + [ptr] * 4 + [i32] * 6 + [ptr]
    lib.d2t_psroi_bwd_blocks_per_sm.argtypes = [i32] * 2
    return name, lib


def main(names) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from detect_to_track_tpu_torch.ops import pooling

    if not torch.cuda.is_available():
        raise SystemExit("psroi_variants: needs a CUDA card")
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(build, names))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    b, fh, fw, r, k = 8, 38, 75, 256, 7
    bounds = pooling.psroi_bounds(chip_smoke.psroi_rois(0, b, r), k, fh, fw)
    idle = {label: pooling.psroi_bounds(torch.tensor(roi, device="cuda").expand(b, r, 4), k, fh, fw)
            for label, roi in (("no hit", [0.5, 1.4, 1.0, 0.2]), ("no row", [1.5, 0.5, 0.2, 0.2]))}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for head, n_t in (("class", 31), ("box", 4)):
        c = n_t * k * k
        fg = torch.randn(b, fh, fw, c, device="cuda", generator=gen)
        g = torch.randn(b, r, n_t, k, k, device="cuda", generator=gen)
        ref = pooling.ps_roi_pool_plain(fg, bounds, n_t)
        dref = pooling.psroi_bwd_ref(g, bounds, n_t, fh, fw)
        out = torch.empty(b, r, n_t, k, k, device="cuda")
        dfg = torch.empty(b, fh, fw, c, device="cuda")
        scaled = torch.empty(b, r, k, k, n_t, device="cuda")
        masks = torch.empty(b * (fh + fw) * r, dtype=torch.int32, device="cuda")
        first = None
        for name, lib in libs.items():
            def fwd():
                return lib.d2t_psroi_fwd(fg.data_ptr(), bounds.data_ptr(), out.data_ptr(), b, r, n_t, k, fh, fw,
                                         *fg.stride(), stream)

            def bwd(bd=bounds):
                return lib.d2t_psroi_bwd(g.data_ptr(), *g.stride(), bd.data_ptr(), scaled.data_ptr(),
                                         masks.data_ptr(), dfg.data_ptr(), b, r, n_t, k, fh, fw, stream)

            if fwd() or bwd():
                raise SystemExit(f"variant {name}: a launch failed")
            torch.cuda.synchronize()
            f_err = (out - ref).abs().max().item() / ref.abs().max().item()
            b_err = (dfg - dref).abs().max().item() / dref.abs().max().item()
            first = dfg.clone() if first is None else first
            same = torch.equal(dfg, first)
            times = [chip_smoke.cuda_time_ms(fwd, iters=100), chip_smoke.cuda_time_ms(bwd, iters=100)]
            times += [chip_smoke.cuda_time_ms(lambda bd=bd: bwd(bd), iters=100) for bd in idle.values()]
            print(f"{head:5s} {name:13s} forward {times[0]:.4f} ms (err {f_err:.1e} of max|ref|), backward "
                  f"{times[1]:.4f} ms (err {b_err:.1e}, bitwise the first {same}, "
                  f"{lib.d2t_psroi_bwd_blocks_per_sm(n_t, k)} blocks an SM; no hit {times[2]:.4f}, no row "
                  f"{times[3]:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
