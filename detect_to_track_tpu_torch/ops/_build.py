"""build the port's CUDA kernels with nvcc at first use, load them with ctypes.

Each source under `csrc/` becomes one shared library with a plain C
interface, compiled for Hopper (`sm_90a`) into `build/torch_kernels/` at the
repository root. The library's file name carries a hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. `build()` starts one nvcc per source, all at once.

Nothing here runs at import: the CPU tests import every module of the port
on machines that have neither nvcc nor a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# kernel library name -> source file under csrc/
SOURCES: Dict[str, str] = {"corr_fwd": "corr_fwd.cu", "corr_bwd": "corr_bwd.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """compile the named kernel libraries (all by default) that are not
    built yet, in parallel. Returns {name: {"path", "seconds", "log"}};
    `log` holds nvcc's register and shared-memory report (-Xptxas -v).
    Raises RuntimeError naming the source when nvcc fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    result: Dict[str, dict] = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            result[name] = {"path": target, "seconds": 0.0, "log": "cached"}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{SOURCES[name]} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        result[name] = {"path": target, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """the loaded kernel library `name`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib
