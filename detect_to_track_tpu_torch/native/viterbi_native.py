"""ctypes loader for the native multi-path Viterbi linker (viterbi.cpp).

The library is built with g++ at first use into `build/native/` at the
repository root; its file name carries a hash of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded. When
the build fails, `multi_link` raises: a caller that wants the numpy linker
asks for it with `use_native=False` (viterbi.viterbi_multi_link).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "viterbi.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libviterbi_native_{h.hexdigest()[:16]}.so"


def _build() -> ctypes.CDLL:
    so_path = library_path()
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run(
                ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True
            )
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build {_SRC.name}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.d2t_viterbi_multi_link.restype = ctypes.c_int64
    lib.d2t_viterbi_multi_link.argtypes = [
        f64p, i64p, ctypes.c_int64, f64p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, f64p, i64p, i64p,
    ]
    return lib


def load() -> ctypes.CDLL:
    """the loaded library, built first if needed; raises RuntimeError when
    it cannot be built."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build()
    return _LIB


def multi_link(
    score_seq: List[np.ndarray], init_scores: List[float]
) -> List[Tuple[Tuple[int, int], float, List[int]]]:
    """native viterbi_multi_link; same contract as
    viterbi.viterbi_multi_link."""
    lib = load()

    n_trans = len(score_seq)
    dims = np.asarray([len(init_scores)] + [m.shape[1] for m in score_seq], np.int64)
    if not all(m.shape == (dims[t], dims[t + 1]) for t, m in enumerate(score_seq)):
        raise ValueError("inconsistent score matrix shapes")
    trans_flat = (
        np.concatenate([np.ascontiguousarray(m, np.float64).ravel() for m in score_seq])
        if n_trans
        else np.zeros(0, np.float64)
    )
    init = np.asarray(init_scores, np.float64)

    total_nodes = int(dims.sum())
    max_paths = max(total_nodes, 1)
    nodes_cap = max(total_nodes * (n_trans + 1), 1)

    out_start = np.zeros(max_paths, np.int64)
    out_end = np.zeros(max_paths, np.int64)
    out_scores = np.zeros(max_paths, np.float64)
    out_nodes = np.zeros(nodes_cap, np.int64)
    out_offsets = np.zeros(max_paths, np.int64)

    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)

    def as_f64(a):
        return a.ctypes.data_as(f64p)

    def as_i64(a):
        return a.ctypes.data_as(i64p)

    n = lib.d2t_viterbi_multi_link(
        as_f64(trans_flat), as_i64(dims), ctypes.c_int64(n_trans), as_f64(init),
        ctypes.c_int64(max_paths), ctypes.c_int64(nodes_cap),
        as_i64(out_start), as_i64(out_end), as_f64(out_scores), as_i64(out_nodes), as_i64(out_offsets),
    )
    if n < 0:
        raise RuntimeError("native viterbi capacity overflow")

    results = []
    for i in range(n):
        start, end = int(out_start[i]), int(out_end[i])
        o = int(out_offsets[i])
        results.append(((start, end), float(out_scores[i]), out_nodes[o : o + end - start + 1].tolist()))
    return results
