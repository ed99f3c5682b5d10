"""the port's CUDA kernels compiled for CPU threads with g++, for the CPU
tests (tests/test_torch_port_psroi.py, tests/test_torch_port_roipool.py).

A source under ops/csrc/ gets its local headers inlined and a shim in place
of `#include <cuda_runtime.h>`; everything from `extern "C" {` on (the nvcc
launchers) is replaced by the test's own launch code, which runs each grid
with `run_blocks` in this process's one thread: a block's CUDA threads one
after another (kernels with no barrier and no warp intrinsic) or as fibers
(ucontext), switched in round robin: __syncthreads a barrier of the block's
fibers, __syncwarp one of the warp's 32, __ballot_sync and the shuffles
(__shfl_sync, __shfl_up_sync, __shfl_xor_sync) a slot a lane between two
arrivals there; dynamic shared memory a static
16-byte aligned buffer (`extern __shared__` declarations rewritten), static
`__shared__` arrays function statics, __ldg a plain load, float4 a struct;
built without FMA contraction (the kernels have no product to contract).
"""

import ctypes
import re
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "detect_to_track_tpu_torch" / "ops" / "csrc"

CUDA_ON_CPU = r"""
#include <ucontext.h>

#include <cstring>
#include <functional>
#include <memory>
#include <vector>
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim;  // the running fiber's
struct Fiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  bool done = false;
};
inline ucontext_t g_main;
inline Fiber* g_cur;
inline std::function<void()> g_body;
inline void fiber_entry() {
  g_body();
  g_cur->done = true;
}
inline void fiber_yield() { swapcontext(&g_cur->ctx, &g_main); }
struct Barrier {
  int n = 0, count = 0;
  unsigned gen = 0;
};
inline void barrier_wait(Barrier& b) {
  const unsigned gen = b.gen;
  if (++b.count == b.n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  while (b.gen == gen) fiber_yield();
}
inline Barrier g_block_bar, g_warp_bar[32];
inline unsigned g_warp_slot[32][32];
inline unsigned long long g_warp_val[32][32];
inline void __syncthreads() { barrier_wait(g_block_bar); }
inline void __syncwarp() { barrier_wait(g_warp_bar[threadIdx.x / 32]); }
inline unsigned __ballot_sync(unsigned, int p) {
  const unsigned wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  g_warp_slot[wp][lane] = p ? 1u << lane : 0u;
  barrier_wait(g_warp_bar[wp]);
  unsigned v = 0;
  for (int l = 0; l < 32; ++l) v |= g_warp_slot[wp][l];
  barrier_wait(g_warp_bar[wp]);
  return v;
}
// the value (of at most 8 bytes) that lane src of the warp passed
template <typename T>
inline T warp_exchange(T v, int src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long));
  const unsigned wp = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::memcpy(&g_warp_val[wp][lane], &v, sizeof(T));
  barrier_wait(g_warp_bar[wp]);
  T r;
  std::memcpy(&r, &g_warp_val[wp][src], sizeof(T));
  barrier_wait(g_warp_bar[wp]);
  return r;
}
template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int mask) { return warp_exchange(v, (threadIdx.x % 32) ^ mask); }
template <typename T>
inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  return warp_exchange(v, lane >= delta ? lane - delta : lane);
}
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) { return warp_exchange(v, src); }
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
struct int4 {
  int x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
template <typename T>
inline T __ldg(const T* p) { return *p; }
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __shared__ static
alignas(16) inline float g_smem[1 << 16];
"""

# the fiber runner: grid, threads a block, fibers or not, the kernel call
RUN_BLOCKS = r"""
template <typename F>
void run_blocks(dim3 grid, int nth, bool fibers, F f) {
  constexpr size_t kStack = 1 << 16;
  blockDim = dim3(nth);
  g_body = f;
  std::vector<Fiber> fs(fibers ? nth : 0);
  for (auto& fb : fs) fb.stack.reset(new char[kStack]);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        if (!fibers) {
          for (int t = 0; t < nth; ++t) {
            threadIdx = dim3(t);
            f();
          }
          continue;
        }
        g_block_bar = Barrier{nth};
        for (int wp = 0; wp < nth / 32; ++wp) g_warp_bar[wp] = Barrier{32};
        for (auto& fb : fs) {
          fb.done = false;
          getcontext(&fb.ctx);
          fb.ctx.uc_stack.ss_sp = fb.stack.get();
          fb.ctx.uc_stack.ss_size = kStack;
          fb.ctx.uc_link = &g_main;
          makecontext(&fb.ctx, fiber_entry, 0);
        }
        for (int live = nth; live > 0;)
          for (int t = 0; t < nth; ++t)
            if (!fs[t].done) {
              g_cur = &fs[t];
              threadIdx = dim3(t);
              swapcontext(&g_main, &fs[t].ctx);
              live -= fs[t].done;
            }
      }
}
"""

# the edits of the sources' text (each must be found: a source that changes
# them needs this emulation updated)
EDITS = [
    ("#include <cuda_runtime.h>\n", CUDA_ON_CPU),
    ("extern __shared__ float smem[];", "float* smem = g_smem;"),
    ("extern __shared__ int bd[];", "int* bd = reinterpret_cast<int*>(g_smem);"),
    ("namespace {", ""),
    ("}  // namespace", ""),
]


def source_on_cpu(name: str, launch: str) -> str:
    """ops/csrc/<name> for g++: its `#include "*.cuh"` headers inlined, EDITS
    applied, the launchers replaced by RUN_BLOCKS and `launch`."""
    src = (CSRC / name).read_text()
    src = re.sub(r'#include "(\w+\.cuh)"\n', lambda m: (CSRC / m.group(1)).read_text(), src)
    for old, new in EDITS:
        assert old in src, f"{name} changed: update this emulation ({old.strip()!r} not found)"
        src = src.replace(old, new)
    return src[: src.index('extern "C" {')] + RUN_BLOCKS + launch


def build(name: str, launch: str, out: Path) -> ctypes.CDLL:
    """ops/csrc/<name> with the test's `launch` code built for CPU threads
    into the directory `out`, loaded."""
    cpp = out / (Path(name).stem + "_cpu.cpp")
    cpp.write_text(source_on_cpu(name, launch))
    lib = out / (Path(name).stem + "_cpu.so")
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(lib), str(cpp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))
