"""The CUDA source of the BA kernels, run on the CPU through a C++ shim.

``csrc/ba_kernels.cu`` is compiled with the host C++ compiler against a
small header that emulates the CUDA subset it uses: one ``std::thread`` per
CUDA thread, a block at a time, ``std::barrier`` for ``__syncthreads``,
``__syncwarp`` and the shuffles, a NaN-filled buffer of the card's size for
dynamic shared memory and statics for the rest, a
compiler builtin for the integer ``atomicAdd``, and a template for the
``<<<...>>>`` launches (blocks run one after another, in grid order). The
library is bound with
``ops/ba_cuda.bind`` and driven through the wrappers' own launch functions
(``_launch_blocks``, ``_launch_cost``) on CPU tensors, so the kernels'
indexing, tiling, staging and reductions are checked against the plain
twins without a card. It does not check what only the card shows (nvcc's
acceptance of the source, timing, FMA contraction): chip_smoke.py and
tests/test_torch_cuda.py do. Tolerances are those of
tests/test_torch_cuda.py: U/V/W atol 2e-5 * max|.|, gradients atol
3e-5 * max(1, max|.|), total cost rtol 3e-5, cost fragments rtol 2e-5
atol 1e-7; the cost kernel's f64 total against the f64 sum of its own
fragments at rtol 1e-12 (two orders of one f64 sum). Skips where no C++20
compiler is installed.
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from multicam_calibration_tpu_torch.models import lm_core
from multicam_calibration_tpu_torch.models.lm_core import _predict
from multicam_calibration_tpu_torch.ops import ba_cuda
from tests.test_torch_cuda import _assert_blocks_close, _problem

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multicam_calibration_tpu_torch", "csrc", "ba_kernels.cu",
)

SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::cos; using std::fabs; using std::sin; using std::sqrt;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local unsigned g_tid;  // the thread's linear index in its block
inline dim3 gridDim, blockDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorInvalidConfiguration = 9;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int g_last_error = 0;
inline int cudaGetLastError() { const int e = g_last_error; g_last_error = 0; return e; }
inline const char* cudaGetErrorString(int) { return "emulated"; }
// The dynamic limit asked for is not enforced; the card's per-block maximum is.
template <class K>
int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
// Rounded f32 operations; the library is built with -ffp-contract=off.
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline void sincos(double x, double* s, double* c) { *s = std::sin(x); *c = std::cos(x); }
constexpr size_t kSharedBytes = 232448;  // the H100's dynamic shared memory per block
alignas(16) inline unsigned char g_dyn_smem[kSharedBytes];
inline std::barrier<>* g_block;
inline std::vector<std::unique_ptr<std::barrier<>>> g_warps;
inline double g_lanes[1024];  // holds a float exactly
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp() { g_warps[g_tid / 32]->arrive_and_wait(); }
template <class T>
T __shfl_xor_sync(unsigned, T v, int o) {
  g_lanes[g_tid] = v;
  __syncwarp();
  const T r = (T)g_lanes[(g_tid & ~31u) | ((g_tid & 31u) ^ (unsigned)o)];
  __syncwarp();
  return r;
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline double __ldcg(const double* p) { return *p; }
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t, A... args) {
  const unsigned n = block.x * block.y * block.z;
  if (smem > kSharedBytes || n < 1 || n > 1024) {  // the card refuses such a launch
    g_last_error = cudaErrorInvalidConfiguration;
    return;
  }
  gridDim = grid;
  blockDim = block;
  for (unsigned bz = 0; bz < grid.z; ++bz) {
    for (unsigned by = 0; by < grid.y; ++by) {
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::memset(g_dyn_smem, 0xff, smem);  // NaN: a read before any write shows
        std::barrier<> bar(n);
        g_block = &bar;
        g_warps.clear();
        for (unsigned w = 0; w < n; w += 32)
          g_warps.emplace_back(new std::barrier<>(std::min(32u, n - w)));
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t) {
          threads.emplace_back([&, t] {
            g_tid = t;
            threadIdx = dim3(t % block.x, t / block.x % block.y, t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            kernel(args...);
            g_block->arrive_and_drop();  // a finished thread leaves every barrier
            g_warps[t / 32]->arrive_and_drop();
          });
        }
        for (auto& th : threads) th.join();
      }
    }
  }
}
"""


def emulated_source(path):
    """The CUDA source at ``path`` rewritten for the shim: dynamic shared
    memory is the shim's buffer, static shared memory a function-local
    static, and ``kernel<<<grid, block, smem, stream>>>(...)`` a call of
    ``emu_launch``."""
    with open(path) as f:
        src = f.read()
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                 r"\1* const \2 = reinterpret_cast<\1*>(g_dyn_smem);", src)
    src = src.replace("__shared__", "static")
    return re.sub(r"([\w:]+(?:<[^<>()]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src,
                  flags=re.S)


def build_emulated(path, out_dir, flags=()):
    """Compile ``path`` against the shim into a shared library in
    ``out_dir``; returns its ctypes handle. Skips where no C++20 compiler
    is installed."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler for the CPU emulation of the CUDA source")
    (out_dir / "shim.h").write_text(SHIM)
    (out_dir / "emu.cpp").write_text(emulated_source(path))
    out = out_dir / "libemulated.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", *flags, "-o", str(out),
         str(out_dir / "emu.cpp")], capture_output=True, text=True, timeout=300, check=False,
    )
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("the C++ compiler has no <barrier> (C++20)")
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return ba_cuda.bind(build_emulated(SRC, tmp_path_factory.mktemp("ba_kernels_emulated")))


def _rig(**kwargs):
    """tests/test_torch_cuda.py's perturbed rig on the CPU, as kernel inputs."""
    return _inputs(*_problem("cpu", **kwargs))


def _random_board(C, F, N, seed):
    """N random planar board points seen by C cameras in F frames."""
    rng = np.random.default_rng(seed)
    objp = np.concatenate([rng.uniform(-50, 50, (N, 2)), np.zeros((N, 1))], 1)
    cam = np.tile([800.0, 810.0, 320.0, 240.0, -0.1, 0.02, 0.1, -0.2, 0.05, 5.0, -3.0, 0.0],
                  (C, 1)) + rng.normal(0, 0.05, (C, 12))
    poses = np.concatenate([rng.normal(0, 0.3, (F, 3)), rng.normal(0, 20, (F, 3)) + [0, 0, 600]], 1)
    pred = _predict(torch.as_tensor(cam), torch.as_tensor(poses), torch.as_tensor(objp)).numpy()
    obs = pred + rng.normal(0, 0.5, pred.shape)
    return _inputs(cam, poses, obs, rng.random((C, F, N)) > 0.3, objp)


def _inputs(cam, poses, obs, mask, objp):
    t = torch.as_tensor
    return (t(cam), t(poses), *ba_cuda.ba_prepare_obs(t(obs), t(mask)), t(objp))


CASES = {
    "ragged23": lambda: _rig(n_frames=23, shift=3e-5),
    "padded61+6": lambda: _rig(n_cameras=2, n_frames=61, seed=9, shift=3e-5, pad=6),
    "angles": lambda: _rig(n_cameras=5, n_frames=11, seed=5, edge_angles=True),
    "N64": lambda: _random_board(2, 19, 64, seed=0),
    "N3": lambda: _random_board(3, 11, 3, seed=1),
    "N1": lambda: _random_board(3, 17, 1, seed=2),
}
COST_CASES = {
    **CASES,
    "C1": lambda: _random_board(1, 9, 35, seed=3),
    "C6": lambda: _rig(n_cameras=6, n_frames=15, seed=7),
    "C64": lambda: _random_board(64, 5, 35, seed=4),
}


@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernels_match_twins(lib, case, loss_linear):
    args = CASES[case]()
    got = ba_cuda._launch_blocks(lib, 0, *args, 1.0, loss_linear)
    _assert_blocks_close(got, lm_core.ba_chunk_blocks_reference(*args, 1.0, loss_linear))
    for a, b in zip(got, ba_cuda._launch_blocks(lib, 0, *args, 1.0, loss_linear)):
        assert torch.equal(a, b)  # a fixed sum order: a relaunch is bit-identical
    if case.startswith("padded"):
        for x in (got[1][61:], got[2][:, 61:], got[5][:, 61:]):
            assert float(x.abs().max()) == 0.0
    # both kernels run one front end and one frame sum: the same fragments
    cost, _ = ba_cuda._launch_cost(lib, 0, *args, 1.0, loss_linear)
    np.testing.assert_allclose(cost.numpy(), got[5].numpy(), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("loss_linear", [False, True], ids=["soft_l1", "linear"])
@pytest.mark.parametrize("case", list(COST_CASES))
def test_emulated_cost_kernel_matches_twin(lib, case, loss_linear):
    """ba_cost_kernel and its in-kernel total against ba_chunk_cost_reference:
    fragments at rtol 2e-5 atol 1e-7, the total against the f64 sum of the
    kernel's own fragments at rtol 1e-12 and against the twin's at rtol 3e-5;
    a relaunch is bit-identical and finds the arrival counter back at 0."""
    args = COST_CASES[case]()
    frags, total = ba_cuda._launch_cost(lib, 0, *args, 1.0, loss_linear)
    ref_frags, ref_total = lm_core.ba_chunk_cost_reference(*args, 1.0, loss_linear)
    assert frags.shape == ref_frags.shape == args[3].shape[:2]
    assert frags.dtype == torch.float32 and total.dtype == torch.float64
    assert total.shape == ref_total.shape == ()
    np.testing.assert_allclose(
        frags.double().numpy(), ref_frags.double().numpy(), rtol=2e-5, atol=1e-7
    )
    np.testing.assert_allclose(float(total), float(frags.double().sum()), rtol=1e-12)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=3e-5)
    assert int(ba_cuda._ticket(args[0].device, 0)) == 0
    frags2, total2 = ba_cuda._launch_cost(lib, 0, *args, 1.0, loss_linear)
    assert torch.equal(frags, frags2) and torch.equal(total, total2)
    if case.startswith("padded"):
        assert float(frags[:, 61:].abs().max()) == 0.0
