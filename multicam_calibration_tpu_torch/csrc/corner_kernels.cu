// Corner-response kernel for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the two Pallas TPU kernels of multicam_calibration_tpu/ops/pallas_kernels.py
// with one templated kernel, corner_kernel<kPeaks, RG>:
//   kPeaks = true  <- _response_peaks_kernel (fused response + NMS peak mask)
//   kPeaks = false <- _response_kernel       (response only)
//
// What it computes (the Pallas kernels' semantics): the f32 gray is zero outside
// [0, H) x [0, W); a separable Gaussian of radius rg = int(3 sigma + 0.5) runs
// through that zero halo (horizontal pass, then vertical); the Hessian stencils
// Ixx = [1, -2, 1] along x, Iyy along y, Ixy = 1/4 diagonal cross, and the
// response Ixy^2 - Ixx * Iyy follow. In peaks mode the response is also
// computed in an nms-wide band around the tile, a separable (2 nms + 1)^2
// window max (row max, then column max) is taken, and
// peak = (resp >= max) & (resp > 0).
//
// Arithmetic order: every multiply and add is an explicitly rounded f32
// operation (__fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts
// into an FMA), in the order of the Pallas kernel: acc = k[0] * x[0], then
// acc = acc + k[t] * x[t] for t = 1 .. 2 rg; Ixx = (l - 2 c) + r;
// Ixy = 0.25 * (((ul + dr) - ur) - dl); resp = ixy * ixy - ixx * iyy. The plain
// PyTorch twin (ops/corner_cuda.py) runs the same operations one tensor op at
// a time, so kernel and twin agree bit for bit on the card.
//
// Layout: one block of 32 x 8 threads (threadIdx.x the lane, threadIdx.y the
// warp) per (frame, kTileH x 64 output tile). The block stages the tile plus a
// halo of rg + 1 + nms pixels in shared memory (buffer A), runs the horizontal
// pass into buffer B, the vertical pass back into A, the stencil and response
// into B, the row max into A, and writes the column max, the compare and the
// response row by row (neighbouring threads on neighbouring pixels, so global
// reads and writes coalesce).
//
// The kernel is corner_kernel<kPeaks, RG>, instantiated for the radii of the
// port's own paths, RG = 5, 11, 18 and 27 (sigma 1.5, 3.5, 6 and 9), plus
// RG = 0, which reads the radius at run time (every other rg <= 31). With RG
// fixed, each Gaussian pass is a register sliding window: a thread loads
// kS + 2 RG values of its line once and computes kS consecutive outputs from
// registers, with the tap loops unrolled so each tap is a constant operand
// (RG = 0 runs the same kS outputs with a runtime tap loop over shared
// memory). The horizontal pass puts lanes on rows (an odd row pitch puts a
// warp's loads in 32 banks), the vertical pass and the stencil put lanes on
// columns. Work items (a 32-line group and a kS segment) go to warps round
// robin, and every index is a sum of compile-time strides: no stage divides.
// The tile's height depends on the radius (tile_h): 48 rows at RG = 5 and 18,
// 64 at RG = 11 and 27 (at sigma 9 the horizontal pass then covers 128 rows
// for 64 outputs instead of 96 for 32), 32 for the runtime radius. With nms 4
// shared memory is 46,952 B at sigma 1.5 and 109,320 B at sigma 9 (2 blocks
// per SM), above the 48 KB default from sigma 3.5 on, so the launcher raises
// the kernel's limit first. Each thread keeps kStageRows
// global loads in flight while it stages the tile: a block's loads are
// otherwise one latency each, which the few blocks an SM holds cannot hide.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores): per pixel the kernel must read 4 B and write 4 B (+1 B of
// peak), ~354 MB at 128 x 480 x 640, i.e. ~0.106 ms. The arithmetic is
// 2 (2 rg + 1) - 1 flops per pass per pixel, 12 for the stencil and response
// and 4 nms + 2 for the window max and compare: 72 flops at sigma 1.5
// (2.8 GFLOP per 128-frame batch, 0.042 ms) and 248 at sigma 9 (9.8 GFLOP,
// 0.146 ms). The 67 TFLOP/s counts an FMA as two flops; under the rounded,
// never-contracted order each flop is one instruction, so the arithmetic's
// own ceiling is half that rate. The halo is still recomputed per block, and
// the window maxima read 2 nms + 1 values per output from shared memory. No
// TMA, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;
constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kS = 8;         // outputs per thread and work item in the passes
constexpr int kStageRows = 4;  // rows of global loads a thread keeps in flight
constexpr int kMaxTaps = 63;  // 2 rg + 1 <= 63: sigma <= 10.16

// Output rows of a tile: fewer rows, more blocks per SM, for small radii; more
// rows, less halo recomputed, for large ones (PERF.md §6, row 3 of the
// kernel table, has the times).
__host__ __device__ constexpr int tile_h(int RG) {
  return RG == 0 ? 32 : RG == 11 || RG == 27 ? 64 : 48;
}

struct Taps {
  float k[kMaxTaps];
};

// Sizes of one tile's stages, in floats; the same on host and device.
struct Layout {
  int n, e, halo;       // NMS radius, stencil + NMS halo, input halo
  int inH, inW;         // staged input
  int gH, gW;           // after the horizontal (gW) and vertical (gH) passes
  int rH, rW;           // response over the NMS-extended tile
  int segH, segV, segR; // kS segments of the horizontal, vertical, stencil lines
  int pa, pb;           // pitches of the input in A and of B (odd)
  int a_floats, b_floats;
};

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout make_layout(int rg, int n, int th) {
  Layout L{};
  L.n = n;
  L.e = 1 + n;
  L.halo = rg + L.e;
  L.inH = th + 2 * L.halo;
  L.inW = kTileW + 2 * L.halo;
  L.gH = th + 2 * L.e;
  L.gW = kTileW + 2 * L.e;
  L.rH = th + 2 * n;
  L.rW = kTileW + 2 * n;
  L.segH = (L.gW + kS - 1) / kS;
  L.segV = (L.gH + kS - 1) / kS;
  L.segR = (L.rH + kS - 1) / kS;
  L.pa = (L.segH * kS + 2 * rg) | 1;  // covers the last segment's window
  L.pb = L.gW | 1;
  // A: the input, then the smoothed tile (pitch gW, rows read by the stencil's
  // last segment), then the row max; B: the horizontal pass (rows read by the
  // vertical pass's last segment), then the response.
  L.a_floats = imax(L.inH * L.pa, imax((L.segR * kS + 2) * L.gW, L.rH * kTileW));
  L.b_floats = imax((L.segV * kS + 2 * rg) * L.pb, L.rH * L.rW);
  return L;
}

// Calls f(i, j) for this warp's items of an ni x nj grid: item i * nj + j goes
// to warp (i * nj + j) mod kWarps, walked without a division.
template <class F>
__device__ __forceinline__ void warp_items(int ni, int nj, F&& f) {
  int i = 0, j = threadIdx.y;
  while (j >= nj && i < ni) { j -= nj; ++i; }
  while (i < ni) {
    f(i, j);
    j += kWarps;
    while (j >= nj) { j -= nj; ++i; }
  }
}

// kS outputs of a Gaussian pass along a line: out[o * ostride] =
// sum_t k[t] src[(o + t) * stride], accumulated from t = 0 up with rounded f32
// operations, for o < lim. RG > 0: a register window of kS + 2 RG values and
// unrolled taps; RG = 0: a runtime tap loop over shared memory.
template <int RG>
__device__ __forceinline__ void smooth(const float* src, int stride, float* out, int ostride,
                                       int lim, const Taps& taps, int rg) {
  if constexpr (RG > 0) {
    float x[kS + 2 * RG];
#pragma unroll
    for (int j = 0; j < kS + 2 * RG; ++j) x[j] = src[j * stride];
#pragma unroll
    for (int o = 0; o < kS; ++o) {
      float acc = __fmul_rn(taps.k[0], x[o]);
#pragma unroll
      for (int t = 1; t <= 2 * RG; ++t) acc = __fadd_rn(acc, __fmul_rn(taps.k[t], x[o + t]));
      if (o < lim) out[o * ostride] = acc;
    }
  } else {
    float acc[kS];
#pragma unroll
    for (int o = 0; o < kS; ++o) acc[o] = __fmul_rn(taps.k[0], src[o * stride]);
    const int ntap = 2 * rg + 1;
    for (int t = 1; t < ntap; ++t) {
      src += stride;
      const float k = taps.k[t];
#pragma unroll
      for (int o = 0; o < kS; ++o) acc[o] = __fadd_rn(acc[o], __fmul_rn(k, src[o * stride]));
    }
#pragma unroll
    for (int o = 0; o < kS; ++o)
      if (o < lim) out[o * ostride] = acc[o];
  }
}

template <bool kPeaks, int RG>
__global__ void __launch_bounds__(kThreads, 2)
corner_kernel(const float* __restrict__ gray, int H, int W, Taps taps, int rg_in, int nms_in,
              float* __restrict__ resp, uint8_t* __restrict__ peak) {
  extern __shared__ float smem[];
  constexpr int TH = tile_h(RG);
  const int rg = RG > 0 ? RG : rg_in;
  const Layout L = make_layout(rg, kPeaks ? nms_in : 0, TH);
  const int n = L.n;
  float* A = smem;               // input; then the smoothed tile; then the row max
  float* Bs = smem + L.a_floats; // horizontal pass; then the response
  const int tx = threadIdx.x, ty = threadIdx.y;

  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)H * W;
  const float* img = gray + blockIdx.z * plane;

  // 1. stage the tile and its halo, zero outside the image; A row r, column c
  //    is image pixel (y0 - halo + r, x0 - halo + c). A thread issues the
  //    loads of kStageRows rows before it stores any, so they are in flight
  //    together.
  for (int c = tx; c < L.inW; c += kLanes) {
    const int x = x0 - L.halo + c;
    const bool col_in = x >= 0 && x < W;
    for (int r0 = ty; r0 < L.inH; r0 += kWarps * kStageRows) {
      float v[kStageRows];
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        const int y = y0 - L.halo + r0 + k * kWarps;
        v[k] = (col_in && y >= 0 && y < H) ? img[(size_t)y * W + x] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kStageRows; ++k)
        if (r0 + k * kWarps < L.inH) A[(r0 + k * kWarps) * L.pa + c] = v[k];
    }
  }
  __syncthreads();

  // 2. horizontal Gaussian, lanes on rows: B[r][c] = sum_t k[t] A[r][c + t];
  //    B column c is image column x0 - e + c
  warp_items((L.inH + kLanes - 1) / kLanes, L.segH, [&](int g, int s) {
    const int r = g * kLanes + tx;
    if (r < L.inH)
      smooth<RG>(A + r * L.pa + s * kS, 1, Bs + r * L.pb + s * kS, 1, L.gW - s * kS, taps, rg);
  });
  __syncthreads();

  // 3. vertical Gaussian into A (pitch gW), lanes on columns; A row r is image
  //    row y0 - e + r
  warp_items((L.gW + kLanes - 1) / kLanes, L.segV, [&](int g, int s) {
    const int c = g * kLanes + tx;
    if (c < L.gW)
      smooth<RG>(Bs + s * kS * L.pb + c, L.pb, A + s * kS * L.gW + c, L.gW, L.gH - s * kS,
                 taps, rg);
  });
  __syncthreads();

  // 4. Hessian stencils and response over the nms-extended tile (rH x rW),
  //    lanes on columns, a thread down kS rows with a 3-row window; response
  //    (r, c) is image pixel (y0 - n + r, x0 - n + c)
  warp_items((L.rW + kLanes - 1) / kLanes, L.segR, [&](int g, int s) {
    const int c = g * kLanes + tx;
    if (c >= L.rW) return;
    const int r0 = s * kS;
    const float* gp = A + r0 * L.gW + c;
    float ul = gp[0], up = gp[1], ur = gp[2];
    gp += L.gW;
    float l = gp[0], ctr = gp[1], rt = gp[2];
#pragma unroll
    for (int o = 0; o < kS; ++o) {
      gp += L.gW;
      const float dl = gp[0], dn = gp[1], dr = gp[2];
      const float twoc = __fmul_rn(2.0f, ctr);
      const float ixx = __fadd_rn(__fsub_rn(l, twoc), rt);
      const float iyy = __fadd_rn(__fsub_rn(up, twoc), dn);
      const float ixy = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(__fadd_rn(ul, dr), ur), dl));
      const float v = __fsub_rn(__fmul_rn(ixy, ixy), __fmul_rn(ixx, iyy));
      const int r = r0 + o;
      if (r < L.rH) {
        if (kPeaks) {
          Bs[r * L.rW + c] = v;
        } else {
          const int y = y0 + r, x = x0 + c;
          if (y < H && x < W) resp[blockIdx.z * plane + (size_t)y * W + x] = v;
        }
      }
      ul = l; up = ctr; ur = rt;
      l = dl; ctr = dn; rt = dr;
    }
  });
  if constexpr (kPeaks) {
    __syncthreads();

    // 5. row max over 2 n + 1 columns into A (rH x kTileW)
    for (int r = ty; r < L.rH; r += kWarps) {
#pragma unroll
      for (int c = tx; c < kTileW; c += kLanes) {
        const float* src = Bs + r * L.rW + c;
        float m = src[0];
        for (int d = 1; d <= 2 * n; ++d) m = fmaxf(m, src[d]);
        A[r * kTileW + c] = m;
      }
    }
    __syncthreads();

    // 6. column max, compare, write the tile
    for (int r = ty; r < TH; r += kWarps) {
      const int y = y0 + r;
      if (y >= H) break;
#pragma unroll
      for (int c = tx; c < kTileW; c += kLanes) {
        const int x = x0 + c;
        if (x >= W) continue;
        const float* col = A + r * kTileW + c;
        float m = col[0];
        for (int d = 1; d <= 2 * n; ++d) m = fmaxf(m, col[d * kTileW]);
        const float center = Bs[(r + n) * L.rW + (c + n)];
        const size_t o = blockIdx.z * plane + (size_t)y * W + x;
        resp[o] = center;
        peak[o] = (center >= m && center > 0.0f) ? 1 : 0;
      }
    }
  }
}

template <bool kPeaks, int RG>
int launch(const float* gray, int B, int H, int W, const Taps& t, int rg, int nms,
           float* resp, uint8_t* peak, cudaStream_t stream) {
  constexpr int TH = tile_h(RG);
  const Layout L = make_layout(rg, nms, TH);
  const size_t smem = (size_t)(L.a_floats + L.b_floats) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      corner_kernel<kPeaks, RG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  corner_kernel<kPeaks, RG><<<grid, dim3(kLanes, kWarps), smem, stream>>>(
      gray, H, W, t, rg, nms, resp, peak);
  return (int)cudaGetLastError();
}

// The radius's instantiation: RG = 5, 11, 18, 27 (sigma 1.5, 3.5, 6, 9), else
// 0, the runtime radius.
constexpr int radius_instance(int rg) {
  return rg == 5 || rg == 11 || rg == 18 || rg == 27 ? rg : 0;
}

template <bool kPeaks>
int launch_radius(const float* gray, int B, int H, int W, const float* taps, int rg, int nms,
                  float* resp, uint8_t* peak, cudaStream_t stream) {
  if (2 * rg + 1 > kMaxTaps || rg < 0 || nms < 0 || B < 1 || H < 1 || W < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < kMaxTaps; ++i) t.k[i] = i < 2 * rg + 1 ? taps[i] : 0.0f;
  switch (radius_instance(rg)) {
    case 5: return launch<kPeaks, 5>(gray, B, H, W, t, rg, nms, resp, peak, stream);
    case 11: return launch<kPeaks, 11>(gray, B, H, W, t, rg, nms, resp, peak, stream);
    case 18: return launch<kPeaks, 18>(gray, B, H, W, t, rg, nms, resp, peak, stream);
    case 27: return launch<kPeaks, 27>(gray, B, H, W, t, rg, nms, resp, peak, stream);
    default: return launch<kPeaks, 0>(gray, B, H, W, t, rg, nms, resp, peak, stream);
  }
}

}  // namespace

extern "C" {

const char* corner_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Dynamic shared memory of one launch, in bytes (what the launcher asks for).
long long corner_smem_bytes(int rg, int nms, int peaks) {
  const Layout L = make_layout(rg, peaks ? nms : 0, tile_h(radius_instance(rg)));
  return (long long)(L.a_floats + L.b_floats) * (long long)sizeof(float);
}

// gray (B, H, W) f32 contiguous; taps: 2 rg + 1 host floats. Outputs resp (B, H, W)
// f32 and, with peaks != 0, peak (B, H, W) uint8 (0/1); both written in full.
int corner_launch(const void* gray, int B, int H, int W, const float* taps, int rg, int nms,
                  int peaks, void* resp, void* peak, void* stream) {
  if (peaks)
    return launch_radius<true>((const float*)gray, B, H, W, taps, rg, nms, (float*)resp,
                               (uint8_t*)peak, (cudaStream_t)stream);
  return launch_radius<false>((const float*)gray, B, H, W, taps, rg, 0, (float*)resp, nullptr,
                              (cudaStream_t)stream);
}

}  // extern "C"
