// Corner-response kernel for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the two Pallas TPU kernels of multicam_calibration_tpu/ops/pallas_kernels.py
// with one templated kernel, corner_kernel<kPeaks>:
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
// Layout: one block of 256 threads per (frame, 32 x 64 output tile). The block
// stages the tile plus a halo of rg + 1 + nms pixels in shared memory (buffer
// A), runs the horizontal pass into buffer B, the vertical pass back into A,
// the stencil and response into B, the row max into A, and writes the column
// max, the compare and the response row by row (neighbouring threads on
// neighbouring pixels, so global reads and writes coalesce). Shared memory is
// (TH + 2h)(TW + 2h + TW + 2 + 2 nms) floats with h = rg + 1 + nms: 32,864 B
// at sigma 1.5 and 77,568 B at sigma 9, above the 48 KB default, so the
// launcher raises the kernel's dynamic shared-memory limit first.
//
// Bound on the H100 (80 GB HBM3 at 3.35 TB/s; 67 TFLOP/s f32 outside the
// tensor cores): per pixel the kernel must read 4 B and write 4 B (+1 B of
// peak), ~354 MB at 128 x 480 x 640, i.e. ~0.106 ms. The arithmetic is
// 2 (2 rg + 1) - 1 flops per pass per pixel, 12 for the stencil and response
// and 4 nms + 2 for the window max and compare: 72 flops at sigma 1.5
// (2.8 GFLOP per 128-frame batch, 0.042 ms) and 248 at sigma 9 (9.8 GFLOP,
// 0.146 ms). So sigma 1.5 is bound by bytes and sigma 9 by operations, near
// balance. The simple design spends more than that:
// each block recomputes its halo (at sigma 9 the horizontal pass covers
// 96 x 74 pixels for 32 x 64 outputs), the passes use separate multiplies and
// adds, and the stages meet at __syncthreads. No TMA, no tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kMaxTaps = 63;  // 2 rg + 1 <= 63: sigma <= 10.16

struct Taps {
  float k[kMaxTaps];
};

template <bool kPeaks>
__global__ void __launch_bounds__(kThreads)
corner_kernel(const float* __restrict__ gray, int H, int W, Taps taps, int rg, int nms_in,
              float* __restrict__ resp, uint8_t* __restrict__ peak) {
  extern __shared__ float smem[];
  const int n = kPeaks ? nms_in : 0;
  const int e = 1 + n;                       // stencil + NMS halo after smoothing
  const int halo = rg + e;
  const int inH = kTileH + 2 * halo, inW = kTileW + 2 * halo;
  const int gW = kTileW + 2 * e;             // width after the horizontal pass
  const int gH = kTileH + 2 * e;             // height after the vertical pass
  const int rH = kTileH + 2 * n, rW = kTileW + 2 * n;
  const int ntap = 2 * rg + 1;
  float* A = smem;                           // inH * inW floats
  float* Bs = smem + inH * inW;              // inH * gW floats

  const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)H * W;
  const float* img = gray + blockIdx.z * plane;

  // 1. stage the tile and its halo, zero outside the image
  for (int i = threadIdx.x; i < inH * inW; i += kThreads) {
    const int r = i / inW, c = i - r * inW;
    const int y = y0 - halo + r, x = x0 - halo + c;
    A[i] = (y >= 0 && y < H && x >= 0 && x < W) ? img[(size_t)y * W + x] : 0.0f;
  }
  __syncthreads();

  // 2. horizontal Gaussian: B[r][c] = sum_t k[t] A[r][c + t]; B column c is
  //    image column x0 - e + c
  for (int i = threadIdx.x; i < inH * gW; i += kThreads) {
    const int r = i / gW, c = i - r * gW;
    const float* src = A + r * inW + c;
    float acc = __fmul_rn(taps.k[0], src[0]);
    for (int t = 1; t < ntap; ++t) acc = __fadd_rn(acc, __fmul_rn(taps.k[t], src[t]));
    Bs[i] = acc;
  }
  __syncthreads();

  // 3. vertical Gaussian into A (gH x gW); A row r is image row y0 - e + r
  for (int i = threadIdx.x; i < gH * gW; i += kThreads) {
    const int r = i / gW, c = i - r * gW;
    const float* src = Bs + r * gW + c;
    float acc = __fmul_rn(taps.k[0], src[0]);
    for (int t = 1; t < ntap; ++t) acc = __fadd_rn(acc, __fmul_rn(taps.k[t], src[t * gW]));
    A[i] = acc;
  }
  __syncthreads();

  // 4. Hessian stencils and response over the nms-extended tile (rH x rW);
  //    response (r, c) is image pixel (y0 - n + r, x0 - n + c)
  for (int i = threadIdx.x; i < rH * rW; i += kThreads) {
    const int r = i / rW, c = i - r * rW;
    const float* g = A + (r + 1) * gW + (c + 1);
    const float twoc = __fmul_rn(2.0f, g[0]);
    const float ixx = __fadd_rn(__fsub_rn(g[-1], twoc), g[1]);
    const float iyy = __fadd_rn(__fsub_rn(g[-gW], twoc), g[gW]);
    const float ixy = __fmul_rn(
        0.25f, __fsub_rn(__fsub_rn(__fadd_rn(g[-gW - 1], g[gW + 1]), g[-gW + 1]), g[gW - 1]));
    const float v = __fsub_rn(__fmul_rn(ixy, ixy), __fmul_rn(ixx, iyy));
    if (kPeaks) {
      Bs[i] = v;
    } else {
      const int y = y0 + r, x = x0 + c;
      if (y < H && x < W) resp[blockIdx.z * plane + (size_t)y * W + x] = v;
    }
  }
  if (!kPeaks) return;
  __syncthreads();

  // 5. row max over 2 n + 1 columns into A (rH x kTileW)
  const int win = 2 * n + 1;
  for (int i = threadIdx.x; i < rH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    const float* src = Bs + r * rW + c;
    float m = src[0];
    for (int d = 1; d < win; ++d) m = fmaxf(m, src[d]);
    A[i] = m;
  }
  __syncthreads();

  // 6. column max, compare, write the tile
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i - r * kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float* col = A + r * kTileW + c;
    float m = col[0];
    for (int d = 1; d < win; ++d) m = fmaxf(m, col[d * kTileW]);
    const float center = Bs[(r + n) * rW + (c + n)];
    const size_t o = blockIdx.z * plane + (size_t)y * W + x;
    resp[o] = center;
    peak[o] = (center >= m && center > 0.0f) ? 1 : 0;
  }
}

size_t smem_bytes(int rg, int nms) {
  const int halo = rg + 1 + nms;
  const size_t inH = kTileH + 2 * halo, inW = kTileW + 2 * halo;
  const size_t gW = kTileW + 2 * (1 + nms);
  return (inH * inW + inH * gW) * sizeof(float);
}

template <bool kPeaks>
int launch(const float* gray, int B, int H, int W, const float* taps, int rg, int nms,
           float* resp, uint8_t* peak, cudaStream_t stream) {
  if (2 * rg + 1 > kMaxTaps || rg < 0 || nms < 0 || B < 1 || H < 1 || W < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  Taps t;
  for (int i = 0; i < kMaxTaps; ++i) t.k[i] = i < 2 * rg + 1 ? taps[i] : 0.0f;
  const size_t smem = smem_bytes(rg, kPeaks ? nms : 0);
  cudaError_t err = cudaFuncSetAttribute(
      corner_kernel<kPeaks>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  corner_kernel<kPeaks><<<grid, kThreads, smem, stream>>>(gray, H, W, t, rg, nms, resp, peak);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* corner_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// gray (B, H, W) f32 contiguous; taps: 2 rg + 1 host floats. Outputs resp (B, H, W)
// f32 and, with peaks != 0, peak (B, H, W) uint8 (0/1); both written in full.
int corner_launch(const void* gray, int B, int H, int W, const float* taps, int rg, int nms,
                  int peaks, void* resp, void* peak, void* stream) {
  if (peaks)
    return launch<true>((const float*)gray, B, H, W, taps, rg, nms, (float*)resp,
                        (uint8_t*)peak, (cudaStream_t)stream);
  return launch<false>((const float*)gray, B, H, W, taps, rg, 0, (float*)resp, nullptr,
                       (cudaStream_t)stream);
}

}  // extern "C"
