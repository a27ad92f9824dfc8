// Bundle-adjustment kernels for NVIDIA Hopper (sm_90a), plain C ABI.
//
// Replaces the two Pallas TPU kernels of multicam_calibration_tpu/ops/ba_pallas.py:
//   ba_blocks_kernel + ba_reduce_kernel <- _ba_kernel   (fused linearization +
//                                                         normal-block build)
//   ba_cost_kernel                      <- _cost_kernel (per-damping-try robust cost)
// All three take the raw parameters, cam (C, 12) and pose (F, 6) in f64, and
// compute the rotations in the kernel (rotation_pack below, the formulas of
// ops/rotation.py). The block and cost kernels share one front end: the same
// tiling (grid (frame tiles, cameras), a thread per board point), the same
// loads (load_tile_point), packs (tile_packs), prediction chain (world_point,
// chain_residual, the counterpart of ba_pallas.py:_chain_residual), robust loss
// (robust_rho_w) and per-frame cost sum (frame_cost), so the cost of a damping
// try is computed exactly as the block build computes it.
//
// Numerical contract (ba_pallas.py:24-27, lm_core.py:519-527):
//   - R_c, R_p, the prediction chain and the residual run in native fp64
//     (Hopper has it; the TPU kernel's two-float arithmetic existed only because
//     the TPU has none);
//   - the left Jacobians J_l(r_c), J_l(rho_p) are evaluated in f64 and rounded to
//     f32, as the Pallas kernel (ba_pallas.py:588, :603) and the twin do;
//   - Jacobian rows, robust weights, in-frame products and in-tile sums are f32,
//     computed from the f64 chain values cast to f32 (lm_core's jac/grad/block/
//     cost_dtype="float32" recipe);
//   - every output is f32; the frame and camera reductions of the gradient and
//     cost run in f64 outside the kernels.
//
// Block build, two launches per call:
//   1. ba_blocks_kernel: grid (frame tiles, cameras), 256 threads a block, a
//      tile of P = min(256 / N, 8) frames (7 at N = 35). Warp 0 computes the
//      frames' R_p and J_l on lanes < P and the camera's R_c and J_l on lane 31,
//      one code path for all, into shared memory. Then every board point of
//      the tile gets a thread, which builds the point's two weighted rows
//      (19 columns: 12 A, 6 B, weighted residual, padded to 20) into shared
//      memory. Then one warp per (camera, frame) pair forms the pair's Gram:
//      the 189 outputs (U 78, W 72, V 21, g_cam 12, g_pose 6) are the upper
//      triangle of the 20 x 20 Gram of its 2N rows without r.r, 15 pairs of
//      4-column blocks, each owned by two lanes (rows [0, N) and [N, 2N)), each
//      lane a 4 x 4 register tile fed by two float4 loads per row; the halves
//      are added with one shuffle. W, g_cam, g_pose and cost are final per
//      (c, f); V goes out per (c, f) and U per (camera, tile) after a sum over
//      the tile's frames in order.
//   2. ba_reduce_kernel: V summed over cameras in camera order (one thread per
//      frame entry), U over tiles (one warp per camera entry: lanes stride over
//      the tiles, then a fixed shuffle tree), both written as full symmetric
//      matrices.
// No float atomics: every launch gives bit-identical results.
//
// Masked points never enter the chain: their rows are exact zeros written
// before any divide. Padded frames carry zero poses, and a near-identity camera
// then sees |z| ~ 1e-5, where the f32 1/z chain overflows and inf * 0 would
// poison the normal equations (ba_pallas.py:189-202). chain_residual also takes
// the z = 1 branch for a masked point or |z| < 1e-12, as the TPU kernel does,
// so it stays finite for any caller.
//
// Bounds on the H100: the bench shape (6 cameras x 922 frames x 35 points) is
// ~150k observed points at ~60 f64 flops of chain and 756 f32 flops of Gram
// each (~0.12 GFLOP, 1.9 us at 67 TFLOP/s f32), ~3 MB in and ~2 MB out (~1.5
// us at 3.35 TB/s): bound by operations. What the design does about it:
//   - parallelism: a warp per (camera, frame) pair for the Gram, 5.5k at the
//     bench shape, and a thread per board point for the rows, so that no lane
//     idles through a second round of points; __launch_bounds__ with 3 blocks
//     of 8 warps per SM;
//   - the Gram is register-tiled (16 FMAs per two 16-byte shared loads) rather
//     than one dot product per output (one FMA per two 4-byte loads);
//   - the parameter packs (so3 exponentials, left Jacobians) are computed in the
//     kernel, once per block, so the wrapper launches nothing else; the
//     observation loads are issued before them.
// What it leaves out: tensor cores (each pair is a 70 x 20 Gram, ~13k FMAs, and
// TF32 would break the f32 block contract; 3xTF32 is left for later), TMA and
// cp.async (one pair's observations are 560 B, which coalesced loads cover).
//
// Per-try cost, one launch per call:
//   ba_cost_kernel: the block kernel's tile and front end, without rows or
//   Gram, on a grid (groups of kCostTiles = 2 tiles, cameras). A thread takes
//   the same board point of each of its block's tiles: it starts their mask and
//   observation loads (one 16-byte load for a pair), waits for the block's one
//   camera pack and 2 P pose packs (warp 0, as above), runs the two f64 chains
//   side by side and the f32 robust loss, and leaves the points' costs in
//   shared memory; warp w then sums frame w of each tile in the block kernel's
//   order and writes the (c, f) fragments. Each fragment is cast to f64 and
//   added up per warp, then per block in warp order, into one f64 per block;
//   the last block to arrive (an integer ticket; no float atomics) adds the
//   blocks' sums in a fixed order (thread t takes blocks t, t + 256, ..., then
//   a shuffle tree, then the warps in order) and writes the total, so the
//   caller reads one number and a relaunch is bit-identical whichever block
//   comes last.
// Bounds on the H100 at the bench shape: 3.4 MB in (observations f64, mask u8,
// parameters), 22 KB out, 1.00 us at 3.35 TB/s, against ~9M f64 flops of chain
// (0.27 us at 34 TFLOP/s): bound by bytes. The kernel is far from that bound
// and held by latency, not by rate: a block is one dependent chain of loads,
// packs, chain, sums and ticket. What the design does about it: 396 blocks of
// 8 warps, 3 on each of the 132 SMs and so all resident in one wave (one tile
// a block gave 792 blocks in one and a half waves); one pack per block instead
// of every camera's in every block; two independent points a thread instead of
// a second round for 3 lanes; every load in flight before the packs; and a
// total that reads one f64 per block instead of every fragment. Shared memory
// holds the packs, the per-point costs and the sums (< 4 KB). No tensor cores:
// there is no product to feed them. No TMA or cp.async: one pair's
// observations are 560 B, which coalesced 16-byte loads cover.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                       // block kernel: 8 warps
constexpr int kWarps = kThreads / 32;               // at most one frame per warp
constexpr int kMinBlocksPerSM = 3;                  // <= 85 registers a thread
constexpr int kCostTiles = 2;                       // cost kernel: frame tiles a block
constexpr int kCostMinBlocksPerSM = 3;              // cost kernel: <= 85 registers a thread
constexpr int kRowStride = 20;                      // 12 A + 6 B + weighted residual + 0
constexpr int kUpperU = 78;                         // 12 * 13 / 2
constexpr int kUpperV = 21;                         // 6 * 7 / 2
constexpr int kPairs = 15;                          // upper pairs of 5 column blocks
constexpr int kReduceThreads = 256;
constexpr int kCamPack = 18;                        // fx fy cx cy k1 k2 | t_c | R_c
// A frame's outputs other than U, staged in its rows' shared memory once its
// Gram is done: W (72) | g_cam (12) | g_pose (6) | upper V (21).
constexpr int kStageGcam = 72, kStageGpose = 84, kStageV = 90, kStaged = 111;

// (row, col) of each entry of the row-major upper triangle of a 12 x 12 / 6 x 6
// matrix, and the (row block, column block) of each 4-column Gram tile.
__constant__ uint8_t kUpper12[kUpperU][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {0, 6}, {0, 7}, {0, 8}, {0, 9},
    {0, 10}, {0, 11}, {1, 1}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
    {1, 9}, {1, 10}, {1, 11}, {2, 2}, {2, 3}, {2, 4}, {2, 5}, {2, 6}, {2, 7}, {2, 8},
    {2, 9}, {2, 10}, {2, 11}, {3, 3}, {3, 4}, {3, 5}, {3, 6}, {3, 7}, {3, 8}, {3, 9},
    {3, 10}, {3, 11}, {4, 4}, {4, 5}, {4, 6}, {4, 7}, {4, 8}, {4, 9}, {4, 10}, {4, 11},
    {5, 5}, {5, 6}, {5, 7}, {5, 8}, {5, 9}, {5, 10}, {5, 11}, {6, 6}, {6, 7}, {6, 8},
    {6, 9}, {6, 10}, {6, 11}, {7, 7}, {7, 8}, {7, 9}, {7, 10}, {7, 11}, {8, 8}, {8, 9},
    {8, 10}, {8, 11}, {9, 9}, {9, 10}, {9, 11}, {10, 10}, {10, 11}, {11, 11}};
__constant__ uint8_t kUpper6[kUpperV][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {1, 1}, {1, 2}, {1, 3}, {1, 4}, {1, 5},
    {2, 2}, {2, 3}, {2, 4}, {2, 5}, {3, 3}, {3, 4}, {3, 5}, {4, 4}, {4, 5}, {5, 5}};
__constant__ uint8_t kBlockPair[kPairs][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {1, 1}, {1, 2}, {1, 3},
    {1, 4}, {2, 2}, {2, 3}, {2, 4}, {3, 3}, {3, 4}, {4, 4}};

// Shared floats of one frame in the block kernel: its 2N rows, and room for the
// kStaged outputs when N < 3.
__host__ __device__ __forceinline__ int frame_smem_floats(int N) {
  return (2 * N > 6 ? 2 * N : 6) * kRowStride;
}

// Index of (a, b), a <= b, in the row-major upper triangle of an n x n matrix.
__device__ __forceinline__ int upper_index(int a, int b, int n) {
  return a * n - a * (a - 1) / 2 + (b - a);
}

// I + p K + q K @ K, K = skew(r), row-major: the shape of both so3_exp and the
// left Jacobian (ops/rotation.py). K @ K is the matrix product, as the twin's.
__device__ __forceinline__ void i_plus_skew_poly(const double r[3], double p, double q,
                                                 double out[9]) {
  const double K[9] = {0.0, -r[2], r[1], r[2], 0.0, -r[0], -r[1], r[0], 0.0};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      out[3 * i + j] = (i == j ? 1.0 : 0.0) + p * K[3 * i + j] + q * kk;
    }
  }
}

// R = so3_exp(r) in f64 and, if jl is given, J_l(r) evaluated in f64 and
// rounded to f32 (ops/rotation.py: R = I + a K + b K^2, J_l = I + b K + c K^2,
// a = sin t / t, b = (1 - cos t) / t^2, c = (t - sin t) / t^3, with the series
// below theta^2 = 1e-8). One sincos serves both.
__device__ __forceinline__ void rotation_pack(const double r[3], double R[9], float* jl) {
  const double t2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
  double a, b, c;
  if (t2 < 1e-8) {
    a = 1.0 - t2 / 6.0;
    b = 0.5 - t2 / 24.0;
    c = 1.0 / 6.0 - t2 / 120.0;
  } else {
    const double t = sqrt(t2);
    double sn, cs;
    sincos(t, &sn, &cs);
    a = sn / t;
    b = (1.0 - cs) / t2;
    c = (t - sn) / (t2 * t);
  }
  i_plus_skew_poly(r, a, b, R);
  if (jl != nullptr) {
    double J[9];
    i_plus_skew_poly(r, b, c, J);
#pragma unroll
    for (int k = 0; k < 9; ++k) jl[k] = (float)J[k];
  }
}

struct Chain {
  double q[3];          // camera-frame point R_c p_w + t_c
  double z;             // depth, forced to 1 for masked points and |z| < 1e-12
  double x, y, r2, s;   // normalized point, squared radius, radial factor
  double xd, yd;        // distorted normalized point
  double ru, rv;        // residual obs - pred (0 where masked)
};

__device__ __forceinline__ void chain_residual(const double* cam, const double pw[3],
                                               double ou, double ov, bool live,
                                               Chain& ch) {
  const double* R = cam + 9;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ch.q[i] = R[3 * i] * pw[0] + R[3 * i + 1] * pw[1] + R[3 * i + 2] * pw[2] + cam[6 + i];
  }
  double z = ch.q[2];
  if (!live || fabs(z) < 1e-12) z = 1.0;
  ch.z = z;
  const double iz = 1.0 / z;
  ch.x = ch.q[0] * iz;
  ch.y = ch.q[1] * iz;
  ch.r2 = ch.x * ch.x + ch.y * ch.y;
  ch.s = 1.0 + ch.r2 * (cam[4] + ch.r2 * cam[5]);
  ch.xd = ch.x * ch.s;
  ch.yd = ch.y * ch.s;
  ch.ru = live ? ou - (cam[0] * ch.xd + cam[2]) : 0.0;
  ch.rv = live ? ov - (cam[1] * ch.yd + cam[3]) : 0.0;
}

// Robust cost fragment rho and IRLS weight sqrt(rho') of one residual
// component (f32), the counterpart of ba_pallas.py:_robust_rho_w.
__device__ __forceinline__ void robust_rho_w(float r, float fs2, int linear,
                                             float& rho, float& w) {
  if (linear) {
    w = 1.0f;
    rho = 0.5f * (r * r);
  } else {
    const float sq = sqrtf(1.0f + (r * r) / fs2);
    w = rsqrtf(sq);
    rho = fs2 * (sq - 1.0f);
  }
}

// Sum over the warp's lanes by a fixed xor-shuffle tree; every lane gets it.
template <class T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// World point p_w = R_p b + t_p and R_p b of board point b (pose pack P).
__device__ __forceinline__ void world_point(const double* P, const double b[3],
                                            double pw[3], double rb[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    rb[i] = P[3 * i] * b[0] + P[3 * i + 1] * b[1] + P[3 * i + 2] * b[2];
    pw[i] = rb[i] + P[9 + i];
  }
}

// One thread's board point of a (camera, frame tile) block: frame f0 + fl of
// the tile, point n of the board.
struct TilePoint {
  int fl, n;
  bool ok;              // inside the tile and below F
  bool live;            // observed
  double ou, ov;        // the observation (0 where not ok)
  double b[3];          // the board point
};

// Thread t's point of the tile at frame f0 of camera c, with its mask,
// observation pair (one 16-byte load) and board point. Both kernels call this
// before the packs so that the loads' latency overlaps the rotations.
__device__ __forceinline__ TilePoint load_tile_point(const double* __restrict__ objp,
                                                     const double* __restrict__ obs,
                                                     const uint8_t* __restrict__ msk, int c,
                                                     int f0, int F, int N, int P, int t) {
  TilePoint tp;
  tp.fl = t / N;
  tp.n = t - tp.fl * N;
  tp.ok = tp.fl < P && f0 + tp.fl < F;
  tp.live = false;
  tp.ou = tp.ov = 0.0;
  tp.b[0] = tp.b[1] = tp.b[2] = 0.0;
  if (tp.ok) {
    const size_t o = ((size_t)c * F + f0 + tp.fl) * N + tp.n;
    tp.live = msk[o] != 0;
    const double2 uv = reinterpret_cast<const double2*>(obs)[o];
    tp.ou = uv.x;
    tp.ov = uv.y;
#pragma unroll
    for (int i = 0; i < 3; ++i) tp.b[i] = objp[3 * tp.n + i];
  }
  return tp;
}

// The packs of one block into shared memory: the camera's (kCamPack f64: fx fy
// cx cy k1 k2 | t_c | R_c row-major) and those of the P < 32 frames from f0 (12
// f64 each: R_p row-major | t_p). Warp 0 computes the frames' rotations on
// lanes < P and the camera's on lane 31, one code path for all; warps 1 and 2
// copy the scalars. With kJl also the left Jacobians J_l(r_c), J_l(rho_p)
// (f32). The caller synchronizes the block.
template <bool kJl>
__device__ __forceinline__ void tile_packs(const double* __restrict__ cam_c,
                                           const double* __restrict__ pose, int f0, int F,
                                           int P, int warp, int lane, double* s_cam,
                                           double (*s_pose)[12], float* s_jlc,
                                           float (*s_jlp)[9]) {
  if (warp == 0) {
    const bool cam_lane = lane == 31;
    if (cam_lane || (lane < P && f0 + lane < F)) {
      const double* rv = cam_lane ? cam_c + 6 : pose + (size_t)(f0 + lane) * 6;
      const double r[3] = {rv[0], rv[1], rv[2]};
      float* jl = nullptr;
      if constexpr (kJl) jl = cam_lane ? s_jlc : s_jlp[lane];
      rotation_pack(r, cam_lane ? s_cam + 9 : s_pose[lane], jl);
    }
  } else if (warp == 1) {
    if (lane < 6) s_cam[lane] = cam_c[lane];                // fx fy cx cy k1 k2
    else if (lane < 9) s_cam[lane] = cam_c[lane + 3];       // t_c
  } else if (warp == 2) {
    for (int j = lane; j < 3 * P; j += 32) {
      const int k = j / 3, i = j - 3 * k;
      if (f0 + k < F) s_pose[k][9 + i] = pose[(size_t)(f0 + k) * 6 + 3 + i];   // t_p
    }
  }
}

// Robust cost of a point's residual pair (f32, from the f64 chain).
__device__ __forceinline__ float residual_cost(const Chain& ch, float fs2, int linear) {
  float cost = 0.0f, rho, w;
  robust_rho_w((float)ch.ru, fs2, linear, rho, w);
  cost += rho;
  robust_rho_w((float)ch.rv, fs2, linear, rho, w);
  cost += rho;
  return cost;
}

// The cost of frame `warp` of the tile from its points' costs s_rho[warp * N +
// n]: lane l adds points l and l + 32 (N <= 64), then the shuffle tree. Every
// lane of the warp calls it and gets the sum.
__device__ __forceinline__ float frame_cost(const float* s_rho, int warp, int lane, int N,
                                            bool frame_ok) {
  float cost_lane = 0.0f;
  if (frame_ok) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int m = lane + 32 * j;
      if (m < N) cost_lane += s_rho[warp * N + m];
    }
  }
  return warp_sum(cost_lane);
}

// The two weighted rows (u, v) of one observed point, written to row and
// row + kRowStride; returns the point's robust cost. f32 Jacobian rows from the
// f64 chain (lm_core._analytic_pred_and_jacs).
__device__ __forceinline__ float point_rows(const double* cp, const float* jlc,
                                            const double* P, const float* jlp,
                                            const double b[3], double ou, double ov,
                                            float fs2, int linear, float* row) {
  double pw[3], rbd[3];
  world_point(P, b, pw, rbd);
  Chain ch;
  chain_residual(cp, pw, ou, ov, true, ch);
  const float fx = (float)cp[0], fy = (float)cp[1];
  const float k1 = (float)cp[4], k2 = (float)cp[5];
  const float x = (float)ch.x, y = (float)ch.y, r2 = (float)ch.r2;
  const float s = (float)ch.s, iz = 1.0f / (float)ch.z;
  const float sp = k1 + 2.0f * k2 * r2;
  const float d11 = s + 2.0f * x * x * sp;
  const float d12 = 2.0f * x * y * sp;
  const float d22 = s + 2.0f * y * y * sp;
  const float fxz = fx * iz, fyz = fy * iz;
  const float M[2][3] = {{d11 * fxz, d12 * fxz, -(d11 * x + d12 * y) * fxz},
                         {d12 * fyz, d22 * fyz, -(d12 * x + d22 * y) * fyz}};
  // R_c p_w = q - t_c, both cast to f32 first (the twin's w_cam)
  const float wc[3] = {(float)ch.q[0] - (float)cp[6], (float)ch.q[1] - (float)cp[7],
                       (float)ch.q[2] - (float)cp[8]};
  const float rb[3] = {(float)rbd[0], (float)rbd[1], (float)rbd[2]};
  const float xd = (float)ch.xd, yd = (float)ch.yd;
  const float r[2] = {(float)ch.ru, (float)ch.rv};
  float cost = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float rho, w;
    robust_rho_w(r[k], fs2, linear, rho, w);
    cost += rho;
    const float* m = M[k];
    // d pred / d rotation of the camera: cross(R_c p_w, m) . J_l(r_c)
    const float cr[3] = {wc[1] * m[2] - wc[2] * m[1], wc[2] * m[0] - wc[0] * m[2],
                         wc[0] * m[1] - wc[1] * m[0]};
    // d pred / d t_p: m . R_c ; d pred / d rho_p: cross(R_p b, m R_c) . J_l(rho_p)
    float mc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      mc[i] = m[0] * (float)cp[9 + i] + m[1] * (float)cp[12 + i] + m[2] * (float)cp[15 + i];
    }
    const float crb[3] = {rb[1] * mc[2] - rb[2] * mc[1], rb[2] * mc[0] - rb[0] * mc[2],
                          rb[0] * mc[1] - rb[1] * mc[0]};
    const float f_k = k == 0 ? fx : fy;
    const float xy_k = k == 0 ? x : y;
    float a[kRowStride];
    a[0] = k == 0 ? xd : 0.0f;           // d/dfx
    a[1] = k == 0 ? 0.0f : yd;           // d/dfy
    a[2] = k == 0 ? 1.0f : 0.0f;         // d/dcx
    a[3] = k == 0 ? 0.0f : 1.0f;         // d/dcy
    a[4] = f_k * xy_k * r2;              // d/dk1
    a[5] = f_k * xy_k * r2 * r2;         // d/dk2
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[6 + i] = cr[0] * jlc[i] + cr[1] * jlc[3 + i] + cr[2] * jlc[6 + i];
      a[9 + i] = m[i];                                                    // d/dt_c
      a[12 + i] = crb[0] * jlp[i] + crb[1] * jlp[3 + i] + crb[2] * jlp[6 + i];
      a[15 + i] = mc[i];
    }
#pragma unroll
    for (int i = 0; i < 18; ++i) a[i] *= w;
    a[18] = r[k] * w;
    a[19] = 0.0f;
    float4* dst = reinterpret_cast<float4*>(row + k * kRowStride);
#pragma unroll
    for (int i = 0; i < kRowStride / 4; ++i) {
      dst[i] = make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
    }
  }
  return cost;
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
ba_blocks_kernel(const double* __restrict__ cam, const double* __restrict__ pose,
                 const double* __restrict__ objp, const double* __restrict__ obs,
                 const uint8_t* __restrict__ msk, int C, int F, int N, int P, float fs2,
                 int linear, float* __restrict__ u_part, float* __restrict__ v_part,
                 float* __restrict__ w_out, float* __restrict__ gcam_out,
                 float* __restrict__ gpose_out, float* __restrict__ cost_out) {
  extern __shared__ float4 rows_smem[];                // [P][frame_floats]
  __shared__ double s_cam[kCamPack];                   // the camera's pack, J_l(r_c)
  __shared__ float s_jlc[9];
  __shared__ double s_pose[kWarps][12];                // each frame's pack, J_l(rho_p)
  __shared__ float s_jlp[kWarps][9];
  __shared__ float s_rho[kThreads];                    // each point's robust cost
  __shared__ float s_u[kWarps][kUpperU];
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int c = blockIdx.y;
  const int tiles = gridDim.x;
  const int f0 = blockIdx.x * P;
  float* rows = reinterpret_cast<float*>(rows_smem);
  const int frame_floats = frame_smem_floats(N);

  // This thread's board point; its loads start before the packs.
  const TilePoint tp = load_tile_point(objp, obs, msk, c, f0, F, N, P, t);
  tile_packs<true>(cam + (size_t)c * 12, pose, f0, F, P, warp, lane, s_cam, s_pose, s_jlc,
                   s_jlp);
  __syncthreads();

  // --- weighted rows, two per board point, every point of the tile at once
  if (tp.ok) {
    float* row = rows + (size_t)tp.fl * frame_floats + 2 * tp.n * kRowStride;
    float rho = 0.0f;
    if (tp.live) {
      rho = point_rows(s_cam, s_jlc, s_pose[tp.fl], s_jlp[tp.fl], tp.b, tp.ou, tp.ov, fs2,
                       linear, row);
    } else {
      float4* dst = reinterpret_cast<float4*>(row);
#pragma unroll
      for (int i = 0; i < 2 * kRowStride / 4; ++i) dst[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    s_rho[t] = rho;
  }
  __syncthreads();

  // --- the Gram of frame f0 + warp: lanes 2p and 2p+1 own column blocks
  // kBlockPair[p], rows [0, N) and [N, 2N) respectively
  if (warp < P) {
    const int f = f0 + warp;
    const bool frame_ok = f < F;                            // warp-uniform
    const size_t cf = (size_t)c * F + f;
    float* frows = rows + (size_t)warp * frame_floats;
    const int pair = lane >> 1, half = lane & 1;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
    int bi = 0, bj = 0;
    if (pair < kPairs) {
      bi = kBlockPair[pair][0];
      bj = kBlockPair[pair][1];
    }
    if (frame_ok && pair < kPairs) {
      const float* pa = frows + (size_t)half * N * kRowStride + 4 * bi;
      const float* pb = frows + (size_t)half * N * kRowStride + 4 * bj;
      for (int r = 0; r < N; ++r) {
        const float4 xa = *reinterpret_cast<const float4*>(pa + r * kRowStride);
        const float4 xb = *reinterpret_cast<const float4*>(pb + r * kRowStride);
        const float va[4] = {xa.x, xa.y, xa.z, xa.w};
        const float vb[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(va[i], vb[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
    }

    // outputs: half 0 takes tile rows 0-1, half 1 rows 2-3. U goes to the
    // tile's shared sum (zeros for frames past F); the rest is staged in the
    // frame's rows, now read, and written out below in coalesced runs.
    __syncwarp();
    if (pair < kPairs) {
      float* us = s_u[warp];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((i >> 1) != half) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int a = 4 * bi + i, bc = 4 * bj + j;
          if (a > bc || bc == 19 || a == 18) continue;   // lower half, pad column, r.r
          const float v = acc[i][j];
          if (bc < 12) us[upper_index(a, bc, 12)] = v;
          else if (a < 12) frows[bc < 18 ? a * 6 + (bc - 12) : kStageGcam + a] = v;
          else if (bc < 18) frows[kStageV + upper_index(a - 12, bc - 12, 6)] = v;
          else frows[kStageGpose + (a - 12)] = v;
        }
      }
    }
    __syncwarp();
    if (frame_ok) {
      for (int k = lane; k < kStageGcam; k += 32) w_out[cf * 72 + k] = frows[k];
      if (lane < 12) gcam_out[cf * 12 + lane] = frows[kStageGcam + lane];
      if (lane < 6) gpose_out[cf * 6 + lane] = frows[kStageGpose + lane];
      if (lane < kUpperV) v_part[cf * kUpperV + lane] = frows[kStageV + lane];
    }
    const float cost = frame_cost(s_rho, warp, lane, N, frame_ok);
    if (frame_ok && lane == 0) cost_out[cf] = cost;
  }
  __syncthreads();

  // --- U of this (camera, tile): the sum over the tile's frames in order,
  // stored (C, 78, tiles) so that the reduce kernel reads it contiguously
  if (t < kUpperU) {
    float u = 0.0f;
    for (int w = 0; w < P; ++w) u += s_u[w][t];
    u_part[((size_t)c * kUpperU + t) * tiles + blockIdx.x] = u;
  }
}

// V (F, 6, 6) = sum over cameras of v_part (C, F, 21), in camera order; U (C,
// 12, 12) = sum over tiles of u_part (C, 78, tiles): lane l sums tiles l, l+32,
// ... in order, then a fixed xor-shuffle tree. Blocks [0, v_blocks) do V.
__global__ void __launch_bounds__(kReduceThreads)
ba_reduce_kernel(const float* __restrict__ u_part, const float* __restrict__ v_part,
                 int C, int F, int tiles, int v_blocks, float* __restrict__ u_out,
                 float* __restrict__ v_out) {
  if ((int)blockIdx.x < v_blocks) {
    const int i = blockIdx.x * kReduceThreads + threadIdx.x;
    if (i >= F * kUpperV) return;
    const int f = i / kUpperV, t = i - f * kUpperV;
    float v = 0.0f;
    for (int c = 0; c < C; ++c) v += v_part[((size_t)c * F + f) * kUpperV + t];
    const int a = kUpper6[t][0], b = kUpper6[t][1];
    v_out[(size_t)f * 36 + a * 6 + b] = v;
    v_out[(size_t)f * 36 + b * 6 + a] = v;
    return;
  }
  const int w = ((blockIdx.x - v_blocks) * kReduceThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= C * kUpperU) return;                            // warp-uniform
  const float* src = u_part + (size_t)w * tiles;
  float u = 0.0f;
  for (int k = lane; k < tiles; k += 32) u += src[k];
  u = warp_sum(u);
  if (lane == 0) {
    const int c = w / kUpperU, t = w - c * kUpperU;
    const int a = kUpper12[t][0], b = kUpper12[t][1];
    u_out[(size_t)c * 144 + a * 12 + b] = u;
    u_out[(size_t)c * 144 + b * 12 + a] = u;
  }
}

// Per-try cost: the block kernel's front end on a grid (groups of kCostTiles
// frame tiles, cameras). A thread takes the same board point of each of the
// block's tiles (independent chains, in flight together), a warp the same
// frame of each tile for the frame's sum. cost_out (C, F) gets every fragment,
// part[block] the f64 sum of the block's fragments, and total_out the sum of
// all of part, added by the last block to arrive. *ticket counts the arrivals:
// 0 before the launch, and 0 again after it (launches that share a ticket must
// be ordered on one stream).
__global__ void __launch_bounds__(kThreads, kCostMinBlocksPerSM)
ba_cost_kernel(const double* __restrict__ cam, const double* __restrict__ pose,
               const double* __restrict__ objp, const double* __restrict__ obs,
               const uint8_t* __restrict__ msk, int C, int F, int N, int P, float fs2,
               int linear, float* __restrict__ cost_out, double* part,
               double* __restrict__ total_out, unsigned int* __restrict__ ticket) {
  static_assert(kCostTiles * kWarps < 32, "lane 31 of warp 0 computes the camera's pack");
  __shared__ double s_cam[kCamPack];
  __shared__ double s_pose[kCostTiles * kWarps][12];
  __shared__ float s_rho[kCostTiles][kThreads];
  __shared__ double s_sum[kWarps];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int c = blockIdx.y;
  const int f0 = blockIdx.x * kCostTiles * P;

  TilePoint tp[kCostTiles];
#pragma unroll
  for (int j = 0; j < kCostTiles; ++j) {
    tp[j] = load_tile_point(objp, obs, msk, c, f0 + j * P, F, N, P, t);
  }
  tile_packs<false>(cam + (size_t)c * 12, pose, f0, F, kCostTiles * P, warp, lane, s_cam,
                    s_pose, nullptr, nullptr);
  __syncthreads();

  // --- each point's cost; masked points never enter the chain
#pragma unroll
  for (int j = 0; j < kCostTiles; ++j) {
    float rho = 0.0f;
    if (tp[j].live) {
      double pw[3], rbd[3];
      world_point(s_pose[j * P + tp[j].fl], tp[j].b, pw, rbd);
      Chain ch;
      chain_residual(s_cam, pw, tp[j].ou, tp[j].ov, true, ch);
      rho = residual_cost(ch, fs2, linear);
    }
    s_rho[j][t] = rho;
  }
  __syncthreads();

  // --- the fragments of frames f0 + j P + warp, and their f64 sum per warp
  double warp_total = 0.0;
  if (warp < P) {
#pragma unroll
    for (int j = 0; j < kCostTiles; ++j) {
      const int f = f0 + j * P + warp;
      const bool frame_ok = f < F;                          // warp-uniform
      const float cost = frame_cost(s_rho[j], warp, lane, N, frame_ok);
      if (frame_ok && lane == 0) {
        cost_out[(size_t)c * F + f] = cost;
        warp_total += (double)cost;
      }
    }
  }
  if (lane == 0) s_sum[warp] = warp_total;
  __syncthreads();

  // --- the block's sum, published before its ticket is drawn
  const unsigned int n_blocks = gridDim.x * gridDim.y;
  if (t == 0) {
    double block_total = 0.0;
    for (int w = 0; w < kWarps; ++w) block_total += s_sum[w];
    part[blockIdx.y * gridDim.x + blockIdx.x] = block_total;
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == n_blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;                                      // block-uniform

  // --- the last block: every block's sum is in device memory; add them
  __threadfence();
  double acc = 0.0;
  for (unsigned int i = t; i < n_blocks; i += kThreads) acc += __ldcg(part + i);
  acc = warp_sum(acc);
  if (lane == 0) s_sum[warp] = acc;
  __syncthreads();
  if (t == 0) {
    double total = 0.0;
    for (int w = 0; w < kWarps; ++w) total += s_sum[w];
    *total_out = total;
    *ticket = 0u;
  }
}

// Frames per block of both kernels: every board point of the tile gets a
// thread, and every frame a warp for its Gram and its cost sum (N <= 64 gives
// at least 4).
int frames_per_block(int N) { return kThreads / N < kWarps ? kThreads / N : kWarps; }

int tiles_of(int F, int per_tile) { return (F + per_tile - 1) / per_tile; }


}  // namespace

extern "C" {

const char* ba_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// f32 scratch ba_blocks_launch needs for C cameras, F frames and N board points:
// the per-(c, f) V fragments and the per-(camera, tile) U sums.
long long ba_blocks_scratch_floats(int C, int F, int N) {
  return (long long)C * F * kUpperV + (long long)C * kUpperU * tiles_of(F, frames_per_block(N));
}

// Inputs: cam (C, 12), pose (F, 6), objp (N, 3), obs (C, F, N, 2) f64, msk
// (C, F, N) u8, all contiguous. Outputs: u (C, 12, 12), v (F, 6, 6), w (C, F, 12,
// 6), gcam (C, F, 12), gpose (C, F, 6), cost (C, F); all f32, all written in
// full. scratch: ba_blocks_scratch_floats(C, F, N) f32. Two launches.
int ba_blocks_launch(const void* cam, const void* pose, const void* objp, const void* obs,
                     const void* msk, int C, int F, int N, double f_scale, int loss_linear,
                     void* u, void* v, void* w, void* gcam, void* gpose, void* cost,
                     void* scratch, void* stream) {
  const int P = frames_per_block(N);
  const int tiles = tiles_of(F, P);
  float* v_part = (float*)scratch;
  float* u_part = v_part + (size_t)C * F * kUpperV;
  const size_t smem = (size_t)P * frame_smem_floats(N) * sizeof(float);   // <= 40 KB
  ba_blocks_kernel<<<dim3(tiles, C), kThreads, smem, (cudaStream_t)stream>>>(
      (const double*)cam, (const double*)pose, (const double*)objp, (const double*)obs,
      (const uint8_t*)msk, C, F, N, P, (float)(f_scale * f_scale), loss_linear, u_part,
      v_part, (float*)w, (float*)gcam, (float*)gpose, (float*)cost);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int v_blocks = (F * kUpperV + kReduceThreads - 1) / kReduceThreads;
  const int u_blocks = (C * kUpperU * 32 + kReduceThreads - 1) / kReduceThreads;
  ba_reduce_kernel<<<v_blocks + u_blocks, kReduceThreads, 0, (cudaStream_t)stream>>>(
      u_part, v_part, C, F, tiles, v_blocks, (float*)u, (float*)v);
  return (int)cudaGetLastError();
}

// f64 scratch ba_cost_launch needs: one sum per block.
long long ba_cost_scratch_doubles(int C, int F, int N) {
  return (long long)C * tiles_of(F, kCostTiles * frames_per_block(N));
}

// Inputs as ba_blocks_launch. Outputs: cost (C, F) f32 and total, one f64, the
// sum of the fragments. scratch: ba_cost_scratch_doubles(C, F, N) f64. ticket:
// one u32 that is 0 and that no launch in flight on another stream shares; the
// kernel leaves it 0. One launch.
int ba_cost_launch(const void* cam, const void* pose, const void* objp, const void* obs,
                   const void* msk, int C, int F, int N, double f_scale, int loss_linear,
                   void* cost, void* total, void* scratch, void* ticket, void* stream) {
  const int P = frames_per_block(N);
  ba_cost_kernel<<<dim3(tiles_of(F, kCostTiles * P), C), kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)cam, (const double*)pose, (const double*)objp, (const double*)obs,
      (const uint8_t*)msk, C, F, N, P, (float)(f_scale * f_scale), loss_linear, (float*)cost,
      (double*)scratch, (double*)total, (unsigned int*)ticket);
  return (int)cudaGetLastError();
}

}  // extern "C"
