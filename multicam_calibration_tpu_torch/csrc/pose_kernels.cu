// Planar-pose Gauss-Newton polish for NVIDIA Hopper (sm_90a), plain C ABI.
//
// It replaces no TPU kernel: the JAX package's _refine_poses_gn
// (multicam_calibration_tpu/models/initialize.py) is jnp that XLA fuses on the
// TPU. Its plain PyTorch twin (models/initialize.py: _polish_poses, vmapped
// over cameras by ops/pose_cuda.pose_gn_refine_reference) dispatches every
// step of that polish from the host, thousands of small launches a call.
// pose_gn_kernel does the whole polish of a slab in one launch:
//
//   for every camera-frame (one warp each; lane l takes board points l,
//   l + 32, l + 64, ..., so a board of any size N fits):
//     branch A: 10 Gauss-Newton steps from the homography pose;
//     the planar twin of A's result (initialize.py: _twin_planar_pose);
//     branch B: 10 Gauss-Newton steps from the twin;
//     both squared errors, B where err_b < err_a, else A;
//   a frame whose mask is false is written as NaN without iterating.
//
// Each step is the twin's, in its order of operations where that is cheap:
//   - the residual (uvs - pred) of lm_core._predict with identity camera
//     extrinsics: R = so3_exp(r) with its series below theta^2 = 1e-8, p = R b
//     + t, x = p0 / p2, y = p1 / p2, radial 1 + r2 (k1 + r2 k2), fx, fy, cx, cy;
//   - its 6 exact derivatives in the axis-angle + translation pose, the
//     forward-mode derivatives of those same formulas (dR / dr_k from the
//     derivatives of so3_exp's coefficients, then the chain), as torch.func's
//     jacfwd takes them: not a left-perturbation or small-angle Jacobian;
//   - the 21 upper entries of J^T J and the 6 of J^T r, summed over the lane's
//     points in their order and then over the warp by a fixed xor-shuffle
//     tree, which leaves the same bits in every lane;
//   - the ridge 1e-8 I, a 6 x 6 Cholesky whose factor is NaN when a pivot is
//     not positive (lm_core._cholesky), two triangular solves, pose -= step.
//     Every lane factors and solves redundantly, so nothing is broadcast.
//     The derivatives and the factor multiply by reciprocals (1 / depth, 1 /
//     each diagonal entry, as LAPACK's unblocked Cholesky scales a column),
//     where the twin divides: f64 division is a long sequence on the card.
// All arithmetic is f64: the twin runs in f64, Hopper has native f64, and the
// work is bound by latency, not by operations.
//
// Bounds on the H100: at the rolling update's slab (64 cameras x 8 frames x 35
// points) the kernel does ~0.1 GFLOP of f64 (~3 us at 34 TFLOP/s) and moves
// ~0.3 MB (~0.1 us at 3.35 TB/s). Neither bounds it: a camera-frame is a chain
// of 20 dependent steps, each a forward pass, 27 shuffle trees of 5 levels, a
// Cholesky of 6 square roots and the divisions of two triangular solves, so
// the time is the launch's latency plus that chain's. What the design does
// about it: one launch per slab instead of ~20 host-dispatched batched steps;
// one warp per camera-frame, so the slab's 512 chains run side by side; the
// camera's intrinsics and the pose live in registers (the intrinsics read by
// camera index, so the (C, F) grid needs no expanded copies); each step reads
// the frame's points and detections again, 40 bytes a point, from L1, where
// the frame's first step left them, so registers do not bound N. Left out:
// early exit on convergence, which would be a different result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                     // camera-frames a block
constexpr int kThreads = 32 * kWarps;
constexpr int kIters = 10;                    // Gauss-Newton steps a branch
constexpr int kSums = 27;                     // upper J^T J (21) | J^T r (6)
constexpr double kRidge = 1e-8;
constexpr double kSmallAngle = 1e-8;          // ops/rotation.py _SMALL_ANGLE

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }

// so3_exp's coefficients a = sin t / t and b = (1 - cos t) / t^2 at t2 = t^2,
// with their series below kSmallAngle, and their derivatives in t2.
__device__ __forceinline__ void so3_coeffs(double t2, double& a, double& b, double& da,
                                           double& db) {
  if (t2 < kSmallAngle) {
    a = 1.0 - t2 / 6.0;
    b = 0.5 - t2 / 24.0;
    da = -1.0 / 6.0;
    db = -1.0 / 24.0;
  } else {
    const double t = sqrt(t2);
    double sn, cs;
    sincos(t, &sn, &cs);
    a = sn / t;
    b = (1.0 - cs) / t2;
    da = (cs - a) / (2.0 * t2);
    db = (a - 2.0 * b) / (2.0 * t2);
  }
}

// Row-major skew(r).
__device__ __forceinline__ void skew(const double r[3], double K[9]) {
  K[0] = 0.0;   K[1] = -r[2]; K[2] = r[1];
  K[3] = r[2];  K[4] = 0.0;   K[5] = -r[0];
  K[6] = -r[1]; K[7] = r[0];  K[8] = 0.0;
}

// Row-major skew(r) and its matrix square K @ K.
__device__ __forceinline__ void skew_and_square(const double r[3], double K[9], double KK[9]) {
  skew(r, K);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      KK[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
    }
  }
}

// R = so3_exp(r) = (I + a K) + b K @ K, row-major (ops/rotation.py), and, if
// dR is given, dR[k] = dR / dr_k (k < 3): with t2 = r . r, dt2 / dr_k = 2 r_k,
// and E_k = skew(e_k),
//   dR / dr_k = 2 r_k (da K + db K K) + a E_k + b (E_k K + K E_k).
__device__ __forceinline__ void so3_exp(const double r[3], double R[9],
                                        double (*dR)[9] = nullptr) {
  double a, b, da, db, K[9], KK[9];
  so3_coeffs(r[0] * r[0] + r[1] * r[1] + r[2] * r[2], a, b, da, db);
  skew_and_square(r, K, KK);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = ((k % 4 == 0 ? 1.0 : 0.0) + a * K[k]) + b * KK[k];
  if (dR == nullptr) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    double e[3] = {0.0, 0.0, 0.0}, E[9];
    e[k] = 1.0;
    skew(e, E);
    const double dt2 = 2.0 * r[k];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        double sym = 0.0;
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          sym += E[3 * i + m] * K[3 * m + j] + K[3 * i + m] * E[3 * m + j];
        }
        dR[k][3 * i + j] = dt2 * (da * K[3 * i + j] + db * KK[3 * i + j]) + a * E[3 * i + j] +
                           b * sym;
      }
    }
  }
}

// so3_log of ops/rotation.py: Shepperd's candidate with the largest diagonal
// term (the first maximum, as torch.argmax), normalized to w >= 0, then
// 2 atan2(|v|, w) / |v| * v, or 2 / max(w, 1e-30) * v below |v| = 1e-8.
__device__ __forceinline__ void so3_log(const double R[9], double out[3]) {
  const double m00 = R[0], m01 = R[1], m02 = R[2];
  const double m10 = R[3], m11 = R[4], m12 = R[5];
  const double m20 = R[6], m21 = R[7], m22 = R[8];
  const double ts[4] = {1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22};
  int best = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (ts[i] > ts[best]) best = i;
  }
  double q[4];
  if (best == 0) {
    q[0] = ts[0]; q[1] = m21 - m12; q[2] = m02 - m20; q[3] = m10 - m01;
  } else if (best == 1) {
    q[0] = m21 - m12; q[1] = ts[1]; q[2] = m01 + m10; q[3] = m02 + m20;
  } else if (best == 2) {
    q[0] = m02 - m20; q[1] = m01 + m10; q[2] = ts[2]; q[3] = m12 + m21;
  } else {
    q[0] = m10 - m01; q[1] = m02 + m20; q[2] = m12 + m21; q[3] = ts[3];
  }
  const double qn = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double sgn = q[0] / qn < 0.0 ? -1.0 : 1.0;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / qn * sgn;
  const double n = sqrt(q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double scale = n < 1e-8 ? 2.0 / clamp_min(q[0], 1e-30) : 2.0 * atan2(n, q[0]) / n;
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = q[1 + i] * scale;
}

// The other solution of the planar-pose ambiguity (initialize.py:
// _twin_planar_pose): the board normal n reflects across the line of sight v,
// n -> 2 (v . n) v - n, by a rotation about n x n2 applied on the left.
__device__ void twin_planar_pose(const double p[6], double out[6]) {
  double R[9];
  so3_exp(p, R);
  const double* t = p + 3;
  const double n[3] = {R[2], R[5], R[8]};
  const double tn = clamp_min(sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]), 1e-12);
  const double v[3] = {t[0] / tn, t[1] / tn, t[2] / tn};
  const double dot = v[0] * n[0] + v[1] * n[1] + v[2] * n[2];
  double n2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) n2[i] = 2.0 * dot * v[i] - n[i];
  const double axis[3] = {n[1] * n2[2] - n[2] * n2[1], n[2] * n2[0] - n[0] * n2[2],
                          n[0] * n2[1] - n[1] * n2[0]};
  const double sn = sqrt(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]);
  double cs = n[0] * n2[0] + n[1] * n2[1] + n[2] * n2[2];
  cs = cs > 1.0 ? 1.0 : clamp_min(cs, -1.0);
  const double angle = atan2(sn, cs);
  const double inv = clamp_min(sn, 1e-12);
  double r_align[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) r_align[i] = sn > 1e-8 ? axis[i] / inv * angle : 0.0;
  double A[9], T[9];
  so3_exp(r_align, A);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T[3 * i + j] = A[3 * i] * R[j] + A[3 * i + 1] * R[3 + j] + A[3 * i + 2] * R[6 + j];
    }
  }
  so3_log(T, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = t[i];
}

// A camera-frame's N board points (N, 3) and detections (N, 2), in global
// memory.
struct Frame {
  const double* b;
  const double* o;
  int N;
};

// Prediction of board point b under pose (R, t) and intrinsics k (fx fy cx cy
// k1 k2), as lm_core._predict (x and y by division, as the twin); the camera
// point, 1 / depth, the normalized point, squared radius and radial factor are
// returned for the derivatives.
struct Projected {
  double p[3], iz, x, y, r2, s, u, v;
};

__device__ __forceinline__ Projected project(const double R[9], const double t[3],
                                             const double k[6], const double b[3]) {
  Projected q;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q.p[i] = R[3 * i] * b[0] + R[3 * i + 1] * b[1] + R[3 * i + 2] * b[2] + t[i];
  }
  q.iz = 1.0 / q.p[2];
  q.x = q.p[0] / q.p[2];
  q.y = q.p[1] / q.p[2];
  q.r2 = q.x * q.x + q.y * q.y;
  q.s = 1.0 + q.r2 * (k[4] + q.r2 * k[5]);
  q.u = k[0] * (q.x * q.s) + k[2];
  q.v = k[1] * (q.y * q.s) + k[3];
  return q;
}

// Every lane's value summed over the warp by a fixed xor tree; each lane ends
// with the same bits (f64 addition commutes).
template <int n>
__device__ __forceinline__ void warp_sum(double (&v)[n]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < n; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
}

// Squared error sum over the frame's points at pose p, in every lane.
__device__ double squared_error(const double p[6], const double k[6], const Frame& fr,
                                int lane) {
  double R[9];
  so3_exp(p, R);
  double e[1] = {0.0};
  for (int n = lane; n < fr.N; n += 32) {
    const double b[3] = {fr.b[3 * n], fr.b[3 * n + 1], fr.b[3 * n + 2]};
    const Projected q = project(R, p + 3, k, b);
    const double ru = fr.o[2 * n] - q.u, rv = fr.o[2 * n + 1] - q.v;
    e[0] += ru * ru + rv * rv;
  }
  warp_sum(e);
  return e[0];
}

// One Gauss-Newton step of pose p: J^T J (upper) and J^T r over the frame,
// the ridge, a Cholesky (NaN factor at a pivot that is not positive), the two
// triangular solves, p -= step.
__device__ void gauss_newton_step(double p[6], const double k[6], const Frame& fr, int lane) {
  double R[9], dR[3][9];
  so3_exp(p, R, dR);
  double s[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) s[i] = 0.0;
  for (int n = lane; n < fr.N; n += 32) {
    const double b[3] = {fr.b[3 * n], fr.b[3 * n + 1], fr.b[3 * n + 2]};
    const Projected q = project(R, p + 3, k, b);
    const double ru = fr.o[2 * n] - q.u, rv = fr.o[2 * n + 1] - q.v;
    const double dsr = k[4] + 2.0 * q.r2 * k[5];   // d(radial) / d(r2)
    double ju[6], jv[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      double dp[3];
      if (c < 3) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          dp[i] = dR[c][3 * i] * b[0] + dR[c][3 * i + 1] * b[1] + dR[c][3 * i + 2] * b[2];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) dp[i] = i == c - 3 ? 1.0 : 0.0;
      }
      const double dx = (dp[0] - q.x * dp[2]) * q.iz;
      const double dy = (dp[1] - q.y * dp[2]) * q.iz;
      const double ds = 2.0 * (q.x * dx + q.y * dy) * dsr;
      // residual = obs - pred: its derivative is minus the prediction's
      ju[c] = -(k[0] * (dx * q.s + q.x * ds));
      jv[c] = -(k[1] * (dy * q.s + q.y * ds));
    }
    int u = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int c = a; c < 6; ++c) s[u++] += ju[a] * ju[c] + jv[a] * jv[c];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) s[21 + a] += ju[a] * ru + jv[a] * rv;
  }
  warp_sum(s);

  double L[6][6], inv[6];   // the factor, and 1 / its diagonal
  bool pd = true;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int diag = c * 6 - c * (c - 1) / 2;    // (c, c) in the upper triangle
    double d = s[diag] + kRidge;
#pragma unroll
    for (int m = 0; m < c; ++m) d -= L[c][m] * L[c][m];
    pd = pd && d > 0.0;
    L[c][c] = sqrt(d);
    inv[c] = 1.0 / L[c][c];
#pragma unroll
    for (int i = c + 1; i < 6; ++i) {
      double v = s[diag + (i - c)];
#pragma unroll
      for (int m = 0; m < c; ++m) v -= L[i][m] * L[c][m];
      L[i][c] = v * inv[c];
    }
  }
  double y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double v = s[21 + i];
#pragma unroll
    for (int m = 0; m < i; ++m) v -= L[i][m] * y[m];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    double v = y[i];
#pragma unroll
    for (int m = i + 1; m < 6; ++m) v -= L[m][i] * y[m];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) p[i] = pd ? p[i] - y[i] : nan("");
}

// kIters steps from p; returns the squared error at the result.
__device__ double polish(double p[6], const double k[6], const Frame& fr, int lane) {
  for (int it = 0; it < kIters; ++it) gauss_newton_step(p, k, fr, lane);
  return squared_error(p, k, fr, lane);
}

// Grid: ceil(C F / kWarps) blocks of kWarps warps; warp w of block x takes
// camera-frame x kWarps + w, lane l its board points l, l + 32, ...
__global__ void __launch_bounds__(kThreads) pose_gn_kernel(
    const double* __restrict__ poses0, const double* __restrict__ cam12,
    const double* __restrict__ uvs, const uint8_t* __restrict__ mask,
    const double* __restrict__ objp, int C, int F, int N, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long cf = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cf >= (long long)C * F) return;
  double* o = out + cf * 6;
  if (!mask[cf]) {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 6; ++i) o[i] = nan("");
    }
    return;
  }
  const double* cam = cam12 + (cf / F) * 12;
  double k[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) k[i] = cam[i];
  const Frame fr{objp, uvs + cf * N * 2, N};
  double pa[6], pb[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) pa[i] = poses0[cf * 6 + i];
  const double err_a = polish(pa, k, fr, lane);
  twin_planar_pose(pa, pb);
  const double err_b = polish(pb, k, fr, lane);
  const bool better_b = err_b < err_a;   // NaN compares false: A, as the twin
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) o[i] = better_b ? pb[i] : pa[i];
  }
}

}  // namespace

extern "C" {

const char* pose_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Inputs: poses0 (C, F, 6), cam12 (C, 12), uvs (C, F, N, 2), objp (N, 3) f64,
// mask (C, F) u8 (a bool tensor's bytes), all contiguous; N >= 1. Output:
// out (C, F, 6) f64, written in full. One launch.
int pose_gn_launch(const void* poses0, const void* cam12, const void* uvs, const void* mask,
                   const void* objp, int C, int F, int N, void* out, void* stream) {
  if (C < 1 || F < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)C * F + kWarps - 1) / kWarps;
  pose_gn_kernel<<<dim3((unsigned)blocks), kThreads, 0, (cudaStream_t)stream>>>(
      (const double*)poses0, (const double*)cam12, (const double*)uvs, (const uint8_t*)mask,
      (const double*)objp, C, F, N, (double*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
