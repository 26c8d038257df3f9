// The pose-only Levenberg-Marquardt solve with chi^2 re-gating (ORB-SLAM's
// Optimizer::PoseOptimization) as ONE launch for Hopper (built for sm_90a):
// one thread block a problem runs every round and every iteration.
//
// Replaces: no Pallas kernel. The reference package leaves the solve to XLA
// (orbslam_jpminipc_tpu/solvers/pose_opt.py:optimize_pose, a `lax.while_loop`
// a round), which fuses it into a few programs; its plain PyTorch version,
// orbslam_jpminipc_torch/solvers/pose_opt.py:optimize_pose_plain, is some
// 280 small kernels an iteration (three residual evaluations, two
// closed-form 3x3 inverses built from stacks, exp_se3, the accept and
// damping scalars), ~11,000 launches for the 4-round schedule. Same
// mathematics, in float32: `n_rounds` of (10, 10, 7, 5) iterations, the
// Huber kernel in the first `huber_rounds`, lambda started at 1e-5 max|diag H|
// and damped additively, g2o's rho and nu update, the `done` freeze on a
// relative gain under 1e-5, orthonormalization after each round, the chi^2
// re-gate (9.210, 7.378, 5.991, 5.991) with the positive-depth test, and the
// final inlier mask, count and chi^2.
//
// What bounds it on this card: latency, not bytes or operations. A 1,000-row
// problem reads 24 kB once and does ~150 operations a row a sweep (37 sweeps
// for 4 rounds: 5.6 M operations, 0.08 us at 67 T/s). But every iteration
// depends on the one before: a sweep over the rows at the candidate pose,
// one block-wide reduction of 28 sums, then a serial 6x6 solve and exp_se3
// before the next sweep can start. The floor is that chain's latency, about
// 1,000 cycles an iteration (the rows' dependent arithmetic, five shuffle
// levels, two barriers, ~150 dependent operations of the solve), ~0.5 us at
// 1.98 GHz: ~20 us for the 32 iterations and 5 sweeps of the 4-round schedule.
//
// What the design does about it:
//   * one launch for the whole schedule; the pose, lambda and the 6x6 system
//     stay in shared memory, the observations in registers (thread i holds
//     rows i, i + 512, i + 1024 and i + 1536; further rows are read again
//     from global memory, where L2 keeps them, with their inlier bit in the
//     output mask);
//   * one sweep and one reduction an iteration, where the plain version
//     evaluates the residuals three times: the sweep at the candidate pose
//     sums its robust chi^2 together with the normal equations H and b at
//     that pose with that pose's weights. An accepted step brings the next
//     iteration's H and b along; a rejected one leaves the pose and so the
//     weights unchanged, so the kept H and b are still right. The re-gate
//     after a round shares its sweep with the next round's first system;
//   * the reduction is deterministic: a thread's rows in order, a butterfly
//     across the warp that leaves lane l with the warp's sum of value l (31
//     shuffles for 32 values, not 5 x 28), then the warps' partial sums in
//     warp order in shared memory. No atomics: two runs give equal bits;
//   * thread 0 does the serial part: the Schur elimination with closed-form
//     3x3 inverses in the order of solvers/linalg3.py:solve6_spd, exp_se3,
//     the composition, the accept test and the damping update.
//
// Exactness: the arithmetic of the plain version, operation for operation
// where it is elementwise (the build passes -fmad=false, so nothing is
// contracted into a fused multiply-add the plain version does not do). The
// sums (the plain version's einsum and reductions) are taken in another
// order, with explicit fused multiply-adds; so the result agrees with the
// plain version to float32 rounding, not in its bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxProblems = 16;

// One problem: a pose and its observations (float32, contiguous).
struct PoseLmProblem {
  const float* R0;       // (3, 3) starting world->camera rotation
  const float* t0;       // (3,)
  const float* xw;       // (n, 3) world points
  const float* uv;       // (n, 2) observed undistorted keypoints
  const float* w;        // (n,) information weight 1 / sigma^2
  const uint8_t* valid;  // (n,) bool: the observation has a map point
  const float* K4;       // (4,) fx, fy, cx, cy
  int n;
  float* R;              // (3, 3) out
  float* t;              // (3,) out
  uint8_t* inliers;      // (n,) bool out (also the inlier bits of rows beyond the registers)
  int64_t* n_inliers;    // () out
  float* chi2;           // () out: chi^2 summed over the inliers
};

struct PoseLmBatch {
  PoseLmProblem p[kMaxProblems];
  int count;
  int n_rounds;      // 0 to 4
  int huber_rounds;  // rounds that use the Huber kernel
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRegRows = 4;  // observations a thread holds in registers
constexpr int kSums = 32;    // reduced values: H's upper triangle 21, b 6, chi^2 1, padding
constexpr int kB = 21;       // first b entry
constexpr int kChi = 27;     // the robust chi^2

constexpr float kDelta2 = 5.991f;         // Huber threshold on chi^2
constexpr float kHuberDelta = 2.4476519f; // sqrt(5.991) rounded to float32
__constant__ float kGates[4] = {9.210f, 7.378f, 5.991f, 5.991f};
__constant__ int kRoundIters[4] = {10, 10, 7, 5};

struct Pose {
  float R[9];
  float t[3];
};

// What thread 0 carries between iterations.
struct LmState {
  Pose cur;          // the current pose
  float H[21];       // the normal equations at it, upper triangle row by row
  float b[6];
  float chi;         // robust chi^2 at it
  float lam, ni;
  float pred;        // the predicted gain of the proposed step
};

// upper-triangle index of (j, k), j <= k
__host__ __device__ constexpr int tri(int j, int k) { return j * 6 - j * (j - 1) / 2 + (k - j); }

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // torch.clamp: NaN stays NaN
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---- the per-row arithmetic ------------------------------------------------

struct Cam {
  float fx, fy, cx, cy;
};

// Residual and chi^2 of one observation at pose P (solvers/reproj.py:
// residuals, then sum(e * e) * w).
struct Proj {
  float px, py, pz, iz, e0, e1, c;
};

__device__ __forceinline__ Proj project(const Pose& P, const Cam& K, float x, float y, float z,
                                        float u, float v, float w) {
  Proj r;
  r.px = x * P.R[0] + y * P.R[1] + z * P.R[2] + P.t[0];
  r.py = x * P.R[3] + y * P.R[4] + z * P.R[5] + P.t[1];
  r.pz = x * P.R[6] + y * P.R[7] + z * P.R[8] + P.t[2];
  r.iz = 1.0f / (fabsf(r.pz) < 1e-12f ? 1e-12f : r.pz);
  const float pu = K.fx * r.px * r.iz + K.cx;
  const float pv = K.fy * r.py * r.iz + K.cy;
  r.e0 = u - pu;
  r.e1 = v - pv;
  r.c = (r.e0 * r.e0 + r.e1 * r.e1) * w;
  return r;
}

// One row's share of the robust chi^2 and of H and b (pose_opt.py: weights,
// robust_chi2, _normal_eq; reproj.py: jacobians, huber_weight).
__device__ __forceinline__ void accumulate_lm(const Proj& r, const Cam& K, float w, bool inl,
                                              bool huber, float (&acc)[kSums]) {
  const float c = r.c;
  float rob = c;
  if (huber) rob = c <= kDelta2 ? c : 2.0f * sqrtf(kDelta2 * c) - kDelta2;
  if (inl) acc[kChi] += rob;
  float wt = w * (inl ? 1.0f : 0.0f);
  if (huber) {
    const float e = sqrtf(c < 1e-18f ? 1e-18f : c);
    wt = wt * (e <= kHuberDelta ? 1.0f : kHuberDelta / e);
  }
  // J_pose = [Jproj @ hat(p), -Jproj], rows u and v
  const float iz2 = r.iz * r.iz;
  const float a = K.fx * r.iz, bb = K.fy * r.iz;
  const float c0 = -K.fx * r.px * iz2, c1 = -K.fy * r.py * iz2;
  const float J0[6] = {-(c0 * r.py), a * -r.pz + c0 * r.px, a * r.py, -a, -0.0f, -c0};
  const float J1[6] = {bb * r.pz - c1 * r.py, c1 * r.px, -(bb * r.px), -0.0f, -bb, -c1};
  float w0[6], w1[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    w0[j] = J0[j] * wt;
    w1[j] = J1[j] * wt;
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int k = j; k < 6; ++k) {
      float& h = acc[tri(j, k)];
      h = __fmaf_rn(w0[j], J0[k], h);
      h = __fmaf_rn(w1[j], J1[k], h);
    }
    acc[kB + j] = __fmaf_rn(w0[j], r.e0, acc[kB + j]);
    acc[kB + j] = __fmaf_rn(w1[j], r.e1, acc[kB + j]);
  }
}

// ---- the block-wide sum ------------------------------------------------------

// Sum v[0..31] over the block into s_tot[0..31]. Every thread calls it;
// warp 0 holds the result after it returns (the caller syncs the warp or
// the block before anyone else reads s_tot).
__device__ __forceinline__ void block_sum(float (&v)[kSums], float* s_part, float* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // butterfly: at the step across lanes `s` apart each lane keeps half of
  // its values and adds its partner's; at the end lane l holds value l
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool upper = (lane & s) != 0;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = upper ? v[i] : v[i + s];
      const float keep = upper ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  s_part[warp * kSums + lane] = v[0];
  __syncthreads();
  if (warp == 0) {
    float t = s_part[lane];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) t += s_part[k * kSums + lane];
    s_tot[lane] = t;
    __syncwarp();
  }
}

// ---- thread 0's serial part --------------------------------------------------

__device__ __forceinline__ void matmul3(const float* A, const float* B, float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j] +
                     A[i * 3 + 2] * B[2 * 3 + j];
}

// linalg3.py:inv3: adjugate times the reciprocal of the determinant, kept
// away from 0
__device__ __forceinline__ void inv3(const float* M, float* out) {
  const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6], h = M[7],
              i = M[8];
  const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
  const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
  const float G = d * h - e * g, Hh = b * g - a * h, I = a * e - b * d;
  const float det = a * A + b * D + c * G;
  const float inv_det = 1.0f / (fabsf(det) < 1e-18f ? 1e-18f : det);
  out[0] = A * inv_det; out[1] = B * inv_det; out[2] = C * inv_det;
  out[3] = D * inv_det; out[4] = E * inv_det; out[5] = F * inv_det;
  out[6] = G * inv_det; out[7] = Hh * inv_det; out[8] = I * inv_det;
}

// pose_opt.py:_lm_step's solve: x = (H + lam I + 1e-10 I)^-1 b by
// linalg3.py:solve6_spd (2x2-block Schur elimination)
__device__ void solve6(const float* H, const float* b, float lam, float* x) {
  float M[36];
#pragma unroll
  for (int j = 0; j < 6; ++j)
#pragma unroll
    for (int k = 0; k < 6; ++k) M[j * 6 + k] = j <= k ? H[tri(j, k)] : H[tri(k, j)];
#pragma unroll
  for (int j = 0; j < 6; ++j) M[j * 7] = (M[j * 7] + lam) + 1e-10f;
  float A[9], B[9], Bt[9], D[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i * 3 + j] = M[i * 6 + j];
      B[i * 3 + j] = M[i * 6 + 3 + j];
      Bt[j * 3 + i] = M[i * 6 + 3 + j];
      D[i * 3 + j] = M[(3 + i) * 6 + 3 + j];
    }
  float Ai[9], AiB[9], BtAiB[9], S[9], Si[9], AiBt[9];
  inv3(A, Ai);
  matmul3(Ai, B, AiB);
  matmul3(Bt, AiB, BtAiB);
#pragma unroll
  for (int k = 0; k < 9; ++k) S[k] = D[k] - BtAiB[k];
  inv3(S, Si);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) AiBt[i * 3 + j] = AiB[j * 3 + i];
  float rhs2[3], x2[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    rhs2[i] = b[3 + i] - (AiBt[i * 3] * b[0] + AiBt[i * 3 + 1] * b[1] + AiBt[i * 3 + 2] * b[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x2[i] = Si[i * 3] * rhs2[0] + Si[i * 3 + 1] * rhs2[1] + Si[i * 3 + 2] * rhs2[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float aib1 = Ai[i * 3] * b[0] + Ai[i * 3 + 1] * b[1] + Ai[i * 3 + 2] * b[2];
    const float aibx = AiB[i * 3] * x2[0] + AiB[i * 3 + 1] * x2[1] + AiB[i * 3 + 2] * x2[2];
    x[i] = aib1 - aibx;
    x[3 + i] = x2[i];
  }
}

// geometry/se3.py:exp_se3 of xi = [omega, upsilon]
__device__ void exp_se3(const float* xi, float* R, float* t) {
  const float wx = xi[0], wy = xi[1], wz = xi[2];
  const float theta2 = wx * wx + wy * wy + wz * wz;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool large = theta2 > 1e-8f;
  const float st = sinf(theta), ct = cosf(theta);
  const float a = large ? st / theta : 1.0f - theta2 / 6.0f;
  const float b = large ? (1.0f - ct) / (theta2 < 1e-16f ? 1e-16f : theta2)
                        : 0.5f - theta2 / 24.0f;
  const float t3 = theta2 * theta;
  const float c = large ? (theta - st) / (t3 < 1e-24f ? 1e-24f : t3)
                        : 1.0f / 6.0f - theta2 / 120.0f;
  const float W[9] = {0.0f, -wz, wy, wz, 0.0f, -wx, -wy, wx, 0.0f};
  float WW[9];
  matmul3(W, W, WW);
  float V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    R[k] = eye + a * W[k] + b * WW[k];
    V[k] = eye + b * W[k] + c * WW[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = V[i * 3] * xi[3] + V[i * 3 + 1] * xi[4] + V[i * 3 + 2] * xi[5];
}

// se3.py:orthonormalize: two Newton steps of the polar iteration
__device__ void orthonormalize(float* R) {
  for (int it = 0; it < 2; ++it) {
    float RtR[9], M[9], out[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        RtR[i * 3 + j] = R[i] * R[j] + R[3 + i] * R[3 + j] + R[6 + i] * R[6 + j];
#pragma unroll
    for (int k = 0; k < 9; ++k) M[k] = ((k % 4 == 0) ? 1.5f : 0.0f) - 0.5f * RtR[k];
    matmul3(R, M, out);
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = out[k];
  }
}

// The step from the current pose: writes the candidate into `cand` and the
// predicted gain into st.pred.
__device__ void propose(LmState& st, Pose& cand) {
  float x[6], delta[6];
  solve6(st.H, st.b, st.lam, x);
#pragma unroll
  for (int j = 0; j < 6; ++j) delta[j] = -x[j];
  float dR[9], dt[3];
  exp_se3(delta, dR, dt);
  // se3.py:compose(dR, dt, R, t)
  matmul3(dR, st.cur.R, cand.R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    cand.t[i] = (dR[i * 3] * st.cur.t[0] + dR[i * 3 + 1] * st.cur.t[1] +
                 dR[i * 3 + 2] * st.cur.t[2]) + dt[i];
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j) s += delta[j] * (st.lam * delta[j] - st.b[j]);
  st.pred = 0.5f * s;
}

// The sums of a sweep at the current pose start a round.
__device__ void start_round(LmState& st, const float* tot) {
#pragma unroll
  for (int k = 0; k < 21; ++k) st.H[k] = tot[k];
#pragma unroll
  for (int j = 0; j < 6; ++j) st.b[j] = tot[kB + j];
  st.chi = tot[kChi];
  // optimization_algorithm_levenberg.cpp: tau * max |diag H|, NaN kept
  float m = fabsf(st.H[tri(0, 0)]);
#pragma unroll
  for (int j = 1; j < 6; ++j) {
    const float d = fabsf(st.H[tri(j, j)]);
    m = (d > m || d != d) ? d : m;
  }
  st.lam = 1e-5f * m;
  st.ni = 2.0f;
}

// The sums of a sweep at the candidate: accept or reject (g2o's rules);
// returns whether the relative gain was under 1e-5 (the round is done).
__device__ bool decide(LmState& st, const Pose& cand, const float* tot) {
  const float chi_new = tot[kChi];
  const float pred = st.pred;
  const float rho = (st.chi - chi_new) / (fabsf(pred) < 1e-30f ? 1e-30f : pred);
  const bool accept = rho > 0.0f && chi_new < st.chi && isfinite(chi_new);
  const bool converged = accept && (st.chi - chi_new < 1e-5f * st.chi);
  const float r = 2.0f * rho - 1.0f;
  const float factor = clampf(1.0f - r * r * r, 1.0f / 3.0f, INFINITY);
  st.lam = clampf(accept ? st.lam * factor : st.lam * st.ni, 1e-15f, 1e10f);
  st.ni = accept ? 2.0f : st.ni * 2.0f;
  if (accept) {
    st.cur = cand;
    st.chi = chi_new;
#pragma unroll
    for (int k = 0; k < 21; ++k) st.H[k] = tot[k];
#pragma unroll
    for (int j = 0; j < 6; ++j) st.b[j] = tot[kB + j];
  }
  return converged;
}

// ---- the kernel --------------------------------------------------------------

// The table is a __grid_constant__ parameter: a block reads its row in
// place, with no copy to local memory.
__global__ void __launch_bounds__(kThreads, 1)
    pose_lm_kernel(const __grid_constant__ PoseLmBatch batch) {
  const PoseLmProblem& P = batch.p[blockIdx.x];
  __shared__ float s_part[kWarps * kSums];
  __shared__ float s_tot[kSums];
  __shared__ Pose s_pose;  // the pose the next sweep evaluates
  __shared__ LmState s_st;
  __shared__ int s_go;     // the round goes on

  const int tid = threadIdx.x;
  const int n = P.n;
  const Cam K = {P.K4[0], P.K4[1], P.K4[2], P.K4[3]};

  // the thread's rows in registers; bit k of `valid`/`inl` is row tid + k * kThreads
  float ox[kRegRows], oy[kRegRows], oz[kRegRows], ou[kRegRows], ov[kRegRows], ow[kRegRows];
  unsigned valid = 0, inl = 0;
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    const int row = tid + k * kThreads;
    const bool in = row < n;
    ox[k] = in ? P.xw[3 * row] : 0.0f;
    oy[k] = in ? P.xw[3 * row + 1] : 0.0f;
    oz[k] = in ? P.xw[3 * row + 2] : 0.0f;
    ou[k] = in ? P.uv[2 * row] : 0.0f;
    ov[k] = in ? P.uv[2 * row + 1] : 0.0f;
    ow[k] = in ? P.w[row] : 0.0f;
    if (in && P.valid[row]) valid |= 1u << k;
  }
  inl = valid;  // the first round's inliers: every valid row
  for (int row = tid + kRegRows * kThreads; row < n; row += kThreads)
    P.inliers[row] = P.valid[row] ? 1 : 0;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) s_st.cur.R[k] = P.R0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) s_st.cur.t[k] = P.t0[k];
    s_pose = s_st.cur;
  }
  __syncthreads();

  // One sweep at s_pose: with `regate` the inliers are decided again at
  // `gate` first; then the sums of the LM terms or, with `last`, chi^2
  // and the count over the inliers. The sums land in s_tot (warp 0).
  auto sweep = [&](bool regate, bool last, float gate, bool huber) {
    const Pose p = s_pose;
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    auto row_terms = [&](float x, float y, float z, float u, float v, float w, bool ok,
                         bool& in) {
      const Proj r = project(p, K, x, y, z, u, v, w);
      if (regate) in = ok && r.c <= gate && r.pz > 0.0f;
      if (last) {
        if (in) {
          acc[0] += r.c;
          acc[1] += 1.0f;  // exact: a float holds every count below 2^24
        }
      } else {
        accumulate_lm(r, K, w, in, huber, acc);
      }
    };
#pragma unroll
    for (int k = 0; k < kRegRows; ++k) {
      if (tid + k * kThreads < n) {
        bool in = (inl >> k) & 1u;
        row_terms(ox[k], oy[k], oz[k], ou[k], ov[k], ow[k], (valid >> k) & 1u, in);
        inl = (inl & ~(1u << k)) | (in ? 1u << k : 0u);
      }
    }
    for (int row = tid + kRegRows * kThreads; row < n; row += kThreads) {
      bool in = P.inliers[row] != 0;
      row_terms(P.xw[3 * row], P.xw[3 * row + 1], P.xw[3 * row + 2], P.uv[2 * row],
                P.uv[2 * row + 1], P.w[row], P.valid[row] != 0, in);
      if (regate) P.inliers[row] = in ? 1 : 0;
    }
    block_sum(acc, s_part, s_tot);
  };

  const int n_rounds = batch.n_rounds;
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool huber = rnd < batch.huber_rounds;
    const int iters = kRoundIters[rnd];
    // the round's first system at the current pose, after the previous
    // round's re-gate there
    sweep(rnd > 0, false, rnd > 0 ? kGates[rnd - 1] : 0.0f, huber);
    if (tid == 0) {
      start_round(s_st, s_tot);
      s_go = 1;
      propose(s_st, s_pose);
    }
    __syncthreads();
    for (int it = 0; it < iters && s_go; ++it) {
      sweep(false, false, 0.0f, huber);
      if (tid == 0) {
        const bool done = decide(s_st, s_pose, s_tot);
        s_go = !done && it + 1 < iters;
        if (s_go) propose(s_st, s_pose);
      }
      __syncthreads();
    }
    if (tid == 0) {
      // float32 rotation products drift off SO(3): re-project
      orthonormalize(s_st.cur.R);
      s_pose = s_st.cur;
    }
    __syncthreads();
  }
  // the last round's re-gate (none without a round: the valid rows stay),
  // and chi^2 and the count over the final inliers
  sweep(n_rounds > 0, true, n_rounds > 0 ? kGates[n_rounds - 1] : 0.0f, false);
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    const int row = tid + k * kThreads;
    if (row < n) P.inliers[row] = (inl >> k) & 1u;
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) P.R[k] = s_st.cur.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) P.t[k] = s_st.cur.t[k];
    *P.chi2 = s_tot[0];
    *P.n_inliers = static_cast<int64_t>(s_tot[1]);
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) for device `device`: one
// block of kThreads threads a problem. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int pose_lm_launch(const PoseLmBatch* batch, int device, void* stream) {
  if (batch->count < 1 || batch->count > kMaxProblems || batch->n_rounds < 0 ||
      batch->n_rounds > 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pose_lm_kernel<<<batch->count, kThreads, 0, s>>>(*batch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pose_lm_max_problems() { return kMaxProblems; }

extern "C" const char* pose_lm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
