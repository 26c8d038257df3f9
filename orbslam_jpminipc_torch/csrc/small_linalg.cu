// Batched small symmetric eigendecomposition (n <= 12) and SVD (square,
// n <= 4) by Jacobi rotations, for Hopper (built for sm_90a).
//
// Replaces: the jnp.linalg calls inside the reference's jitted solvers,
// which have no Pallas counterpart (XLA lowers them to Jacobi-type solvers
// on a TPU):
//   orbslam_jpminipc_tpu/solvers/epnp.py:32  eigh of P^T P (3x3)
//   orbslam_jpminipc_tpu/solvers/epnp.py:53  pinv of C (4x4, rtol 1e-6)
//   orbslam_jpminipc_tpu/solvers/epnp.py:198 svd of H (3x3)
//   orbslam_jpminipc_tpu/solvers/epnp.py:214 eigh of M^T M (12x12)
//   orbslam_jpminipc_tpu/solvers/sim3solver.py:57 eigh of Horn's N (4x4)
//   orbslam_jpminipc_tpu/solvers/initializer.py:78, 93 eigh of A^T A (9x9)
//   orbslam_jpminipc_tpu/solvers/initializer.py:95, 188, 237 svd (3x3)
// Its plain PyTorch version, step for step, is
// orbslam_jpminipc_torch/solvers/small_linalg.py (eigh_small, svd_small);
// read its docstring for the algorithm and the conventions. The two agree
// to rounding (the kernel contracts multiply-adds, and sums a column's dot
// products in its own order), not to the bit.
//
// What bounds it on this card: latency. A 12x12 matrix is 576 bytes in and
// 624 out; a sweep is 11 rounds of 6 rotations, ~3,500 flops, some 30 k for
// a matrix's ~8 sweeps. 257 of them are 0.3 MB and 8 M flops: 0.1 us at
// 3.35 TB/s, 0.12 us at 67 TFLOP/s. Neither is near: each round depends on
// the last one, so a matrix is a chain of ~90 dependent rounds, and the
// main path's batches (4 to 1,024 matrices) are too few to hide that chain
// behind other warps. So the design shortens the chain itself:
//
// * One lane per column of A (and of V, or of U and V for the SVD), in that
//   lane's registers: a matrix takes a group of G lanes (G = 4 for a padded
//   size m <= 4, 8 for m <= 8, 16 for m <= 12), so 8 matrices of 3x3 or 4x4
//   share a warp, 2 of 9x9 to 12x12.
// * The rounds are unrolled by a template on the padded size m (the kernel
//   is instantiated for m = 2, 4, ..., 12), so every row index in a round
//   is a compile-time constant and the columns never leave the registers
//   (ptxas -v: no spill; 32 to 72 registers; a stack frame only where the
//   LAPACK-sign path of m = 4 keeps its 3x3 arrays, 64 bytes, and in the
//   svd of m = 2, 32 bytes).
// * Both lanes of a pair compute the pair's (c, s) from a_pp, a_qq and a_pq
//   (each lane's diagonal entry and its entry in its partner's row,
//   exchanged with __shfl_sync), so nothing is broadcast before the column
//   rotation, which is one shuffle a row with the partner lane and one
//   multiply-add (c x -+ s y). Each lane's m/2 row rotations are
//   lane-local, with every pair's (c, s) broadcast by shuffle from the
//   pair's first lane. No shared memory, no branch and no __syncwarp
//   inside a round.
// * The stop vote is warp-wide (__any_sync once a sweep): a matrix that has
//   converged rotates nothing in further sweeps (its pairs apply the
//   identity, c = 1 and s = 0, which leaves every value as it is), so its
//   result is the one it would have stopped with.
// * Sorting is a rank per lane (each lane counts the columns that precede
//   its own), so a lane writes its column straight to its output position.
//
// Hopper's wgmma tensor cores and TMA do not fit this: a rotation is a 2x2
// update of two columns that depends on the previous round, there is no
// tile of 64 rows to multiply, and a matrix is a few hundred bytes (float32
// Jacobi also needs float32 arithmetic, not TF32).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 12;                 // eigh; the padded size is kMaxN too
constexpr int kMaxSvdN = 4;
constexpr int kThreads = 128;             // 4 warps a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEps = 1.1920929e-07f;
constexpr float kEighTol = kEps;          // solvers/small_linalg.py:EIGH_TOL
constexpr float kSvdTol = 4.0f * kEps;    // SVD_TOL
constexpr float kBig = 1e18f;             // BIG
constexpr float kLapackEps = 5.9604645e-08f;      // LAPACK_EPS, 2^-24
constexpr float kLapackSafmin = 1.1754944e-38f;   // LAPACK_SAFMIN, 2^-126
constexpr float kLapackRtmin = 1.0842022e-19f;    // LAPACK_RTMIN, 2^-63
constexpr float kLapackRtmax = 6.5219088e+18f;    // LAPACK_RTMAX, 2^62.5
constexpr int kLapackSteps = 16;                  // LAPACK_STEPS

// lanes a matrix takes at padded size m: a power of two at least m
__host__ __device__ constexpr int group_lanes(int m) { return m <= 4 ? 4 : m <= 8 ? 8 : 16; }

// the round-robin (circle method) order of solvers/small_linalg.py:rounds:
// the first index p of pair k of round r for an even size m (p < q)
__host__ __device__ constexpr int pair_p(int m, int r, int k) {
  return k == 0 ? r
                : ((r + k) % (m - 1) < (r - k + (m - 1)) % (m - 1) ? (r + k) % (m - 1)
                                                                   : (r - k + (m - 1)) % (m - 1));
}

__host__ __device__ constexpr int pair_q(int m, int r, int k) {
  return k == 0 ? m - 1
                : ((r + k) % (m - 1) > (r - k + (m - 1)) % (m - 1) ? (r + k) % (m - 1)
                                                                   : (r - k + (m - 1)) % (m - 1));
}

// lane j's partner in round r: m - 1 pairs with r, and j with (2r - j)
// mod (m - 1) (pair k joins (r + k) and (r - k)); lanes past m keep to
// themselves
__device__ __forceinline__ int partner_of(int m, int r, int j) {
  if (j >= m) return j;
  if (j == m - 1) return r;
  if (j == r) return m - 1;
  return (2 * r - j + (m - 1)) % (m - 1);
}

// x[i] for a runtime i, the array in registers: a select over constant indices
template <int M>
__device__ __forceinline__ float pick(const float (&x)[M], int i) {
  float out = 0.0f;
#pragma unroll
  for (int k = 0; k < M; ++k) out = k == i ? x[k] : out;
  return out;
}

template <int M>
__device__ __forceinline__ void put(float (&x)[M], int i, float value) {
#pragma unroll
  for (int k = 0; k < M; ++k) x[k] = k == i ? value : x[k];
}

// solvers/small_linalg.py:_rotation, where the pair rotates
__device__ __forceinline__ void rotation(float d, float g, float& c, float& s, float& t) {
  float theta = d / (2.0f * g);
  float at = fabsf(theta);
  float sgn = theta >= 0.0f ? 1.0f : -1.0f;
  t = at > kBig ? 0.5f / theta : sgn / (at + sqrtf(1.0f + theta * theta));
  c = 1.0f / sqrtf(1.0f + t * t);
  s = t * c;
}

// true in every lane of the G-lane group when it is in any
template <int G>
__device__ __forceinline__ bool group_any(bool x) {
  int v = x ? 1 : 0;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v |= __shfl_xor_sync(kFull, v, off, G);
  return v != 0;
}

// ---- LAPACK's eigenvector signs for 3x3 (solvers/small_linalg.py:
// lapack_signs3, event for event, in one thread)

__device__ __forceinline__ float fsign(float a, float b) { return b >= 0.0f ? fabsf(a) : -fabsf(a); }

__device__ __forceinline__ float slapy2(float x, float y) {
  float w = fmaxf(fabsf(x), fabsf(y)), z = fminf(fabsf(x), fabsf(y));
  return z == 0.0f ? w : w * sqrtf(1.0f + (z / w) * (z / w));
}

__device__ __forceinline__ void slartg(float f, float g, float& c, float& s, float& r) {
  const float f1 = fabsf(f), g1 = fabsf(g);
  if (g == 0.0f) {
    c = 1.0f;
    s = 0.0f;
    r = f;
  } else if (f == 0.0f) {
    c = 0.0f;
    s = g >= 0.0f ? 1.0f : -1.0f;
    r = g1;
  } else if (f1 > kLapackRtmin && f1 < kLapackRtmax && g1 > kLapackRtmin && g1 < kLapackRtmax) {
    float d = sqrtf(f * f + g * g);
    c = f1 / d;
    r = fsign(d, f);
    s = g / r;
  } else {  // squares out of float32's range: scaled
    float u = fminf(1.0f / kLapackSafmin, fmaxf(kLapackSafmin, fmaxf(f1, g1)));
    float fs = f / u, gs = g / u;
    float d = sqrtf(fs * fs + gs * gs);
    c = fabsf(fs) / d;
    float rs = fsign(d, f);
    s = gs / rs;
    r = rs * u;
  }
}

__device__ void slaev2(float a, float b, float c, float& rt1, float& rt2, float& cs1,
                       float& sn1) {
  float sm = a + c, df = a - c, adf = fabsf(df), tb = b + b, ab = fabsf(tb);
  bool big = fabsf(a) > fabsf(c);
  float acmx = big ? a : c, acmn = big ? c : a;
  float rt = adf > ab   ? adf * sqrtf(1.0f + (ab / adf) * (ab / adf))
             : adf < ab ? ab * sqrtf(1.0f + (adf / ab) * (adf / ab))
                        : ab * 1.4142135f;
  int sgn1 = sm < 0.0f ? -1 : 1;
  if (sm == 0.0f) {
    rt1 = 0.5f * rt;
    rt2 = -0.5f * rt;
  } else {
    rt1 = sm < 0.0f ? 0.5f * (sm - rt) : 0.5f * (sm + rt);
    rt2 = (acmx / rt1) * acmn - (b / rt1) * b;
  }
  float cs = df >= 0.0f ? df + rt : df - rt;
  int sgn2 = df >= 0.0f ? 1 : -1;
  if (fabsf(cs) > ab) {
    float ct = -tb / cs;
    sn1 = 1.0f / sqrtf(1.0f + ct * ct);
    cs1 = ct * sn1;
  } else if (ab == 0.0f) {
    cs1 = 1.0f;
    sn1 = 0.0f;
  } else {
    float tn = -cs / tb;
    cs1 = 1.0f / sqrtf(1.0f + tn * tn);
    sn1 = tn * cs1;
  }
  if (sgn1 == sgn2) {
    float tn = cs1;
    cs1 = -sn1;
    sn1 = tn;
  }
}

// Z's columns j, j + 1 rotated as slasr('R', 'V', ...) does (Z row-major 3x3)
__device__ __forceinline__ void rot3(float* Z, int j, float c, float s) {
  for (int i = 0; i < 3; ++i) {
    float t = Z[i * 3 + j + 1], z = Z[i * 3 + j];
    Z[i * 3 + j + 1] = c * t - s * z;
    Z[i * 3 + j] = s * t + c * z;
  }
}

// LAPACK ssyev's eigenvectors (columns of Z, ascending) of symmetric 3x3 S
__device__ void lapack_vectors3(const float* S, float* Z) {
  float a00 = S[0], a10 = S[3], a20 = S[6], a11 = S[4], a21 = S[7], a22 = S[8];
  // ssytd2 (lower): one reflector
  bool refl = fabsf(a20) != 0.0f;
  float beta = refl ? -fsign(slapy2(a10, fabsf(a20)), a10) : a10;
  float tau = refl ? (beta - a10) / beta : 0.0f;
  float v2 = a20 * (1.0f / (refl ? a10 - beta : 1.0f));
  float x1 = tau * (a11 + a21 * v2), x2 = tau * (a21 + a22 * v2);
  float alpha = -0.5f * tau * (x1 + x2 * v2);
  float w1 = x1 + alpha, w2 = x2 + alpha * v2;
  float d[3] = {a00, refl ? a11 - 2.0f * w1 : a11, refl ? a22 - 2.0f * v2 * w2 : a22};
  float e[2] = {beta, refl ? a21 - v2 * w1 - w2 : a21};
  for (int k = 0; k < 9; ++k) Z[k] = 0.0f;
  Z[0] = 1.0f;
  Z[4] = 1.0f - tau;
  Z[5] = Z[7] = -tau * v2;
  Z[8] = 1.0f - tau * v2 * v2;
  // ssteqr, one event a step: mode 0 finds the next block, 1 QL, 2 QR, 3 done
  int mode = 0, l1 = 0, l = 0, lend = 0;
  const float eps2 = kLapackEps * kLapackEps;
  for (int step = 0; step < kLapackSteps && mode != 3; ++step) {
    bool start = false;
    if (mode == 0) {
      if (l1 > 2) {
        mode = 3;
      } else {
        if (l1 == 1) e[0] = 0.0f;
        if (l1 == 2) e[1] = 0.0f;
        bool small0 = fabsf(e[0]) <= sqrtf(fabsf(d[0])) * sqrtf(fabsf(d[1])) * kLapackEps;
        bool small1 = fabsf(e[1]) <= sqrtf(fabsf(d[1])) * sqrtf(fabsf(d[2])) * kLapackEps;
        bool hit0 = l1 == 0 && (e[0] == 0.0f || small0);
        bool hit1 = l1 <= 1 && !hit0 && (e[1] == 0.0f || small1);
        int m = hit0 ? 0 : hit1 ? 1 : 2;
        if (hit0) e[0] = 0.0f;
        if (hit1) e[1] = 0.0f;
        int bl = min(l1, 2), bend = m;
        float anorm = 0.0f;
        for (int k = bl; k <= bend; ++k) anorm = fmaxf(anorm, fabsf(d[k]));
        for (int k = bl; k < bend; ++k) anorm = fmaxf(anorm, fabsf(e[k]));
        if (bend != bl && anorm > 0.0f) {
          start = true;
          bool qr = fabsf(d[bend]) < fabsf(d[bl]);
          l = qr ? bend : bl;
          lend = qr ? bl : bend;
          mode = qr ? 2 : 1;
        }
        l1 = m + 1;
      }
    }
    if (start || (mode != 1 && mode != 2)) continue;
    const bool ql = mode == 1;
    bool sm0 = e[0] * e[0] <= (eps2 * fabsf(d[0])) * fabsf(d[1]) + kLapackSafmin;
    bool sm1 = e[1] * e[1] <= (eps2 * fabsf(d[1])) * fabsf(d[2]) + kLapackSafmin;
    int mq = lend;
    if (ql) {
      if (1 >= l && 1 < lend && sm1) mq = 1;
      if (0 >= l && 0 < lend && sm0) mq = 0;
      if (mq < lend) e[mq] = 0.0f;
    } else {
      if (1 <= l && 1 > lend && sm0) mq = 1;
      if (2 <= l && 2 > lend && sm1) mq = 2;
      if (mq > lend) e[mq - 1] = 0.0f;
    }
    const int stp = ql ? 1 : -1;
    if (mq == l) {
      l += stp;
    } else if (mq == l + stp) {
      int a = ql ? l : l - 1;
      float rt1, rt2, c, s;
      slaev2(d[a], e[a], d[a + 1], rt1, rt2, c, s);
      rot3(Z, a, c, s);
      d[a] = rt1;
      d[a + 1] = rt2;
      e[a] = 0.0f;
      l += 2 * stp;
    } else if (ql) {  // the QL sweep over the whole block: l = 0, m = 2
      float p = d[0];
      float g = (d[1] - p) / (2.0f * e[0]);
      float r = slapy2(g, 1.0f);
      g = d[2] - p + (e[0] / (g + fsign(r, g)));
      float cA, sA, rA, cB, sB, rB;
      slartg(g, e[1], cA, sA, rA);
      float bA = e[1], gq = d[2];
      float rq = (d[1] - gq) * sA + 2.0f * cA * bA;
      float pq = sA * rq;
      float d2q = gq + pq;
      gq = cA * rq - bA;
      slartg(gq, sA * e[0], cB, sB, rB);
      float bB = cA * e[0];
      gq = d[1] - pq;
      rq = (d[0] - gq) * sB + 2.0f * cB * bB;
      float pq2 = sB * rq;
      float d1q = gq + pq2;
      gq = cB * rq - bB;
      rot3(Z, 1, cA, -sA);
      rot3(Z, 0, cB, -sB);
      d[0] -= pq2;
      d[1] = d1q;
      d[2] = d2q;
      e[0] = gq;
      e[1] = rB;
    } else {  // the QR sweep over the whole block: l = 2, m = 0
      float p = d[2];
      float g = (d[1] - p) / (2.0f * e[1]);
      float r = slapy2(g, 1.0f);
      g = d[0] - p + (e[1] / (g + fsign(r, g)));
      float cA, sA, rA, cB, sB, rB;
      slartg(g, e[0], cA, sA, rA);
      float bA = e[0], gq = d[0];
      float rq = (d[1] - gq) * sA + 2.0f * cA * bA;
      float pq = sA * rq;
      float d0q = gq + pq;
      gq = cA * rq - bA;
      slartg(gq, sA * e[1], cB, sB, rB);
      float bB = cA * e[1];
      gq = d[1] - pq;
      rq = (d[2] - gq) * sB + 2.0f * cB * bB;
      float pq2 = sB * rq;
      float d1q = gq + pq2;
      gq = cB * rq - bB;
      rot3(Z, 0, cA, sA);
      rot3(Z, 1, cB, sB);
      d[0] = d0q;
      d[1] = d1q;
      d[2] -= pq2;
      e[0] = rB;
      e[1] = gq;
    }
    if ((ql && l > lend) || (!ql && l < lend)) mode = 0;
  }
  // selection sort, ascending, the columns with the values
  for (int i = 0; i < 2; ++i) {
    int k = i;
    for (int j = i + 1; j < 3; ++j) {
      if (d[j] < d[k]) k = j;
    }
    if (d[k] < d[i]) {
      float t = d[i];
      d[i] = d[k];
      d[k] = t;
      for (int r = 0; r < 3; ++r) {
        float z = Z[r * 3 + i];
        Z[r * 3 + i] = Z[r * 3 + k];
        Z[r * 3 + k] = z;
      }
    }
  }
}


// ---- eigh: one lane a column of A and of V --------------------------------

template <int M>
__global__ void __launch_bounds__(kThreads)
eigh_kernel(const float* __restrict__ A, float* __restrict__ w, float* __restrict__ V,
            int batch, int n, int max_sweeps, int lapack) {
  constexpr int G = group_lanes(M);
  const int lane = threadIdx.x & 31, j = lane % G;
  const long b = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = b < batch;  // a lane past the batch still takes part in the shuffles
  const float* Ab = A + (live ? b : 0) * n * n;

  float a[M], v[M];
  bool bad = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float x = 0.0f;
    if (live && i < n && j < n) {
      float aij = Ab[i * n + j], aji = Ab[j * n + i];
      bad |= !isfinite(aij);
      x = 0.5f * (aij + aji);
    }
    a[i] = x;
    v[i] = i == j ? 1.0f : 0.0f;
  }
  bad = group_any<G>(bad);
  if (bad) {  // as the plain version: a zero matrix, NaN on the way out
#pragma unroll
    for (int i = 0; i < M; ++i) a[i] = 0.0f;
  }

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      const int partner = partner_of(M, r, j);
      const bool first = j < partner;  // this lane holds column p of its pair
      // a_pp, a_qq and a_pq (row p of column q), the same in both lanes
      const float diag = pick(a, j), off = pick(a, partner);
      const float pdiag = __shfl_sync(kFull, diag, partner, G);
      const float poff = __shfl_sync(kFull, off, partner, G);
      const float app = first ? diag : pdiag, aqq = first ? pdiag : diag;
      const float apq = first ? poff : off;
      const bool rot = partner != j &&
                       fabsf(apq) > kEighTol * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq));
      float c = 1.0f, s = 0.0f, t = 0.0f;
      if (rot) rotation(aqq - app, apq, c, s, t);
      rotated |= rot;
      // columns of A and V: p <- c x_p - s x_q, q <- s x_p + c x_q, as
      // c x + (-+s) y in both lanes; a pair that does not rotate applies
      // the identity (c = 1, s = 0), as the plain version does
      const float sy = first ? -s : s;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const float y = __shfl_sync(kFull, a[i], partner, G);
        const float z = __shfl_sync(kFull, v[i], partner, G);
        a[i] = c * a[i] + sy * y;
        v[i] = c * v[i] + sy * z;
      }
      // rows of A, every pair's, in each lane's own column
#pragma unroll
      for (int k = 0; k < M / 2; ++k) {
        const int p = pair_p(M, r, k), q = pair_q(M, r, k);
        const float ck = __shfl_sync(kFull, c, p, G);
        const float sk = __shfl_sync(kFull, s, p, G);
        const float xp = a[p], xq = a[q];
        a[p] = ck * xp - sk * xq;
        a[q] = sk * xp + ck * xq;
      }
      // the rotated 2x2 block, exactly
      if (rot) {
        put(a, j, first ? app - t * apq : aqq + t * apq);
        put(a, partner, 0.0f);
      }
    }
    if (!__any_sync(kFull, rotated)) break;
  }

  // ascending and stable: the columns before this one
  const float d = pick(a, j);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float di = __shfl_sync(kFull, d, i, G);
    rank += i < n && (di < d || (di == d && i < j));
  }
  // the largest-magnitude component (the first of equals) positive
  float big = fabsf(v[0]), at = v[0];
#pragma unroll
  for (int i = 1; i < M; ++i) {
    if (i < n && fabsf(v[i]) > big) {
      big = fabsf(v[i]);
      at = v[i];
    }
  }
  float sgn = at < 0.0f ? -1.0f : 1.0f;
  if constexpr (M == 4) {
    if (lapack) {  // n == 3 (the wrapper checks): LAPACK's signs instead
      float S[9], Z[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int k = 0; k < 3; ++k)
          S[i * 3 + k] = live ? 0.5f * (Ab[i * 3 + k] + Ab[k * 3 + i]) : 0.0f;
      lapack_vectors3(S, Z);
      float dot = 0.0f;
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i) acc += Z[i * 3 + col] * v[i];
        dot = col == rank ? acc : dot;
      }
      sgn = dot < 0.0f ? -1.0f : 1.0f;
    }
  }
  if (live && j < n) {
    const float nan = __int_as_float(0x7fffffff);
    w[b * n + rank] = bad ? nan : d;
    float* Vb = V + b * n * n;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < n) Vb[i * n + rank] = bad ? nan : sgn * v[i];
    }
  }
}

// ---- svd: one-sided Jacobi, one lane a column of U and of V ------------------

template <int M>
__global__ void __launch_bounds__(kThreads)
svd_kernel(const float* __restrict__ A, float* __restrict__ U, float* __restrict__ S,
           float* __restrict__ Vt, int batch, int n, int max_sweeps) {
  constexpr int G = group_lanes(M);
  constexpr int kGroups = kThreads / G;
  __shared__ float s_u[kGroups][kMaxSvdN * kMaxSvdN];  // U, n x n row-major, sorted
  __shared__ float s_sig[kGroups][kMaxSvdN];
  const int lane = threadIdx.x & 31, j = lane % G, g = threadIdx.x / G;
  const long b = (static_cast<long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const bool live = b < batch;
  const float* Ab = A + (live ? b : 0) * n * n;

  float u[M], v[M];  // rows past n of u stay zero
  bool bad = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float x = 0.0f;
    if (live && i < n && j < n) {
      x = Ab[i * n + j];
      bad |= !isfinite(x);
    }
    u[i] = x;
    v[i] = i == j ? 1.0f : 0.0f;
  }
  bad = group_any<G>(bad);
  if (bad) {
#pragma unroll
    for (int i = 0; i < M; ++i) u[i] = 0.0f;
  }

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      const int partner = partner_of(M, r, j);
      const bool first = j < partner;
      float y[M], z[M];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        y[i] = __shfl_sync(kFull, u[i], partner, G);
        z[i] = __shfl_sync(kFull, v[i], partner, G);
      }
      // |u_j|^2 in each lane, exchanged; u_p . u_q in both (the same sum)
      float own = 0.0f, gamma = 0.0f;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i < n) {
          own += u[i] * u[i];
          gamma += u[i] * y[i];
        }
      }
      const float other = __shfl_sync(kFull, own, partner, G);
      const float alpha = first ? own : other, beta = first ? other : own;
      const bool rot = partner != j && fabsf(gamma) > kSvdTol * sqrtf(alpha) * sqrtf(beta);
      rotated |= rot;
      float c = 1.0f, s = 0.0f, t;  // (t: the eigh's exact 2x2 update)
      if (rot) rotation(beta - alpha, gamma, c, s, t);
      const float sy = first ? -s : s;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        u[i] = c * u[i] + sy * y[i];
        v[i] = c * v[i] + sy * z[i];
      }
    }
    if (!__any_sync(kFull, rotated)) break;
  }

  // singular values descending (stable), V's sign convention, U's columns
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < n) acc += u[i] * u[i];
  }
  const float sv = sqrtf(acc);
  int rank = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float si = __shfl_sync(kFull, sv, i, G);
    rank += i < n && (si > sv || (si == sv && i < j));
  }
  float big = fabsf(v[0]), at = v[0];
#pragma unroll
  for (int i = 1; i < M; ++i) {
    if (i < n && fabsf(v[i]) > big) {
      big = fabsf(v[i]);
      at = v[i];
    }
  }
  const float sgn = at < 0.0f ? -1.0f : 1.0f;
  float* out = s_u[g];
  const float nan = __int_as_float(0x7fffffff);
  if (j < n) {
    s_sig[g][rank] = sv;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i < n) out[i * n + rank] = sv > 0.0f ? sgn * u[i] / sv : 0.0f;
    }
    if (live) {
      S[b * n + rank] = bad ? nan : sv;
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i < n) Vt[b * n * n + rank * n + i] = bad ? nan : sgn * v[i];
      }
    }
  }
  __syncwarp();
  // a zero singular value's column: the unit vector with the largest
  // residual against the columns so far (solvers/small_linalg.py:_complete)
  if (j == 0) {
    for (int c = 0; c < n; ++c) {
      if (s_sig[g][c] > 0.0f) continue;
      float best = -1.0f, col[kMaxSvdN] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int k = 0; k < n; ++k) {
        float res[kMaxSvdN], norm2 = 0.0f;
        for (int i = 0; i < n; ++i) {
          float x = i == k ? 1.0f : 0.0f;
          for (int l = 0; l < n; ++l) x -= out[i * n + l] * out[k * n + l];
          res[i] = x;
          norm2 += x * x;
        }
        float norm = sqrtf(norm2);
        if (norm > best) {
          best = norm;
          for (int i = 0; i < n; ++i) col[i] = res[i];
        }
      }
      for (int i = 0; i < n; ++i) out[i * n + c] = col[i] / best;
    }
  }
  __syncwarp();
  if (live) {
    for (int e = j; e < n * n; e += G) U[b * n * n + e] = bad ? nan : out[e];
  }
}

template <int M>
int eigh_launch(const float* A, float* w, float* V, int batch, int n, int max_sweeps,
                int lapack, cudaStream_t stream) {
  const int per_block = kThreads / group_lanes(M);
  eigh_kernel<M><<<(batch + per_block - 1) / per_block, kThreads, 0, stream>>>(
      A, w, V, batch, n, max_sweeps, lapack);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int svd_launch(const float* A, float* U, float* S, float* Vt, int batch, int n, int max_sweeps,
               cudaStream_t stream) {
  const int per_block = kThreads / group_lanes(M);
  svd_kernel<M><<<(batch + per_block - 1) / per_block, kThreads, 0, stream>>>(
      A, U, S, Vt, batch, n, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sl_eigh_launch(const float* A, float* w, float* V, int batch, int n,
                              int max_sweeps, int lapack_signs, int device, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || max_sweeps < 0 || (lapack_signs && n != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n + (n & 1)) {
    case 2: return eigh_launch<2>(A, w, V, batch, n, max_sweeps, lapack_signs, s);
    case 4: return eigh_launch<4>(A, w, V, batch, n, max_sweeps, lapack_signs, s);
    case 6: return eigh_launch<6>(A, w, V, batch, n, max_sweeps, lapack_signs, s);
    case 8: return eigh_launch<8>(A, w, V, batch, n, max_sweeps, lapack_signs, s);
    case 10: return eigh_launch<10>(A, w, V, batch, n, max_sweeps, lapack_signs, s);
    default: return eigh_launch<12>(A, w, V, batch, n, max_sweeps, lapack_signs, s);
  }
}

extern "C" int sl_svd_launch(const float* A, float* U, float* S, float* Vt, int batch, int n,
                             int max_sweeps, int device, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxSvdN || max_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 2) return svd_launch<2>(A, U, S, Vt, batch, n, max_sweeps, s);
  return svd_launch<4>(A, U, S, Vt, batch, n, max_sweeps, s);
}

extern "C" int sl_max_n() { return kMaxN; }

extern "C" int sl_max_svd_n() { return kMaxSvdN; }

extern "C" const char* sl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
