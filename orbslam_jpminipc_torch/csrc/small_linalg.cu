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
// to rounding (the kernel contracts multiply-adds), not to the bit.
//
// What bounds it on this card: operations, and in practice latency. A
// 12x12 matrix is 576 bytes in and 624 out; a sweep is 11 rounds of 6
// rotations, each touching 4 rows and columns: ~3,500 flops a sweep, some
// 30 k for a matrix's ~8 sweeps. 257 of them are 0.3 MB and 8 M flops:
// 0.1 us at 3.35 TB/s, 0.12 us at 67 TFLOP/s. Neither is near: each
// rotation depends on the last round's, so a matrix is a chain of ~90
// dependent rounds of a few hundred cycles each, and one warp per matrix
// leaves the card mostly idle at these batches (257 warps on 132 SMs).
//
// What the design does about it: nothing beyond being simple and right, as
// a port's first kernel. One warp per matrix, 4 warps a block; the matrix
// and its accumulated rotations in shared memory (12x12 and its V in one
// thread's registers would spill); in each round lanes 0..m/2-1 compute the
// m/2 disjoint rotations, then the warp applies them to columns (A and V)
// and to rows (A), each lane a few (row, pair) tasks, with __syncwarp
// between the steps. A matrix leaves its loop after a sweep with no
// rotation (the vote is __any_sync), so the launch takes as long as its
// slowest matrix. Sorting and the sign convention are lane-parallel over
// the columns; the stable sort is one lane's insertion sort.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 12;                 // eigh; the padded size is kMaxN too
constexpr int kMaxSvdN = 4;
constexpr int kWarps = 4;                 // matrices per block
constexpr float kEps = 1.1920929e-07f;
constexpr float kEighTol = kEps;          // solvers/small_linalg.py:EIGH_TOL
constexpr float kSvdTol = 4.0f * kEps;    // SVD_TOL
constexpr float kBig = 1e18f;             // BIG
constexpr float kLapackEps = 5.9604645e-08f;      // LAPACK_EPS, 2^-24
constexpr float kLapackSafmin = 1.1754944e-38f;   // LAPACK_SAFMIN, 2^-126
constexpr float kLapackRtmin = 1.0842022e-19f;    // LAPACK_RTMIN, 2^-63
constexpr float kLapackRtmax = 6.5219088e+18f;    // LAPACK_RTMAX, 2^62.5
constexpr int kLapackSteps = 16;                  // LAPACK_STEPS

// the round-robin (circle method) order of solvers/small_linalg.py:rounds:
// pair k of round r for an even size m, as p < q
__device__ __forceinline__ void pair(int m, int r, int k, int& p, int& q) {
  int a, b;
  if (k == 0) {
    a = r;
    b = m - 1;
  } else {
    a = (r + k) % (m - 1);
    b = (r - k + (m - 1)) % (m - 1);
  }
  p = min(a, b);
  q = max(a, b);
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

// the index (first of equals) of the largest |x[i * stride]|, i < n
__device__ __forceinline__ int argmax_abs(const float* x, int n, int stride) {
  int best = 0;
  float v = fabsf(x[0]);
  for (int i = 1; i < n; ++i) {
    float a = fabsf(x[i * stride]);
    if (a > v) {
      v = a;
      best = i;
    }
  }
  return best;
}

// a stable ascending order of key[0..n) into order[]
__device__ __forceinline__ void stable_order(const float* key, int n, int* order) {
  for (int i = 0; i < n; ++i) {
    int j = i;
    while (j > 0 && key[order[j - 1]] > key[i]) {
      order[j] = order[j - 1];
      --j;
    }
    order[j] = i;
  }
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

__global__ void __launch_bounds__(32 * kWarps)
eigh_kernel(const float* __restrict__ A, float* __restrict__ w, float* __restrict__ V,
            int batch, int n, int max_sweeps, int lapack) {
  __shared__ float s_a[kWarps][kMaxN * kMaxN];
  __shared__ float s_v[kWarps][kMaxN * kMaxN];
  __shared__ float s_c[kWarps][kMaxN / 2], s_s[kWarps][kMaxN / 2];
  __shared__ float s_key[kWarps][kMaxN];
  __shared__ int s_order[kWarps][kMaxN];
  __shared__ float s_z[kWarps][9];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long b = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (b >= batch) return;  // the whole warp: no __syncwarp below misses a lane
  float* a = s_a[warp];
  float* v = s_v[warp];
  float* cs = s_c[warp];
  float* ss = s_s[warp];
  const int m = n + (n & 1), half = m / 2;
  const float* Ab = A + b * n * n;

  bool bad = false;
  for (int e = lane; e < m * m; e += 32) {
    int i = e / m, j = e % m;
    float x = 0.0f;
    if (i < n && j < n) {
      float aij = Ab[i * n + j], aji = Ab[j * n + i];
      bad |= !isfinite(aij);
      x = 0.5f * (aij + aji);
    }
    a[e] = x;
    v[e] = i == j ? 1.0f : 0.0f;
  }
  bad = __any_sync(0xffffffffu, bad);
  __syncwarp();

  if (!bad) {
    for (int sweep = 0; sweep < max_sweeps; ++sweep) {
      bool rotated = false;
      for (int r = 0; r < m - 1; ++r) {
        int p = 0, q = 0;
        float app = 0.0f, aqq = 0.0f, apq = 0.0f, t = 0.0f;
        bool rot = false;
        if (lane < half) {
          pair(m, r, lane, p, q);
          app = a[p * m + p];
          aqq = a[q * m + q];
          apq = a[p * m + q];
          rot = fabsf(apq) > kEighTol * sqrtf(fabsf(app)) * sqrtf(fabsf(aqq));
          float c = 1.0f, s = 0.0f;
          if (rot) rotation(aqq - app, apq, c, s, t);
          cs[lane] = c;
          ss[lane] = s;
          rotated |= rot;
        }
        __syncwarp();
        // columns of A and V: task (row i, pair k)
        for (int e = lane; e < m * half; e += 32) {
          int i = e / half, k = e % half, pp, qq;
          pair(m, r, k, pp, qq);
          float c = cs[k], s = ss[k];
          float xp = a[i * m + pp], xq = a[i * m + qq];
          a[i * m + pp] = c * xp - s * xq;
          a[i * m + qq] = s * xp + c * xq;
          xp = v[i * m + pp];
          xq = v[i * m + qq];
          v[i * m + pp] = c * xp - s * xq;
          v[i * m + qq] = s * xp + c * xq;
        }
        __syncwarp();
        // rows of A: task (pair k, column j)
        for (int e = lane; e < half * m; e += 32) {
          int k = e / m, j = e % m, pp, qq;
          pair(m, r, k, pp, qq);
          float c = cs[k], s = ss[k];
          float xp = a[pp * m + j], xq = a[qq * m + j];
          a[pp * m + j] = c * xp - s * xq;
          a[qq * m + j] = s * xp + c * xq;
        }
        __syncwarp();
        // the rotated 2x2 blocks, exactly
        if (rot) {
          a[p * m + p] = app - t * apq;
          a[q * m + q] = aqq + t * apq;
          a[p * m + q] = 0.0f;
          a[q * m + p] = 0.0f;
        }
        __syncwarp();
      }
      if (!__any_sync(0xffffffffu, rotated)) break;
    }
  }

  // ascending, stable; then each column's sign
  float* key = s_key[warp];
  int* order = s_order[warp];
  if (lane < n) key[lane] = a[lane * m + lane];
  __syncwarp();
  if (lane == 0) {
    stable_order(key, n, order);
    if (lapack) {  // n == 3 (the wrapper checks): LAPACK's signs
      float S[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) S[i * 3 + j] = 0.5f * (Ab[i * 3 + j] + Ab[j * 3 + i]);
      lapack_vectors3(S, s_z[warp]);
    }
  }
  __syncwarp();
  float* wb = w + b * n;
  float* Vb = V + b * n * n;
  const float nan = __int_as_float(0x7fffffff);
  if (lane < n) {
    int col = order[lane];
    wb[lane] = bad ? nan : key[col];
    float sgn;
    if (lapack) {
      float dot = 0.0f;
      for (int i = 0; i < 3; ++i) dot += s_z[warp][i * 3 + lane] * v[i * m + col];
      sgn = dot < 0.0f ? -1.0f : 1.0f;
    } else {
      sgn = v[argmax_abs(v + col, n, m) * m + col] < 0.0f ? -1.0f : 1.0f;
    }
    for (int i = 0; i < n; ++i) Vb[i * n + lane] = bad ? nan : sgn * v[i * m + col];
  }
}

__global__ void __launch_bounds__(32 * kWarps)
svd_kernel(const float* __restrict__ A, float* __restrict__ U, float* __restrict__ S,
           float* __restrict__ Vt, int batch, int n, int max_sweeps) {
  constexpr int kM = kMaxSvdN;  // padded column count
  __shared__ float s_u[kWarps][kMaxSvdN * kM];
  __shared__ float s_v[kWarps][kM * kM];
  __shared__ float s_c[kWarps][kM / 2], s_s[kWarps][kM / 2];
  __shared__ float s_key[kWarps][kM];
  __shared__ float s_sig[kWarps][kM];
  __shared__ int s_order[kWarps][kM];
  __shared__ float s_out[kWarps][kMaxSvdN * kMaxSvdN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long b = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (b >= batch) return;
  float* u = s_u[warp];  // n rows x m columns, row-major
  float* v = s_v[warp];  // m x m
  float* cs = s_c[warp];
  float* ss = s_s[warp];
  const int m = n + (n & 1), half = m / 2;
  const float* Ab = A + b * n * n;

  bool bad = false;
  for (int e = lane; e < m * m; e += 32) {
    int i = e / m, j = e % m;
    if (i < n) {
      float x = j < n ? Ab[i * n + j] : 0.0f;
      bad |= !isfinite(x);
      u[i * m + j] = x;
    }
    v[e] = i == j ? 1.0f : 0.0f;
  }
  bad = __any_sync(0xffffffffu, bad);
  __syncwarp();

  if (!bad) {
    for (int sweep = 0; sweep < max_sweeps; ++sweep) {
      bool rotated = false;
      for (int r = 0; r < m - 1; ++r) {
        if (lane < half) {
          int p, q;
          pair(m, r, lane, p, q);
          float alpha = 0.0f, beta = 0.0f, gamma = 0.0f;
          for (int i = 0; i < n; ++i) {
            float xp = u[i * m + p], xq = u[i * m + q];
            alpha += xp * xp;
            beta += xq * xq;
            gamma += xp * xq;
          }
          bool rot = fabsf(gamma) > kSvdTol * sqrtf(alpha) * sqrtf(beta);
          float c = 1.0f, s = 0.0f, t;
          if (rot) rotation(beta - alpha, gamma, c, s, t);
          cs[lane] = c;
          ss[lane] = s;
          rotated |= rot;
        }
        __syncwarp();
        // columns of U (n rows) and V (m rows): task (row i, pair k)
        for (int e = lane; e < m * half; e += 32) {
          int i = e / half, k = e % half, p, q;
          pair(m, r, k, p, q);
          float c = cs[k], s = ss[k];
          if (i < n) {
            float xp = u[i * m + p], xq = u[i * m + q];
            u[i * m + p] = c * xp - s * xq;
            u[i * m + q] = s * xp + c * xq;
          }
          float xp = v[i * m + p], xq = v[i * m + q];
          v[i * m + p] = c * xp - s * xq;
          v[i * m + q] = s * xp + c * xq;
        }
        __syncwarp();
      }
      if (!__any_sync(0xffffffffu, rotated)) break;
    }
  }

  // singular values descending (stable), V's sign convention, U's columns
  float* key = s_key[warp];
  float* sig = s_sig[warp];
  int* order = s_order[warp];
  float* out = s_out[warp];  // U, n x n row-major
  if (lane < n) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc += u[i * m + lane] * u[i * m + lane];
    sig[lane] = sqrtf(acc);
    key[lane] = -sig[lane];
  }
  __syncwarp();
  if (lane == 0) stable_order(key, n, order);
  __syncwarp();
  if (lane < n) {
    int col = order[lane];
    float sv = sig[col];
    float sgn = v[argmax_abs(v + col, n, m) * m + col] < 0.0f ? -1.0f : 1.0f;
    for (int i = 0; i < n; ++i) {
      out[i * n + lane] = sv > 0.0f ? sgn * u[i * m + col] / sv : 0.0f;
      Vt[b * n * n + lane * n + i] = bad ? __int_as_float(0x7fffffff) : sgn * v[i * m + col];
    }
    S[b * n + lane] = bad ? __int_as_float(0x7fffffff) : sv;
  }
  __syncwarp();
  // a zero singular value's column: the unit vector with the largest
  // residual against the columns so far (solvers/small_linalg.py:_complete)
  if (lane == 0) {
    for (int j = 0; j < n; ++j) {
      if (sig[order[j]] > 0.0f) continue;
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
      for (int i = 0; i < n; ++i) out[i * n + j] = col[i] / best;
    }
  }
  __syncwarp();
  for (int e = lane; e < n * n; e += 32) {
    U[b * n * n + e] = bad ? __int_as_float(0x7fffffff) : out[e];
  }
}

int blocks_for(int batch) { return (batch + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int sl_eigh_launch(const float* A, float* w, float* V, int batch, int n,
                              int max_sweeps, int lapack_signs, int device, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || max_sweeps < 0 || (lapack_signs && n != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  eigh_kernel<<<blocks_for(batch), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      A, w, V, batch, n, max_sweeps, lapack_signs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sl_svd_launch(const float* A, float* U, float* S, float* Vt, int batch, int n,
                             int max_sweeps, int device, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxSvdN || max_sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  svd_kernel<<<blocks_for(batch), 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      A, U, S, Vt, batch, n, max_sweeps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sl_max_n() { return kMaxN; }

extern "C" int sl_max_svd_n() { return kMaxSvdN; }

extern "C" const char* sl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
