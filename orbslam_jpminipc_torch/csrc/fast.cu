// FAST-9/16 corner score + strict 3x3 non-maximum suppression + border mask
// + per-cell threshold select, for every level of an image pyramid in ONE
// launch, for Hopper (built for sm_90a).
//
// Replaces: orbslam_jpminipc_tpu/ops/fast_pallas.py:fast_detect_tpu
// (_fast_kernel, _arc9_max), the Pallas TPU kernel of the reference package,
// and the high/low threshold select per 32-pixel cell that the extractor
// does around it (orbslam_jpminipc_tpu/ops/extractor.py:_select_level).
// Bit-identical to the plain PyTorch version,
// orbslam_jpminipc_torch/ops/fast.py:level_scores.
//
// What bounds it on this card: bytes, by the roofline rule. A 480x640
// frame's 8 levels hold 950,532 pixels. Each is read once and written once
// as float32: 7.6 MB, 2.3 us at 3.35 TB/s. In the form below each costs 114
// operations (2 x 40 three-input integer min/max for the arcs, 3 to turn a
// pixel into its key and 3 x 3 to turn the centre and the two arc results
// back, 2 subtractions, a negation, a max, a compare, a select and the -1, 8
// max for the nonmax, 7 compares and selects for the nonmax test, the border
// mask and the cell select): 108 M operations, 1.6 us at 67 T operations/s,
// below the bytes. That rate counts a fused multiply-add as two on 128 lanes
// per multiprocessor; integer min and max run on 64 lanes and there is no
// multiply to fuse, so the operations take at least four times that in
// practice, and the kernel's measured time is set by them and by the
// shared-memory reads, not by memory. The tensor cores have no part in it:
// there is no product anywhere. Below a few microseconds a launch is bound
// by its own latency, so a launch per level (the smallest level has 24 k
// pixels) can never come near the bound.
//
// What the design does about it:
//   * one launch for the whole pyramid. The kernel gets a table by value
//     (per level: pointers, H, W, its range of tile indices); a block finds
//     the level of its tile index and handles the ragged edges itself. 998
//     tiles of 32x32 cover the 8 levels of a 480x640 frame, one block
//     each: 7.6 blocks per multiprocessor, three resident at a time, so a
//     block's copies overlap its neighbours' arithmetic. Fewer blocks that
//     stride over the tiles and bring in their next tile while they score
//     the current one were measured and were no faster;
//   * fewer min/max. Subtracting the centre is monotone, so the arcs are
//     taken on the pixels themselves and the centre is subtracted once per
//     polarity; the pixels are turned into integers of the same order when
//     the tile is staged, and a 9-arc is 3 x 3 with Hopper's 3-input integer
//     min/max (__vimin3_s32, __vimax3_s32): 2 x 40 a pixel, where 16 starts
//     x 8 steps x 2 polarities cost 256 and doubling (2, 4, 8, 8 + 1, as
//     _arc9_max does) 2 x 79;
//   * a thread scores a column of 5 pixels from a register window of the
//     staged tile (63 shared-memory reads for 5 pixels, where 5 x 17 = 85),
//     with its row and column worked out once, not per pixel;
//   * the cell select in the same pass: the extractor's cell grid starts at
//     (0, 0) with edge 32, so a cell is a tile, and "does this cell hold a
//     high-threshold corner" is one block-wide vote (__syncthreads_or);
//   * cp.async stages the (32+8)x(32+8) input tile (halo 3 for the circle,
//     1 for the nonmax ring) with zero fill outside the image. Copies are
//     16 bytes where the level's rows are 16-byte aligned (width
//     a multiple of 4: 640 and 444 of the 8 widths) and 4 bytes elsewhere.
//     TMA would give the zero fill for free, but it needs a row pitch that
//     is a multiple of 16 bytes; widths such as 533 and 370 are not, and
//     re-pitching the levels would cost a copy of every level per frame
//     (more than the kernel), so TMA is not used.
//
// Exactness: min and max pick one of their operands, in any order and in
// any order-preserving encoding; x -> x - c is monotone under rounding, so
// min over an arc of (x - c) is (min over the arc of x) - c, and min over an
// arc of -(x - c) is -((max over the arc of x) - c); a zero of either sign
// never passes `m > threshold` with threshold > 0. What is left are the
// plain version's float32 operations (subtract, -1.0, +1.0, compare). There
// is no multiply, so nothing can contract into an FMA (and the build passes
// -fmad=false regardless).

#include <cuda_runtime.h>
#include <math.h>

constexpr int kMaxLevels = 16;

// One pyramid level. `vec` says that 16-byte copies are safe: the input
// pointer is 16-byte aligned and W is a multiple of 4.
struct FastLevel {
  const float* in;
  float* out;
  int H, W;
  int tiles_x;     // tiles per tile row: ceil(W / 32)
  int tile_begin;  // first tile index of this level
  int tile_end;    // one past its last
  int vec;
};

struct FastTable {
  FastLevel lv[kMaxLevels];
  int n_levels;
  int n_tiles;
};

namespace {

constexpr int kTile = 32;                 // output tile edge = cell edge
constexpr int kHalo = 4;                  // circle radius 3 + nonmax ring 1
constexpr int kIn = kTile + 2 * kHalo;    // staged input tile edge (40)
constexpr int kSc = kTile + 2;            // score tile edge incl. ring (34)
constexpr int kScPitch = kSc + 1;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;             // resident blocks per multiprocessor
constexpr int kRun = 5;                   // scores per thread, down a column
constexpr int kStrips = (kSc + kRun - 1) / kRun;  // 7 strips of rows
constexpr int kWinRows = kRun + 6;        // input rows a run of kRun needs
constexpr int kChunks = kIn / 4;          // 16-byte chunks per staged row

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;  // src-size 0: the 4 bytes are zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

// Wait for every copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A tile of one level: where it lies and what it reads and writes.
struct TileRef {
  const float* in;
  float* out;
  int H, W, vec;
  int x0, y0;
};

// The level of tile index `tile` (< tab.n_tiles) and the tile's origin in it.
__device__ __forceinline__ TileRef locate(const FastTable& tab, int tile) {
  int lvl = 0;
  while (tile >= tab.lv[lvl].tile_end) ++lvl;
  const FastLevel& L = tab.lv[lvl];
  const int local = tile - L.tile_begin;
  const int ty = local / L.tiles_x;
  TileRef r;
  r.in = L.in;
  r.out = L.out;
  r.H = L.H;
  r.W = L.W;
  r.vec = L.vec;
  r.x0 = (local - ty * L.tiles_x) * kTile;
  r.y0 = ty * kTile;
  return r;
}

// Start the copies of the tile's (40, 40) input window into `buf`, zero
// outside the image. (row4, col4) and (row16, chunk16) are this thread's
// first item of the 4-byte and the 16-byte walk.
__device__ __forceinline__ void stage(float* buf, const TileRef& T, int row4, int col4,
                                      int row16, int chunk16) {
  const int gy0 = T.y0 - kHalo, gx0 = T.x0 - kHalo;
  if (T.vec) {
    // 400 chunks of 16 bytes, 256 threads: two rounds; 256 = 25 * 10 + 6
    int row = row16, ch = chunk16;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (row < kIn) {
        const int gy = gy0 + row, gx = gx0 + 4 * ch;
        // W is a multiple of 4, so a chunk lies wholly inside or outside
        const bool ok = gy >= 0 && gy < T.H && gx >= 0 && gx < T.W;
        cp_async16(buf + row * kIn + 4 * ch,
                   ok ? T.in + static_cast<size_t>(gy) * T.W + gx : T.in, ok);
      }
      ch += 6;
      row += 25;
      if (ch >= kChunks) {
        ch -= kChunks;
        ++row;
      }
    }
  } else {
    // 1600 floats, 256 threads: seven rounds; 256 = 6 * 40 + 16
    int row = row4, col = col4;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (row < kIn) {
        const int gy = gy0 + row, gx = gx0 + col;
        const bool ok = gy >= 0 && gy < T.H && gx >= 0 && gx < T.W;
        cp_async4(buf + row * kIn + col,
                  ok ? T.in + static_cast<size_t>(gy) * T.W + gx : T.in, ok);
      }
      col += 16;
      row += 6;
      if (col >= kIn) {
        col -= kIn;
        ++row;
      }
    }
  }
}

// Which entries of a thread's (kWinRows, 7) window a run of kRun pixels
// reads: centre column all rows; columns +-1 the rows 3 above and 3 below
// a pixel; +-2 the rows 2 above and below; +-3 the rows -1, 0, +1.
__device__ constexpr bool win_used(int r, int k) {
  const int a = k < 3 ? 3 - k : k - 3;
  return a == 0   ? true
         : a == 1 ? (r < kRun || r >= 6)
         : a == 2 ? (r >= 1 && r < kRun + 5)
                  : (r >= 2 && r < kRun + 4);
}

// An int whose signed order is the float's order (floats without NaN), and
// back; the map is its own inverse, and +0.0 (the zero fill) maps to 0.
__device__ __forceinline__ int float_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}
__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Turn the staged floats of this thread's own copies into keys, in place:
// the same walk as `stage`, after the thread has waited for its copies.
__device__ __forceinline__ void to_keys(int* buf, int vec, int row4, int col4, int row16,
                                        int chunk16) {
  if (vec) {
    int row = row16, ch = chunk16;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (row < kIn) {
        int4* q = reinterpret_cast<int4*>(buf + row * kIn + 4 * ch);
        int4 v = *q;
        v.x = float_key(v.x);
        v.y = float_key(v.y);
        v.z = float_key(v.z);
        v.w = float_key(v.w);
        *q = v;
      }
      ch += 6;
      row += 25;
      if (ch >= kChunks) {
        ch -= kChunks;
        ++row;
      }
    }
  } else {
    int row = row4, col = col4;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (row < kIn) buf[row * kIn + col] = float_key(buf[row * kIn + col]);
      col += 16;
      row += 6;
      if (col >= kIn) {
        col -= kIn;
        ++row;
      }
    }
  }
}

// Scores of the kRun pixels of score-tile column `c` from score-tile row
// `r0` on, into s_sc; -inf for a pixel outside the image (the -inf padding
// of the plain nonmax). `buf` holds the staged tile as keys.
//
// Subtracting the centre is monotone, so the min over an arc of (x - c) is
// (min over the arc of x) - c, rounded the same way: the arcs are taken on
// the pixels' keys with 3-input integer min/max (9 = 3 x 3), and the centre
// is subtracted once per polarity at the end.
__device__ __forceinline__ void score_run(const int* __restrict__ buf,
                                          float* __restrict__ s_sc, const TileRef& T, int r0,
                                          int c, float threshold) {
  // Bresenham circle of radius 3 in circular order (ops/fast.py CIRCLE_OFFSETS)
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  // score (r, c) is image pixel (y0 - 1 + r, x0 - 1 + c) and reads the
  // staged rows r .. r + 6, columns c .. c + 6 (centre at +3, +3)
  int win[kWinRows][7];
#pragma unroll
  for (int r = 0; r < kWinRows; ++r) {
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (win_used(r, k)) win[r][k] = buf[(r0 + r) * kIn + c + k];
    }
  }
  const int gx = T.x0 - 1 + c;
  const bool col_in = gx >= 0 && gx < T.W;
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    const int gy = T.y0 - 1 + r0 + p;
    float s = -INFINITY;
    if (col_in && gy >= 0 && gy < T.H) {
      const float centre = key_float(win[p + 3][3]);
      int q[16], u[16], v[16], w[5];
#pragma unroll
      for (int k = 0; k < 16; ++k) q[k] = win[p + 3 + dy[k]][3 + dx[k]];
      // brighter: max over the 16 starts of the min over the 9-arc
#pragma unroll
      for (int i = 0; i < 16; ++i) u[i] = __vimin3_s32(q[i], q[(i + 1) & 15], q[(i + 2) & 15]);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __vimin3_s32(u[i], u[(i + 3) & 15], u[(i + 6) & 15]);
#pragma unroll
      for (int i = 0; i < 5; ++i) w[i] = __vimax3_s32(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
      const float bright =
          key_float(max(__vimax3_s32(w[0], w[1], w[2]), __vimax3_s32(w[3], w[4], v[15]))) -
          centre;
      // darker: the min over an arc of -(x - c) is -((max over the arc of
      // x) - c), so the max over the starts is -((min of the arc maxes) - c)
#pragma unroll
      for (int i = 0; i < 16; ++i) u[i] = __vimax3_s32(q[i], q[(i + 1) & 15], q[(i + 2) & 15]);
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __vimax3_s32(u[i], u[(i + 3) & 15], u[(i + 6) & 15]);
#pragma unroll
      for (int i = 0; i < 5; ++i) w[i] = __vimin3_s32(v[3 * i], v[3 * i + 1], v[3 * i + 2]);
      const float dark =
          -(key_float(min(__vimin3_s32(w[0], w[1], w[2]), __vimin3_s32(w[3], w[4], v[15]))) -
            centre);
      const float m = fmaxf(bright, dark);
      s = (m > threshold) ? (m - 1.0f) : 0.0f;
    }
    s_sc[(r0 + p) * kScPitch + c] = s;
  }
}

// One block per 32x32 tile of one level.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fast_levels_kernel(const __grid_constant__ FastTable tab, float threshold, float fast_th,
                   int border, int select) {
  __shared__ __align__(16) float s_in[kIn * kIn];
  __shared__ float s_sc[kSc * kScPitch];

  const int t = threadIdx.x;
  // this thread's places in the three walks, worked out once
  const int row4 = t / kIn, col4 = t - row4 * kIn;
  const int row16 = t / kChunks, chunk16 = t - row16 * kChunks;
  const int strip = t / kSc, sc_c = t - strip * kSc;
  // the last strip starts one row early (29, not 30) so that its window
  // stays inside the staged tile; row 29 is then written twice, with the
  // same value
  const int sc_r0 = min(strip * kRun, kSc - kRun);
  const int nx = t & 31, ny0 = (t >> 5) * 4;  // nonmax: a column of 4 rows

  if (blockIdx.x >= tab.n_tiles) return;
  const TileRef T = locate(tab, blockIdx.x);
  stage(s_in, T, row4, col4, row16, chunk16);
  cp_async_wait_all();  // this thread's own copies have landed
  to_keys(reinterpret_cast<int*>(s_in), T.vec, row4, col4, row16, chunk16);
  __syncthreads();

  // 1. score of the tile + 1-pixel ring
  if (strip < kStrips) {
    score_run(reinterpret_cast<const int*>(s_in), s_sc, T, sc_r0, sc_c, threshold);
  }
  __syncthreads();

  // 2. strict 3x3 nonmax + border mask, 4 pixels down a column
  float v[6][3];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[r][k] = s_sc[(ny0 + r) * kScPitch + nx + k];
  }
  const int gx = T.x0 + nx;
  float lo[4], hi[4];
  bool any_hi = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gy = T.y0 + ny0 + j;
    const float c = v[j + 1][1];
    float nmax = fmaxf(fmaxf(v[j][0], v[j][1]), v[j][2]);
    nmax = fmaxf(nmax, fmaxf(v[j + 1][0], v[j + 1][2]));
    nmax = fmaxf(nmax, fmaxf(fmaxf(v[j + 2][0], v[j + 2][1]), v[j + 2][2]));
    const bool inside = gy >= border && gy < T.H - border && gx >= border &&
                        gx < T.W - border;  // also false outside the image
    lo[j] = (inside && c > nmax && c > 0.0f) ? c : 0.0f;
    // 3. the high-threshold map is a mask of the low-threshold one
    hi[j] = (lo[j] + 1.0f > fast_th) ? lo[j] : 0.0f;
    any_hi = any_hi || hi[j] > 0.0f;
  }
  // the cell's vote: does this tile hold a high-threshold corner?
  const bool use_hi = __syncthreads_or(select && any_hi) != 0;
  if (gx < T.W) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gy = T.y0 + ny0 + j;
      if (gy < T.H) {
        T.out[static_cast<size_t>(gy) * T.W + gx] = use_hi ? hi[j] : lo[j];
      }
    }
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream) for device `device`: every
// level of `tab` in one grid, one block per tile. `select` != 0 turns the
// per-cell high/low select on (`fast_th` is then the high threshold).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fast_levels_launch(const FastTable* tab, float threshold, float fast_th,
                                  int border, int select, int device, void* stream) {
  if (tab->n_levels < 1 || tab->n_levels > kMaxLevels || tab->n_tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fast_levels_kernel<<<tab->n_tiles, kThreads, 0, s>>>(*tab, threshold, fast_th, border, select);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fast_max_levels() { return kMaxLevels; }

extern "C" const char* fast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
