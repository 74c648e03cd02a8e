// Corner detection over a whole image pyramid in two launches: FAST-9/16
// or AGAST corners with the per-cell fallback, 3x3 non-maximum
// suppression, the optional Harris ranking at the survivors and the best
// corner of each bucket, for every level and camera.
//
// Replaces no TPU kernel. The JAX package writes extraction as a plain
// jnp chain that XLA fuses (multicol_slam_tpu/models/extractor.py:140-212,
// ops/fast.py:81-175); the port ran each op of that chain as its own CUDA
// kernel over a whole level, a few hundred passes over the pyramid a
// frame. Computes what the plain version computes, level by level
// (kernels/extract.py::detect_reference):
//   score = fast.fast_with_fallback(img, th_hi, th_lo, cell, ring)
//   score = where(score > 0, fast.harris_score(img) + 1e-6, 0)   (harris)
//   vals, args = fast.bucket_maxima(score, mask, bucket, border)
// and writes vals (C, L, T) float32 and args (C, L, T) int32, the columns
// past a level's tiles -inf and 0.
//
// Every value is a float subtract, product, sum, min, max or compare in the
// plain version's order, so the result is the plain version's bit for bit:
// - the ring: d_k = img(clamp(p + o_k)) - img(p) (edge replication),
//   bright = max_k min(d_k..d_k+arc-1), dark the same over -d, score =
//   max(bright, dark) - 1, kept where >= th (0 else);
// - the fallback: a cell (cell x cell level pixels from (0, 0), the last
//   ones partial) uses th_hi where any of its pixels has s_lo >= th_hi and
//   s_lo > 0, else th_lo;
// - non-maximum suppression: kept where >= all eight neighbours and > the
//   four earlier ones in raster order, -inf outside the image;
// - Harris: dx = (img(y, x+2) - img(y, x-2)) * 0.5, dy = (img(y-2, x) -
//   img(y+2, x)) * -0.5, clamped into the image; each product's 7x7 sum
//   over zero padding, seven columns from the left, then seven rows from
//   the top, each starting from 0; (a c - b b - k (a + c)^2) * scale^2,
//   + 1e-6;
// - a bucket's maximum: the first in raster order inside the tile, over
//   the tile's zero padding past the image too.
//
// The segment test as bit masks. Rounding is monotone, so fl(min(arc) - 1)
// = min over the arc of fl(d_k - 1), and score >= th exactly when some arc
// of ARC consecutive ring pixels has fl(d_k - 1) >= th at every pixel
// (the dark polarity: fl(-d_k - 1) >= th). As fl(x - 1) is monotone in x,
// fl(x - 1) >= th holds exactly when x >= t, t the least float that passes
// (diff_threshold, on the host): a pixel's bright bits are d_k >= t, its
// dark bits d_k <= -t, one N-bit mask each, and a run of ARC set bits
// around the ring is found by shift-and-AND doubling (has_run). The arc
// minima (best_arc) run only at pixels and polarities whose mask passes at
// th_lo; elsewhere s_lo is 0, as the plain version's.
//
// Design. Launch 1 (cell_flags): a CTA a (level, camera, cell) loads the
// cell and a ring's radius around it into shared memory with clamped
// coordinates and ORs the bit test at th_flag = max(th_lo, th_hi, the
// least positive float) (s_lo >= th_hi and s_lo > 0) over the cell's
// pixels into one byte, each warp stopping at the first hit it or another
// warp finds: no minima. Its first CTAs take a warp a bucket's tile and
// flag whether any of its pixels lies inside both the mask and the border
// (stopping at the first). Launch 2 (tile_maxima): a CTA a (level, camera,
// bucket) reads that flag and skips the tile without it (the answer is
// then 0 at index 0), else loads the tile and HALO = 5 pixels around it
// (the ring needs radius + 1 for the suppression's neighbours, Harris 3 +
// 2) with a cp.async a pixel, takes s_lo at the tile and one pixel around
// it where a pixel inside the border's rectangle can read it (the bit test
// at th_lo, the minima where it passes, the cell's flag where s_lo is not
// 0), suppresses, and with Harris on compacts each
// warp's survivors into a list of its own in raster order (a ballot an
// iteration; no CTA barrier) and runs Harris over the list with full
// warps: 7 lanes a survivor, lane j summing row j's seven columns from the
// left, then the survivor's first lane adding the seven row sums from the
// top (the plain order). Each thread keeps the first maximum of its
// pixels and survivors by (value, lower index), then the warps' and the
// CTA's. Every loop walks its area in a flat order with the row and column
// advanced by adds (Walk), and each division the kernels take is a
// multiply-shift by a constant the host computes (fastdiv), so no pixel
// pays a runtime division. A level table passed by value (MAX_LEVELS
// entries, a __grid_constant__) spreads the CTAs of every level and camera
// over one grid a launch. No atomics: a graph's replay equals the eager
// call.
//
// Bound on an H100 (3.35 TB/s; 33.5 T float32 instructions/s, 67 TFLOP/s
// counting a multiply-add as two): the three cameras' eight levels at
// 754x480 are 13.4 MB of float32 and 3.4 MB of masks, 5 us to read once;
// the bit test's compares at every pixel, the minima at the pixels that
// pass and Harris at the survivors are the least work (chip_smoke.py
// phase 19 counts each from its input). The kernel takes the bit test
// again at the buckets' pixels and their halo after the cells' (which
// stop at a hit), its minima in whole warps where any lane passes, and
// its CTAs wait on their windows' loads (PERF.md section 6).
//
// Built with --fmad=false (kernels/extract.py): Harris's products and sums
// round as PyTorch's separate kernels do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LEVELS 16
#define THREADS 128
#define CELL_THREADS 128     // launch 1's CTA: a cell's OR stops early, so smaller CTAs
#define WARPS (THREADS / 32)
#define MAX_EDGE 64     // the largest bucket and cell edge
#define MAX_ITERS (MAX_EDGE * MAX_EDGE / THREADS)    // a thread's pixels of a tile
#define WARP_LIST (MAX_ITERS * 32)   // a warp's survivors: at most its pixels
#define HALO 5          // Harris at a tile pixel reads 5 pixels out
#define TILE_CTAS_PER_SM 10  // launch 2's registers capped so 10 CTAs fit an SM

namespace {

// x / d as (x * m) >> 32, m = 2^32 / d + 1 (magic, on the host): exact
// while x * d < 2^32, which the host's size checks keep.
__device__ __forceinline__ int fastdiv(int x, unsigned long long m) {
  return (int)(((unsigned long long)(unsigned)x * m) >> 32);
}

struct Level {
  const float* img;      // (C, H, W)
  const uint8_t* mask;   // (C, H, W) bool
  int H, W, bucket, nbx, tiles, cells_x, cells;
  int cell_cta0;         // the level's first CTA in launch 1
  int tile_cta0;         // the level's first CTA in launch 2
  int flag0;             // the level's first flag: flag0 + c * cells + cell
  unsigned long long div_cells, div_cells_x, div_tiles, div_nbx;
  unsigned long long div_b, div_b2, div_bh;   // by bucket, bucket + 2, bucket + 2 HALO
};

struct Table {
  Level lv[MAX_LEVELS];
  int L, C, T, cell, border, harris;
  int cell_iters;        // a thread's pixels of a cell: cell^2 / CELL_THREADS, rounded up
  int need_ctas;         // launch 1's first CTAs test the tiles' masks, the rest the cells
  int tile_ctas;         // the tiles (launch 2's CTAs)
  int need0;             // the tiles' need flags: flags[need0 + tile]
  float th_hi, th_lo, harris_k, harris_scale2;
  float t_lo, t_flag;    // a ring difference's thresholds: fl(d - 1) >= th iff d >= t
  unsigned long long div_cell, div_cell_win;   // by the cell edge, by cell + 2 R
};

// The rings as (dy, dx) in OpenCV's pixel order (ops/fast.py CIRCLE,
// CIRCLE_12, CIRCLE_8); constant-folded into each load's offset.
template <int N> struct Ring;
template <> struct Ring<16> {
  static constexpr int ARC = 9, R = 3;
  __device__ static constexpr int at(int k, int axis) {
    constexpr int RING16[16][2] = {
        {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3}, {1, 3}, {2, 2}, {3, 1},
        {3, 0}, {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};
    return RING16[k][axis];
  }
};
template <> struct Ring<12> {
  static constexpr int ARC = 7, R = 2;
  __device__ static constexpr int at(int k, int axis) {
    constexpr int RING12[12][2] = {
        {-2, 0}, {-2, 1}, {-1, 2}, {0, 2}, {1, 2}, {2, 1},
        {2, 0}, {2, -1}, {1, -2}, {0, -2}, {-1, -2}, {-2, -1}};
    return RING12[k][axis];
  }
};
template <> struct Ring<8> {
  static constexpr int ARC = 5, R = 1;
  __device__ static constexpr int at(int k, int axis) {
    constexpr int RING8[8][2] = {
        {-1, 0}, {-1, 1}, {0, 1}, {1, 1}, {1, 0}, {1, -1}, {0, -1}, {-1, -1}};
    return RING8[k][axis];
  }
};

// Whether the N-bit ring mask m holds a run of ARC set bits, around the
// ring: x is the ring twice, so bit k of r has bits k..k + w - 1 of x set
// after each doubling, and the last step joins two runs of w to ARC.
template <int N, int ARC>
__device__ __forceinline__ bool has_run(unsigned m) {
  const unsigned x = m | (m << N);
  unsigned r = x;
  int w = 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (2 * w <= ARC) {
      r &= r >> w;
      w *= 2;
    }
  if (ARC > w) r &= r >> (ARC - w);
  return (r & ((1u << N) - 1u)) != 0u;
}

// max over k of min(v[k], ..., v[k + ARC - 1]) around the ring: the arc
// minima by doubling (widths 1, 2, 4, ... joined by ARC's bits); a min
// is exact, so any grouping gives the plain version's values.
template <int N, int ARC>
__device__ __forceinline__ float best_arc(const float (&v)[N]) {
  float pw[N], acc[N], nxt[N];
#pragma unroll
  for (int k = 0; k < N; ++k) pw[k] = v[k];
  int width = 1, have = 0;
#pragma unroll
  for (int bit = 0; bit < 5; ++bit) {
    if (ARC & (1 << bit)) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        acc[k] = have ? fminf(acc[k], pw[(k + have) % N]) : pw[k];
      have += width;
    }
    if ((ARC >> (bit + 1)) == 0) break;
#pragma unroll
    for (int k = 0; k < N; ++k) nxt[k] = fminf(pw[k], pw[(k + width) % N]);
#pragma unroll
    for (int k = 0; k < N; ++k) pw[k] = nxt[k];
    width *= 2;
  }
  float best = acc[0];
#pragma unroll
  for (int k = 1; k < N; ++k) best = fmaxf(best, acc[k]);
  return best;
}

// The ring's differences at the window position p and their bit masks
// against t: bright d_k >= t, dark d_k <= -t. A compare gives all ones
// or 0 (PTX set), and m + m - that shifts the bit in, so a bit costs two
// instructions; the masks come out reversed (pixel 0 the highest bit),
// which has_run does not see: a run around the ring reversed is one.
template <int N>
__device__ __forceinline__ void ring_bits(const float* win, int ws, int p, float t, float (&d)[N],
                                          bool& bright, bool& dark) {
  const float c = win[p];
  unsigned mb = 0u, md = 0u;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    d[k] = win[p + Ring<N>::at(k, 0) * ws + Ring<N>::at(k, 1)] - c;
    unsigned ge, le;
    asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(ge) : "f"(d[k]), "f"(t));
    asm("set.le.u32.f32 %0, %1, %2;" : "=r"(le) : "f"(d[k]), "f"(-t));
    mb = mb + mb - ge;
    md = md + md - le;
  }
  bright = has_run<N, Ring<N>::ARC>(mb);
  dark = has_run<N, Ring<N>::ARC>(md);
}

// s_lo at the window position p: the segment-test score where it is >=
// th_lo (the bit test at t_lo, then the arc minima of the polarity that
// passes), 0 else. With t > 0 a bright and a dark arc would share a ring
// pixel (2 ARC > N), so at most one polarity passes, and one that fails
// lies below th_lo, so below the other: its minima are not needed. Only
// th_lo <= -1 (t <= 0) lets both pass, and then both are taken.
template <int N>
__device__ __forceinline__ float ring_score(const float* win, int ws, int p, float t_lo,
                                            float th_lo) {
  static_assert(2 * Ring<N>::ARC > N, "a bright and a dark arc must overlap");
  float d[N];
  bool bright, dark;
  ring_bits<N>(win, ws, p, t_lo, d, bright, dark);
  if (!(bright || dark)) return 0.0f;
  if (!bright) {                   // the dark arcs: the minima of -d
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = -d[k];
  }
  float best = best_arc<N, Ring<N>::ARC>(d);
  if (bright && dark) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = -d[k];
    best = fmaxf(best, best_arc<N, Ring<N>::ARC>(d));
  }
  const float score = best - 1.0f;
  return score >= th_lo ? score : 0.0f;
}

// The CTA's pixels i = threadIdx.x, + NT, ... of an area m wide (NT
// threads), as (row, column) advanced by adds; `it` counts the thread's
// iterations.
template <int NT = THREADS>
struct Walk {
  int r, c, dr, dc, m, it;
  __device__ Walk(int m_, unsigned long long div_m) : m(m_), it(0) {
    r = fastdiv(threadIdx.x, div_m);
    c = threadIdx.x - r * m;
    dr = fastdiv(NT, div_m);
    dc = NT - dr * m;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= m) {
      c -= m;
      ++r;
    }
    ++it;
  }
};

// The level of CTA `blk`: the last whose first CTA is <= blk.
__device__ __forceinline__ int level_of(const Table& t, int blk, bool tiles) {
  int l = 0;
  for (int i = 1; i < t.L; ++i)
    if ((tiles ? t.lv[i].tile_cta0 : t.lv[i].cell_cta0) <= blk) l = i;
  return l;
}

// Starts copying rows [y0, y0 + n) and columns [x0, x0 + n) of camera c's
// level image with clamped coordinates (edge replication) into win (n x
// n): one cp.async a pixel, all in flight at once; window_wait ends them.
template <int NT>
__device__ __forceinline__ void load_window(float* win, const float* img, int H, int W,
                                            int y0, int x0, int n, unsigned long long div_n) {
  for (Walk<NT> p(n, div_n); p.r < n; p.next()) {
    const int y = min(max(y0 + p.r, 0), H - 1);
    const int x = min(max(x0 + p.c, 0), W - 1);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(win + p.r * n + p.c);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(img + (size_t)y * W + x));
  }
}

// This thread's copies done, then the CTA's.
__device__ __forceinline__ void window_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Launch 1's first CTAs, a warp a tile: flags[need0 + tile] = whether any
// pixel of the tile lies inside both the mask and the border (eight rows
// at a time, a lane two columns of each; the warp stops at the first).
__device__ __forceinline__ void tile_need(const Table& t, int tile_g, uint8_t* flags) {
  const int lane = threadIdx.x % 32;
  const Level& L = t.lv[level_of(t, tile_g, true)];
  const int rel = tile_g - L.tile_cta0;
  const int cam = fastdiv(rel, L.div_tiles), tile = rel - cam * L.tiles;
  const int ty = fastdiv(tile, L.div_nbx);
  const int b = L.bucket, ty0 = ty * b, tx0 = (tile - ty * L.nbx) * b;
  const uint8_t* mask = L.mask + (size_t)cam * L.H * L.W;
  int hit = 0;
  for (int r0 = 0; r0 < b; r0 += 8) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int y = ty0 + r0 + q;
      if (r0 + q < b && y >= t.border && y < L.H - t.border)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int x = tx0 + lane + 32 * k;
          if (lane + 32 * k < b && x >= t.border && x < L.W - t.border)
            hit |= mask[(size_t)y * L.W + x];
        }
    }
    if (__any_sync(0xffffffffu, hit)) break;
  }
  hit = __any_sync(0xffffffffu, hit);
  if (lane == 0) flags[t.need0 + tile_g] = (uint8_t)(hit != 0);
}

// Launch 1: the tiles' need flags (the first need_ctas CTAs, scheduled
// first, so their loads overlap the cells'); then flags[cell] = any pixel
// of the cell with s_lo >= th_hi, s_lo > 0.
template <int N>
__global__ void __launch_bounds__(CELL_THREADS) cell_flags(const __grid_constant__ Table t,
                                                      uint8_t* __restrict__ flags) {
  extern __shared__ float win[];
  __shared__ int found;
  const int blk = (int)blockIdx.x - t.need_ctas;
  if (blk < 0) {
    const int tile_g = (int)blockIdx.x * (CELL_THREADS / 32) + threadIdx.x / 32;
    if (tile_g < t.tile_ctas) tile_need(t, tile_g, flags);
    return;
  }
  const Level& L = t.lv[level_of(t, blk, false)];
  if (threadIdx.x == 0) found = 0;
  const int rel = blk - L.cell_cta0;
  const int cam = fastdiv(rel, L.div_cells), cell = rel - cam * L.cells;
  const int cy = fastdiv(cell, L.div_cells_x);
  const int cy0 = cy * t.cell, cx0 = (cell - cy * L.cells_x) * t.cell;
  constexpr int R = Ring<N>::R;
  const int n = t.cell + 2 * R;
  load_window<CELL_THREADS>(win, L.img + (size_t)cam * L.H * L.W, L.H, L.W, cy0 - R, cx0 - R,
                            n, t.div_cell_win);
  window_wait();
  // the OR of the cell's bit tests: a warp stops at its first hit, and
  // the others at their next pixel after it (an OR needs no more)
  const int h = min(t.cell, L.H - cy0), w = min(t.cell, L.W - cx0);
  int hit = 0;
  Walk<CELL_THREADS> p(t.cell, t.div_cell);
  for (int it = 0; it < t.cell_iters; ++it) {
    if (p.r < h && p.c < w) {
      float d[N];
      bool bright, dark;
      ring_bits<N>(win, n, (p.r + R) * n + p.c + R, t.t_flag, d, bright, dark);
      hit |= bright || dark;
    }
    p.next();
    if (__any_sync(0xffffffffu, hit)) {
      *(volatile int*)&found = 1;
      break;
    }
    if (*(volatile int*)&found) break;
  }
  hit = __syncthreads_or(hit);
  if (threadIdx.x == 0) flags[L.flag0 + cam * L.cells + cell] = (uint8_t)(hit != 0);
}

// (value, index) ordered as "a first maximum": the larger value, or the
// lower index of equal values.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

__device__ __forceinline__ void keep_better(float v, int i, float& best, int& arg) {
  if (better(v, i, best, arg)) {
    best = v;
    arg = i;
  }
}

// Launch 2: each bucket's maximum and its first index inside the tile, a
// CTA a tile.
template <int N>
__global__ void __launch_bounds__(THREADS, TILE_CTAS_PER_SM)
tile_maxima(const __grid_constant__ Table t, const uint8_t* __restrict__ flags,
            float* __restrict__ vals, int* __restrict__ args) {
  extern __shared__ float smem[];  // the window, then the scores
  __shared__ unsigned short list[WARPS * WARP_LIST];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  const int blk = blockIdx.x;
  const int l = level_of(t, blk, true);
  const Level& L = t.lv[l];
  const int rel = blk - L.tile_cta0;
  const int cam = fastdiv(rel, L.div_tiles), tile = rel - cam * L.tiles;
  const int ty = fastdiv(tile, L.div_nbx);
  const int b = L.bucket;
  const int ty0 = ty * b, tx0 = (tile - ty * L.nbx) * b;
  const size_t out = ((size_t)cam * t.L + l) * t.T;
  const int H = L.H, W = L.W;
  const uint8_t* mask = L.mask + (size_t)cam * H * W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  // padding columns past the level's tiles, written by its last tile
  if (tile == L.tiles - 1)
    for (int j = L.tiles + threadIdx.x; j < t.T; j += THREADS) {
      vals[out + j] = -INFINITY;
      args[out + j] = 0;
    }

  // a tile with no pixel inside the mask and the border (launch 1's need
  // flag): 0 at index 0
  if (!flags[t.need0 + blk]) {
    if (threadIdx.x == 0) {
      vals[out + tile] = 0.0f;
      args[out + tile] = 0;
    }
    return;
  }
  const int n = b + 2 * HALO;      // the image window
  const int m = b + 2;             // the scores, one pixel around the tile
  float* win = smem;
  float* comb = smem + n * n;
  load_window<THREADS>(win, L.img + (size_t)cam * H * W, H, W, ty0 - HALO, tx0 - HALO, n,
                       L.div_bh);
  auto inside = [&](int y, int x) {
    return y >= t.border && y < H - t.border && x >= t.border && x < W - t.border &&
           mask[(size_t)y * W + x];
  };
  window_wait();
  // s_lo where an inside pixel's suppression reads it: inside the image
  // and within one pixel of the border's rectangle (-inf elsewhere)
  const uint8_t* cflag = flags + L.flag0 + cam * L.cells;
  const int y_lo = max(t.border - 1, 0), y_hi = min(H - t.border, H - 1);
  const int x_lo = max(t.border - 1, 0), x_hi = min(W - t.border, W - 1);
  for (Walk<> p(m, L.div_b2); p.r < m; p.next()) {
    const int y = ty0 - 1 + p.r, x = tx0 - 1 + p.c;
    float v = -INFINITY;
    if (y >= y_lo && y <= y_hi && x >= x_lo && x <= x_hi) {
      v = ring_score<N>(win, n, (p.r + HALO - 1) * n + p.c + HALO - 1, t.t_lo, t.th_lo);
      if (v != 0.0f && !(v >= t.th_hi) &&
          cflag[fastdiv(y, t.div_cell) * L.cells_x + fastdiv(x, t.div_cell)])
        v = 0.0f;
    }
    comb[p.r * m + p.c] = v;
  }
  __syncthreads();

  // suppression; a survivor with Harris on waits for the list, any other
  // pixel enters the first maximum with its value (0 outside the mask)
  float best = -INFINITY;
  int arg = 0x7fffffff;
  unsigned survived = 0u;
  for (Walk<> p(b, L.div_b); p.r < b; p.next()) {
    const int y = ty0 + p.r, x = tx0 + p.c;
    float s = 0.0f;
    if (inside(y, x)) {
      const int q = (p.r + 1) * m + p.c + 1;
      const float v = comb[q];
      const float e = fmaxf(fmaxf(comb[q - m - 1], comb[q - m]), fmaxf(comb[q - m + 1],
                                                                       comb[q - 1]));
      const float f = fmaxf(fmaxf(comb[q + 1], comb[q + m - 1]), fmaxf(comb[q + m],
                                                                       comb[q + m + 1]));
      s = (v >= fmaxf(e, f) && v > e) ? v : 0.0f;
    }
    if (t.harris && s > 0.0f)
      survived |= 1u << p.it;
    else
      keep_better(s, p.r * b + p.c, best, arg);
  }

  if (t.harris) {
    // the warp's survivors into its own list in raster order (its pixel i
    // = threadIdx.x + THREADS it: by iteration, then lane), a ballot an
    // iteration; no other warp waits for it
    unsigned short* own = list + warp * WARP_LIST;
    const int iters = (b * b + THREADS - 1) / THREADS;
    int n_surv = 0;
    for (int it = 0; it < iters; ++it) {
      const unsigned bit = (survived >> it) & 1u;
      const unsigned ballot = __ballot_sync(0xffffffffu, bit);
      if (bit)
        own[n_surv + __popc(ballot & ((1u << lane) - 1u))] =
            (unsigned short)(threadIdx.x + THREADS * it);
      n_surv += __popc(ballot);
    }
    __syncwarp();

    // Harris over the list: 4 survivors at a time, lanes 7 g .. 7 g + 6
    // the rows of survivor g; lanes 28-31 idle
    const int g = lane / 7, j = lane - 7 * g;
    for (int s0 = 0; s0 < n_surv; s0 += 4) {
      const int sv = s0 + g;
      const bool active = g < 4 && sv < n_surv;
      int i = 0, y = 0, x = 0, dyt = 0, dxt = 0;
      float ha = 0.0f, hb = 0.0f, hc = 0.0f;
      if (active) {
        i = own[sv];
        dyt = fastdiv(i, L.div_b);
        dxt = i - dyt * b;
        y = ty0 + dyt;
        x = tx0 + dxt;
        const int yy = y + j - 3;
        if (yy >= 0 && yy < H) {
          const int q0 = (dyt + HALO + j - 3) * n + dxt + HALO - 3;
#pragma unroll
          for (int c = 0; c < 7; ++c) {
            const int xx = x + c - 3;
            float ta = 0.0f, tb = 0.0f, tc = 0.0f;
            if (xx >= 0 && xx < W) {
              const int q = q0 + c;
              const float gx = (win[q + 2] - win[q - 2]) * 0.5f;
              const float gy = (win[q - 2 * n] - win[q + 2 * n]) * -0.5f;
              ta = gx * gx;
              tb = gx * gy;
              tc = gy * gy;
            }
            ha = ha + ta;
            hb = hb + tb;
            hc = hc + tc;
          }
        }
      }
      float a = 0.0f, bb = 0.0f, c = 0.0f;
#pragma unroll
      for (int r = 0; r < 7; ++r) {
        const int src = 7 * g + r;
        a = a + __shfl_sync(0xffffffffu, ha, src);
        bb = bb + __shfl_sync(0xffffffffu, hb, src);
        c = c + __shfl_sync(0xffffffffu, hc, src);
      }
      if (active && j == 0) {
        const float s = a + c;
        const float h = (a * c - bb * bb - t.harris_k * (s * s)) * t.harris_scale2;
        keep_better(h + 1e-6f, i, best, arg);
      }
    }
  }

  // the warp's, then the CTA's (value, lower index)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best, off);
    const int k = __shfl_down_sync(0xffffffffu, arg, off);
    keep_better(v, k, best, arg);
  }
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = arg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) keep_better(red_v[w], red_i[w], best, arg);
    vals[out + tile] = best;
    args[out + tile] = arg;
  }
}

unsigned long long magic(int d) { return (1ull << 32) / (unsigned long long)d + 1ull; }

// The least float t with fl(t - 1) >= th (fl(x - 1) is monotone in x);
// th itself where it is not finite.
float diff_threshold(float th) {
  if (!isfinite(th)) return th;
  auto passes = [th](float x) {
    volatile float r = x - 1.0f;
    return r >= th;
  };
  volatile float x = th + 1.0f;
  while (passes(nextafterf(x, -INFINITY))) x = nextafterf(x, -INFINITY);
  while (!passes(x)) x = nextafterf(x, INFINITY);
  return x;
}

template <int N>
cudaError_t launch(Table t, int cell_ctas, int tile_ctas, int max_bucket, uint8_t* flags,
                   float* vals, int* args, cudaStream_t stream) {
  const int nc = t.cell + 2 * Ring<N>::R;
  t.div_cell_win = magic(nc);
  cell_flags<N><<<t.need_ctas + cell_ctas, CELL_THREADS, sizeof(float) * nc * nc, stream>>>(
      t, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = max_bucket + 2 * HALO, m = max_bucket + 2;
  tile_maxima<N><<<tile_ctas, THREADS, sizeof(float) * (n * n + m * m), stream>>>(
      t, flags, vals, args);
  return cudaGetLastError();
}

const void* kernel_of(int which, int ring) {
  switch (ring) {
    case 16: return which ? (const void*)tile_maxima<16> : (const void*)cell_flags<16>;
    case 12: return which ? (const void*)tile_maxima<12> : (const void*)cell_flags<12>;
    case 8: return which ? (const void*)tile_maxima<8> : (const void*)cell_flags<8>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// Loads the six instances on the current device (under lazy module
// loading a first launch would load them, which a capture refuses).
int fast_detect_init() {
  const int rings[3] = {16, 12, 8};
  for (int r = 0; r < 3; ++r)
    for (int which = 0; which < 2; ++which) {
      cudaFuncAttributes attr;
      cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(which, rings[r]));
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// A read-only query: out = {registers a thread, local bytes a thread,
// threads a CTA} of launch `which` (0 the cells' flags, 1 the tiles) of
// the ring of n pixels.
int fast_detect_attributes(int which, int ring, int* out) {
  const void* k = kernel_of(which, ring);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = which ? THREADS : CELL_THREADS;
  return 0;
}

// imgs, masks: L pointers to (C, H_l, W_l) float32 and bool; dims: L x
// (H, W, bucket); flags: n_flags bytes of scratch, a byte a cell and a
// tile; vals, args: (C, L, T).
int fast_detect_launch(const void* const* imgs, const void* const* masks, const int* dims,
                       int L, int C, int T, int cell, int border, float th_hi, float th_lo,
                       int ring, int harris, float harris_k, float harris_scale2,
                       void* flags, long long n_flags, void* vals, void* args,
                       cudaStream_t stream) {
  if (L < 1 || L > MAX_LEVELS || C < 1 || cell < 1 || cell > MAX_EDGE)
    return (int)cudaErrorInvalidValue;
  Table t = {};
  t.L = L;
  t.C = C;
  t.T = T;
  t.cell = cell;
  t.border = border;
  t.harris = harris;
  t.th_hi = th_hi;
  t.th_lo = th_lo;
  t.harris_k = harris_k;
  t.harris_scale2 = harris_scale2;
  t.t_lo = diff_threshold(th_lo);
  t.t_flag = diff_threshold(fmaxf(fmaxf(th_lo, th_hi), nextafterf(0.0f, 1.0f)));
  t.div_cell = magic(cell);
  t.cell_iters = (cell * cell + CELL_THREADS - 1) / CELL_THREADS;
  int cell_ctas = 0, tile_ctas = 0, nflag = 0, max_bucket = 1;
  for (int l = 0; l < L; ++l) {
    Level& v = t.lv[l];
    v.img = (const float*)imgs[l];
    v.mask = (const uint8_t*)masks[l];
    v.H = dims[3 * l];
    v.W = dims[3 * l + 1];
    v.bucket = dims[3 * l + 2];
    // fastdiv stays exact while a dividend times its divisor is under 2^32
    if (v.H < 1 || v.W < 1 || v.H > 16384 || v.W > 16384 || v.bucket < 1 ||
        v.bucket > MAX_EDGE)
      return (int)cudaErrorInvalidValue;
    v.nbx = (v.W + v.bucket - 1) / v.bucket;
    v.tiles = v.nbx * ((v.H + v.bucket - 1) / v.bucket);
    v.cells_x = (v.W + cell - 1) / cell;
    v.cells = v.cells_x * ((v.H + cell - 1) / cell);
    v.cell_cta0 = cell_ctas;
    v.tile_cta0 = tile_ctas;
    v.flag0 = nflag;
    v.div_cells = magic(v.cells);
    v.div_cells_x = magic(v.cells_x);
    v.div_tiles = magic(v.tiles);
    v.div_nbx = magic(v.nbx);
    v.div_b = magic(v.bucket);
    v.div_b2 = magic(v.bucket + 2);
    v.div_bh = magic(v.bucket + 2 * HALO);
    if (v.tiles > T || (long long)C * v.tiles > 65536 || (long long)C * v.cells > 65536)
      return (int)cudaErrorInvalidValue;
    cell_ctas += C * v.cells;
    tile_ctas += C * v.tiles;
    nflag += C * v.cells;
    max_bucket = v.bucket > max_bucket ? v.bucket : max_bucket;
  }
  if ((long long)nflag + tile_ctas > n_flags) return (int)cudaErrorInvalidValue;
  t.need_ctas = (tile_ctas + CELL_THREADS / 32 - 1) / (CELL_THREADS / 32);
  t.tile_ctas = tile_ctas;
  t.need0 = nflag;
  switch (ring) {
    case 16: return (int)launch<16>(t, cell_ctas, tile_ctas, max_bucket, (uint8_t*)flags,
                                    (float*)vals, (int*)args, stream);
    case 12: return (int)launch<12>(t, cell_ctas, tile_ctas, max_bucket, (uint8_t*)flags,
                                    (float*)vals, (int*)args, stream);
    case 8: return (int)launch<8>(t, cell_ctas, tile_ctas, max_bucket, (uint8_t*)flags,
                                  (float*)vals, (int*)args, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
