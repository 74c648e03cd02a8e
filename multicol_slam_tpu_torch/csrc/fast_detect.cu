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
// Every step is a float subtract, product, sum, min, max or compare in the
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
// Design. Launch 1 (cell_flags): a CTA a (level, camera, cell) loads the
// cell and a ring's radius around it into shared memory with clamped
// coordinates, scores every pixel and ORs the th_hi test into one byte.
// Launch 2 (tile_maxima): a CTA a (level, camera, bucket) loads the tile
// and HALO = 5 pixels around it (the ring needs radius + 1 for the
// suppression's neighbours, Harris 3 + 2) with clamped coordinates, skips
// the whole tile when no pixel of it is inside both the mask and the
// border (the answer is then 0 at index 0), scores the tile and one pixel
// around it with the cells' flags into shared memory, suppresses, takes
// Harris at the survivors only, and reduces each thread's pixels in raster
// order, then the warps' and the CTA's by (value, lower index). A level
// table passed by value (MAX_LEVELS entries) spreads the CTAs of every
// level and camera over one grid a launch. No atomics: a graph's replay
// equals the eager call.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32): the three cameras'
// eight levels at 754x480 are 13.4 MB of float32 and 3.4 MB of masks, 5 us
// to read once; the ring's 16 differences, their negations, the arc
// minima and the maxima are some 210 operations a pixel, 3.4 M pixels,
// and Harris some 500 at each of 90,000 survivors: 13 us (chip_smoke.py
// phase 19 counts each input's). The cells and the buckets each score
// their pixels, so the ring runs about twice a pixel (the buckets outside
// the mask or the border run none), and its 158 minima and maxima a pixel
// run at half the float32 rate: the two launches take 183-220 us on an
// H100 (PERF.md section 6).
//
// Built with --fmad=false (kernels/extract.py): Harris's products and sums
// round as PyTorch's separate kernels do.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_LEVELS 16
#define THREADS 256
#define MAX_EDGE 64     // the largest bucket and cell edge
#define HALO 5          // Harris at a tile pixel reads 5 pixels out

namespace {

struct Level {
  const float* img;      // (C, H, W)
  const uint8_t* mask;   // (C, H, W) bool
  int H, W, bucket, nbx, nby, cells_x, cells_y;
  int cell_cta0;         // the level's first CTA in launch 1
  int tile_cta0;         // the level's first CTA in launch 2
  int flag0;             // the level's first flag: flag0 + c * cells + cell
};

struct Table {
  Level lv[MAX_LEVELS];
  int L, C, T, cell, border, harris;
  float th_hi, th_lo, harris_k, harris_scale2;
};

// The rings as (dy, dx) in OpenCV's pixel order (ops/fast.py CIRCLE,
// CIRCLE_12, CIRCLE_8).
__constant__ int RING16[16][2] = {
    {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3}, {1, 3}, {2, 2}, {3, 1},
    {3, 0}, {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};
__constant__ int RING12[12][2] = {
    {-2, 0}, {-2, 1}, {-1, 2}, {0, 2}, {1, 2}, {2, 1},
    {2, 0}, {2, -1}, {1, -2}, {0, -2}, {-1, -2}, {-2, -1}};
__constant__ int RING8[8][2] = {
    {-1, 0}, {-1, 1}, {0, 1}, {1, 1}, {1, 0}, {1, -1}, {0, -1}, {-1, -1}};

template <int N> struct Ring;
template <> struct Ring<16> {
  static constexpr int ARC = 9, R = 3;
  __device__ static int dy(int k) { return RING16[k][0]; }
  __device__ static int dx(int k) { return RING16[k][1]; }
};
template <> struct Ring<12> {
  static constexpr int ARC = 7, R = 2;
  __device__ static int dy(int k) { return RING12[k][0]; }
  __device__ static int dx(int k) { return RING12[k][1]; }
};
template <> struct Ring<8> {
  static constexpr int ARC = 5, R = 1;
  __device__ static int dy(int k) { return RING8[k][0]; }
  __device__ static int dx(int k) { return RING8[k][1]; }
};

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

// s_lo at the window position p: the segment-test score, 0 below th_lo.
template <int N>
__device__ __forceinline__ float fast_score(const float* win, int ws, int p, float th_lo) {
  const float c = win[p];
  float d[N], nd[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    d[k] = win[p + Ring<N>::dy(k) * ws + Ring<N>::dx(k)] - c;
    nd[k] = -d[k];
  }
  const float score =
      fmaxf(best_arc<N, Ring<N>::ARC>(d), best_arc<N, Ring<N>::ARC>(nd)) - 1.0f;
  return score >= th_lo ? score : 0.0f;
}

// Harris at the window position p of an image pixel (y, x): the plain
// version's dense response read at one pixel.
__device__ float harris_at(const float* win, int ws, int p, int y, int x, int H, int W,
                           float k, float scale2) {
  float a = 0.0f, b = 0.0f, c = 0.0f;
  for (int j = 0; j < 7; ++j) {
    const int yy = y + j - 3;
    float ha = 0.0f, hb = 0.0f, hc = 0.0f;
    if (yy >= 0 && yy < H) {
      for (int i = 0; i < 7; ++i) {
        const int xx = x + i - 3;
        float ta = 0.0f, tb = 0.0f, tc = 0.0f;
        if (xx >= 0 && xx < W) {
          const int q = p + (j - 3) * ws + (i - 3);
          const float gx = (win[q + 2] - win[q - 2]) * 0.5f;
          const float gy = (win[q - 2 * ws] - win[q + 2 * ws]) * -0.5f;
          ta = gx * gx;
          tb = gx * gy;
          tc = gy * gy;
        }
        ha = ha + ta;
        hb = hb + tb;
        hc = hc + tc;
      }
    }
    a = a + ha;
    b = b + hb;
    c = c + hc;
  }
  const float s = a + c;
  return (a * c - b * b - k * (s * s)) * scale2;
}

// The level of CTA `blk` (the last whose first CTA is <= blk), copied out
// of the table by constant indices, so the table stays in the parameter
// bank (a dynamic index into it would copy it to local memory).
__device__ __forceinline__ int level_of(const Table& t, int blk, bool tiles, Level& out) {
  int l = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < t.L && (tiles ? t.lv[i].tile_cta0 : t.lv[i].cell_cta0) <= blk) l = i;
#pragma unroll
  for (int i = 0; i < MAX_LEVELS; ++i)
    if (i == l) out = t.lv[i];
  return l;
}

// Loads rows [y0, y0 + n) and columns [x0, x0 + n) of camera c's level
// image with clamped coordinates (edge replication) into win (n x n).
__device__ __forceinline__ void load_window(float* win, const float* img, int H, int W,
                                            int y0, int x0, int n) {
  for (int i = threadIdx.x; i < n * n; i += THREADS) {
    const int y = min(max(y0 + i / n, 0), H - 1);
    const int x = min(max(x0 + i % n, 0), W - 1);
    win[i] = img[(size_t)y * W + x];
  }
}

// Launch 1: flags[cell] = any pixel of the cell with s_lo >= th_hi, s_lo > 0.
template <int N>
__global__ void __launch_bounds__(THREADS) cell_flags(Table t, uint8_t* __restrict__ flags) {
  extern __shared__ float win[];
  const int blk = blockIdx.x;
  Level L;
  level_of(t, blk, false, L);
  const int cells = L.cells_x * L.cells_y;
  const int rel = blk - L.cell_cta0;
  const int cam = rel / cells, cell = rel % cells;
  const int cy0 = (cell / L.cells_x) * t.cell, cx0 = (cell % L.cells_x) * t.cell;
  constexpr int R = Ring<N>::R;
  const int n = t.cell + 2 * R;
  load_window(win, L.img + (size_t)cam * L.H * L.W, L.H, L.W, cy0 - R, cx0 - R, n);
  __syncthreads();
  int hit = 0;
  for (int i = threadIdx.x; i < t.cell * t.cell; i += THREADS) {
    const int y = cy0 + i / t.cell, x = cx0 + i % t.cell;
    if (y < L.H && x < L.W) {
      const float s = fast_score<N>(win, n, (i / t.cell + R) * n + i % t.cell + R, t.th_lo);
      hit |= (s >= t.th_hi) && (s > 0.0f);
    }
  }
  hit = __syncthreads_or(hit);
  if (threadIdx.x == 0) flags[L.flag0 + cam * cells + cell] = (uint8_t)(hit != 0);
}

// (value, index) ordered as "a first maximum": the larger value, or the
// lower index of equal values.
__device__ __forceinline__ bool better(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Launch 2: each bucket's maximum and its first index inside the tile.
template <int N>
__global__ void __launch_bounds__(THREADS) tile_maxima(Table t, const uint8_t* __restrict__ flags,
                                                       float* __restrict__ vals,
                                                       int* __restrict__ args) {
  extern __shared__ float smem[];
  __shared__ float red_v[THREADS / 32];
  __shared__ int red_i[THREADS / 32];
  const int blk = blockIdx.x;
  Level L;
  const int l = level_of(t, blk, true, L);
  const int tiles = L.nbx * L.nby;
  const int rel = blk - L.tile_cta0;
  const int cam = rel / tiles, tile = rel % tiles;
  const int b = L.bucket;
  const int ty0 = (tile / L.nbx) * b, tx0 = (tile % L.nbx) * b;
  const size_t out = ((size_t)cam * t.L + l) * t.T;
  const int H = L.H, W = L.W;
  const uint8_t* mask = L.mask + (size_t)cam * H * W;

  // padding columns past the level's tiles, written by its last tile
  if (tile == tiles - 1)
    for (int j = tiles + threadIdx.x; j < t.T; j += THREADS) {
      vals[out + j] = -INFINITY;
      args[out + j] = 0;
    }

  // is any tile pixel inside the mask and the border?
  int need = 0;
  for (int i = threadIdx.x; i < b * b; i += THREADS) {
    const int y = ty0 + i / b, x = tx0 + i % b;
    need |= y >= t.border && y < H - t.border && x >= t.border && x < W - t.border &&
            mask[(size_t)y * W + x];
  }
  if (!__syncthreads_or(need)) {
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
  load_window(win, L.img + (size_t)cam * H * W, H, W, ty0 - HALO, tx0 - HALO, n);
  __syncthreads();
  const int cells = L.cells_x * L.cells_y;
  const uint8_t* cflag = flags + L.flag0 + cam * cells;
  for (int i = threadIdx.x; i < m * m; i += THREADS) {
    const int y = ty0 - 1 + i / m, x = tx0 - 1 + i % m;
    float v = -INFINITY;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float s = fast_score<N>(win, n, (i / m + HALO - 1) * n + i % m + HALO - 1,
                                    t.th_lo);
      const bool hi = cflag[(y / t.cell) * L.cells_x + x / t.cell] != 0;
      v = hi ? (s >= t.th_hi ? s : 0.0f) : s;
    }
    comb[i] = v;
  }
  __syncthreads();

  float best = -INFINITY;
  int arg = 0x7fffffff;
  for (int i = threadIdx.x; i < b * b; i += THREADS) {
    const int dy = i / b, dx = i % b;
    const int y = ty0 + dy, x = tx0 + dx;
    float s = 0.0f;
    if (y >= t.border && y < H - t.border && x >= t.border && x < W - t.border &&
        mask[(size_t)y * W + x]) {
      const int q = (dy + 1) * m + dx + 1;
      const float v = comb[q];
      const float e = fmaxf(fmaxf(comb[q - m - 1], comb[q - m]), fmaxf(comb[q - m + 1],
                                                                       comb[q - 1]));
      const float f = fmaxf(fmaxf(comb[q + 1], comb[q + m - 1]), fmaxf(comb[q + m],
                                                                       comb[q + m + 1]));
      float nms = (v >= fmaxf(e, f) && v > e) ? v : 0.0f;
      if (t.harris)
        nms = nms > 0.0f ? harris_at(win, n, (dy + HALO) * n + dx + HALO, y, x, H, W,
                                     t.harris_k, t.harris_scale2) + 1e-6f
                         : 0.0f;
      s = nms;
    }
    if (better(s, i, best, arg)) {
      best = s;
      arg = i;
    }
  }
  // the warp's, then the CTA's (value, lower index)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best, off);
    const int j = __shfl_down_sync(0xffffffffu, arg, off);
    if (better(v, j, best, arg)) {
      best = v;
      arg = j;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = arg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w)
      if (better(red_v[w], red_i[w], best, arg)) {
        best = red_v[w];
        arg = red_i[w];
      }
    vals[out + tile] = best;
    args[out + tile] = arg;
  }
}

template <int N>
cudaError_t launch(const Table& t, int cell_ctas, int tile_ctas, int max_bucket,
                   uint8_t* flags, float* vals, int* args, cudaStream_t stream) {
  const size_t flag_smem = sizeof(float) * (t.cell + 2 * Ring<N>::R) * (t.cell + 2 * Ring<N>::R);
  cell_flags<N><<<cell_ctas, THREADS, flag_smem, stream>>>(t, flags);
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
  out[2] = THREADS;
  return 0;
}

// imgs, masks: L pointers to (C, H_l, W_l) float32 and bool; dims: L x
// (H, W, bucket); flags: n_flags bytes of scratch; vals, args: (C, L, T).
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
  int cell_ctas = 0, tile_ctas = 0, nflag = 0, max_bucket = 1;
  for (int l = 0; l < L; ++l) {
    Level& v = t.lv[l];
    v.img = (const float*)imgs[l];
    v.mask = (const uint8_t*)masks[l];
    v.H = dims[3 * l];
    v.W = dims[3 * l + 1];
    v.bucket = dims[3 * l + 2];
    if (v.H < 1 || v.W < 1 || v.bucket < 1 || v.bucket > MAX_EDGE)
      return (int)cudaErrorInvalidValue;
    v.nbx = (v.W + v.bucket - 1) / v.bucket;
    v.nby = (v.H + v.bucket - 1) / v.bucket;
    v.cells_x = (v.W + cell - 1) / cell;
    v.cells_y = (v.H + cell - 1) / cell;
    v.cell_cta0 = cell_ctas;
    v.tile_cta0 = tile_ctas;
    v.flag0 = nflag;
    if (v.nbx * v.nby > T) return (int)cudaErrorInvalidValue;
    cell_ctas += C * v.cells_x * v.cells_y;
    tile_ctas += C * v.nbx * v.nby;
    nflag += C * v.cells_x * v.cells_y;
    max_bucket = v.bucket > max_bucket ? v.bucket : max_bucket;
  }
  if (nflag > n_flags) return (int)cudaErrorInvalidValue;
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
