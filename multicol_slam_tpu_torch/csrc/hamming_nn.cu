// Gated Hamming nearest neighbour: per query row, the argmin, best and
// second-best Hamming distance over the database rows its gate allows.
//
// Replaces the TPU kernels of multicol_slam_tpu/ops/pallas/hamming_nn.py:
// fused_hamming_nn (:124, body _kernel) and fused_hamming_nn_masked (:181,
// body _kernel_masked). The TPU version streams +-1 f32 tiles through the
// matrix unit and merges a running (best, second, idx) across a sequential
// grid; Hopper has a population count per thread, so here a lane XORs
// packed words and counts bits with __popc, and a block walks all
// database rows itself (blocks run in no order, so nothing carries
// between them).
//
// Contract (identical to the plain versions in kernels/hamming_nn.py):
//   - ties go to the lowest column index;
//   - second = min over every allowed column except the argmin column,
//     so a duplicate of the best value gives second == best;
//   - a fully gated row gives idx -1 and best = second = 0x7FFFFFFF;
//   - masked: d = (popc((a^b)&m_a) + popc((a^b)&m_b)) / 2, truncated
//     (cORBmatcher.cpp:2455-2476).
//
// Two entries share one core:
//   A, hamming_nn_radius_launch: the gate is built inside the kernel from
//     per-row fields. Query row n of camera c is allowed database row m iff
//     q_ok[n] && db_ok[m] && q_lo[n] <= db_lvl[m] <= q_hi[n] &&
//     dx*dx + dy*dy <= q_r2[n], dx = db_x[m] - q_u[n], dy likewise, each
//     operation rounded on its own (no FMA), in the order of the matchers'
//     torch expression, so a point exactly on the radius decides as there.
//   B, hamming_nn_launch: a dense (C, N, M) gate of bytes, for the
//     epipolar-gated triangulation searches.
// Layout: q (Cq, N, W) int32 with Cq = C or 1 (a camera stride of 0 shares
// the queries, as the map points of the local-map and fuse searches are),
// db (C, M, W) int32, optional masks of the same shapes; outputs (C, N)
// int32 x 3.
//
// Bound on an H100 (3.35 TB/s; 16 popcounts/clk/SM): the gates are
// 0.02-0.6% set, so the popcounts a call needs are about 1e5, well under a
// microsecond; bytes set the bound. Entry A moves descriptors, per-row
// fields and outputs only: about 0.26 MB at (3, 800) x (3, 800), 0.08 us,
// below one launch. Entry B also reads the dense gate: 1.9 MB at
// (3, 800)^2 (0.63 us), 9.6 MB at the triangulation's (15, 800)^2
// (3.1 us).
//
// Design, against the first version (one thread per query row, 64-row
// blocks, gate bytes loaded one at a time):
//   - occupancy: a warp serves one query row and a block 8 rows, so the
//     tracking shapes launch 300-400 blocks, not 39-48;
//   - gate bytes: entry A never reads a gate; a lane tests its column's
//     fields (level window first, then the radius) and runs XOR and
//     __popc only on columns that pass. Entry B reads its gate row as
//     16-byte vectors, one per lane, and visits only the nonzero bytes;
//   - the block stages a 512-row tile of database descriptors (two uint4
//     per 32-byte descriptor), masks and gate fields in shared memory;
//   - lanes take columns in increasing order and keep a lane-local
//     (best, second, idx); lanes merge with __shfl_xor_sync, (d, idx)
//     compared lexicographically, the merged second being
//     min(s_a, s_b, the losing best).
//
// Tensor cores are not used. At these densities a dense +-1 int8 product
// (wgmma) or a b1 mma.sync .and.popc product computes 170-5000x the
// distances needed. A later dense caller (loop closing's fuse at >= 2048
// candidates) may use popc(a^b) = popc(a) + popc(b) - 2 popc(a&b): the
// cross term is a b1 AND-popc product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;              // query rows per block, one warp each
constexpr int THREADS = WARPS * 32;
constexpr int DT = 512;               // database rows per shared-memory tile:
                                      // 32 lanes x 16 gate bytes in entry B
constexpr int32_t INVALID = 0x7FFFFFFF;
constexpr int32_t NO_IDX = 0x7FFFFFFF;  // an empty lane's index while merging
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Params {
  const int32_t* q;
  const int32_t* q_mask;
  long long q_cstride;          // words between cameras of q; 0 = shared
  const int32_t* db;
  const int32_t* db_mask;
  const uint8_t* gate;          // entry B: (C, N, gate_stride) bytes
  long long gate_stride;        // bytes between gate rows, a multiple of 16
  const float* q_uv;            // entry A: (C, N, 2)
  const float* q_r2;            // (C, N)
  const int32_t* q_lo;          // (C, N)
  const int32_t* q_hi;          // (C, N)
  const uint8_t* q_ok;          // (C, N)
  const float* db_xy;           // (C, M, 2)
  const int32_t* db_lvl;        // (C, M)
  const uint8_t* db_ok;         // (C, M)
  int32_t* idx;
  int32_t* best;
  int32_t* second;
  int N, M;
};

// 4-bit mask of the nonzero bytes of v, byte 0 in bit 0
__device__ __forceinline__ unsigned nonzero_bytes(uint32_t v) {
  const uint32_t t = __vcmpne4(v, 0u);  // 0xff in each nonzero byte
  return ((t >> 7) & 1u) | ((t >> 14) & 2u) | ((t >> 21) & 4u) | ((t >> 28) & 8u);
}

template <int W, bool MASKED>
__device__ __forceinline__ int32_t distance(const uint32_t (&qw)[W],
                                            const uint32_t (&qm)[MASKED ? W : 1],
                                            const uint4* d, const uint4* dm) {
  int32_t s = 0, sm = 0;
#pragma unroll
  for (int v = 0; v < W / 4; ++v) {
    const uint4 b = d[v];
    const uint32_t x0 = qw[4 * v] ^ b.x, x1 = qw[4 * v + 1] ^ b.y,
                   x2 = qw[4 * v + 2] ^ b.z, x3 = qw[4 * v + 3] ^ b.w;
    if constexpr (MASKED) {
      const uint4 m = dm[v];
      s += __popc(x0 & qm[4 * v]) + __popc(x1 & qm[4 * v + 1]) +
           __popc(x2 & qm[4 * v + 2]) + __popc(x3 & qm[4 * v + 3]);
      sm += __popc(x0 & m.x) + __popc(x1 & m.y) + __popc(x2 & m.z) + __popc(x3 & m.w);
    } else {
      s += __popc(x0) + __popc(x1) + __popc(x2) + __popc(x3);
    }
  }
  return MASKED ? (s + sm) >> 1 : s;
}

// fold column j at distance d into a lane's (best, second, idx). A lane
// visits its columns in increasing order, so a strict d < best keeps the
// lowest column among its own ties.
__device__ __forceinline__ void keep(int32_t d, int j, int32_t& best,
                                     int32_t& second, int32_t& idx) {
  if (d < best) {
    second = best;
    best = d;
    idx = j;
  } else if (d < second) {
    second = d;
  }
}

template <int W, bool MASKED, bool RADIUS>
constexpr size_t smem_bytes() {
  return (size_t)DT * (W / 4) * sizeof(uint4) * (MASKED ? 2 : 1) +
         (RADIUS ? (size_t)DT * (sizeof(float2) + sizeof(int32_t) + 1) : 0);
}

template <int W, bool MASKED, bool RADIUS>
__global__ void __launch_bounds__(THREADS) hamming_nn_kernel(const Params p) {
  constexpr int V = W / 4;  // uint4 per descriptor
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* desc_s = reinterpret_cast<uint4*>(smem);
  uint4* mask_s = desc_s + DT * V;  // under MASKED
  float2* xy_s = reinterpret_cast<float2*>(desc_s + DT * V * (MASKED ? 2 : 1));
  int32_t* lvl_s = reinterpret_cast<int32_t*>(xy_s + DT);
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(lvl_s + DT);

  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int N = p.N, M = p.M;
  const bool in_range = n < N;
  const size_t row = (size_t)c * N + (in_range ? n : 0);

  // the query row, the same in every lane
  uint32_t qw[W];
  uint32_t qm[MASKED ? W : 1];
  {
    const size_t off = (size_t)c * p.q_cstride + (size_t)(in_range ? n : 0) * W;
    const uint4* src = reinterpret_cast<const uint4*>(p.q + off);
    const uint4* msrc = reinterpret_cast<const uint4*>(MASKED ? p.q_mask + off : p.q + off);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const uint4 t = src[v];
      qw[4 * v] = t.x; qw[4 * v + 1] = t.y; qw[4 * v + 2] = t.z; qw[4 * v + 3] = t.w;
      if constexpr (MASKED) {
        const uint4 m = msrc[v];
        qm[4 * v] = m.x; qm[4 * v + 1] = m.y; qm[4 * v + 2] = m.z; qm[4 * v + 3] = m.w;
      }
    }
  }
  bool active = in_range;
  float qu = 0.f, qv = 0.f, r2 = 0.f;
  int32_t lo = 0, hi = -1;
  if constexpr (RADIUS) {
    active = active && p.q_ok[row] != 0;
    qu = p.q_uv[2 * row];
    qv = p.q_uv[2 * row + 1];
    r2 = p.q_r2[row];
    lo = p.q_lo[row];
    hi = p.q_hi[row];
  }

  int32_t best = INVALID, second = INVALID, idx = NO_IDX;
  const int32_t* db_c = p.db + (size_t)c * M * W;
  const int32_t* dbm_c = MASKED ? p.db_mask + (size_t)c * M * W : nullptr;

  for (int j0 = 0; j0 < M; j0 += DT) {
    const int cols = min(DT, M - j0);
    __syncthreads();  // the previous tile is fully consumed
    {
      const uint4* src = reinterpret_cast<const uint4*>(db_c + (size_t)j0 * W);
      for (int e = threadIdx.x; e < cols * V; e += THREADS) desc_s[e] = src[e];
      if constexpr (MASKED) {
        const uint4* msrc = reinterpret_cast<const uint4*>(dbm_c + (size_t)j0 * W);
        for (int e = threadIdx.x; e < cols * V; e += THREADS) mask_s[e] = msrc[e];
      }
      if constexpr (RADIUS) {
        const size_t base = (size_t)c * M + j0;
        for (int r = threadIdx.x; r < cols; r += THREADS) {
          xy_s[r] = make_float2(p.db_xy[2 * (base + r)], p.db_xy[2 * (base + r) + 1]);
          lvl_s[r] = p.db_lvl[base + r];
          ok_s[r] = p.db_ok[base + r];
        }
      }
    }
    __syncthreads();
    if (!active) continue;

    if constexpr (RADIUS) {
      for (int jj = lane; jj < cols; jj += 32) {
        if (!ok_s[jj]) continue;
        const int32_t lv = lvl_s[jj];
        if (lv < lo || lv > hi) continue;
        const float2 xy = xy_s[jj];
        const float dx = __fsub_rn(xy.x, qu), dy = __fsub_rn(xy.y, qv);
        if (!(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= r2)) continue;
        keep(distance<W, MASKED>(qw, qm, desc_s + jj * V, mask_s + jj * V), j0 + jj,
             best, second, idx);
      }
    } else {
      const int jc = lane * 16;  // the lane's 16 columns of the tile
      if (jc < cols) {
        const uint4 g = __ldg(reinterpret_cast<const uint4*>(
            p.gate + row * p.gate_stride + j0 + jc));
        unsigned bits = nonzero_bytes(g.x) | (nonzero_bytes(g.y) << 4) |
                        (nonzero_bytes(g.z) << 8) | (nonzero_bytes(g.w) << 12);
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1;
          if (jc + b >= cols) break;
          keep(distance<W, MASKED>(qw, qm, desc_s + (jc + b) * V, mask_s + (jc + b) * V),
               j0 + jc + b, best, second, idx);
        }
      }
    }
  }

  // merge the lanes: (d, idx) lexicographic, second = min(s_a, s_b, the
  // losing best)
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const int32_t ob = __shfl_xor_sync(FULL, best, off);
    const int32_t oi = __shfl_xor_sync(FULL, idx, off);
    const int32_t os = __shfl_xor_sync(FULL, second, off);
    const bool other = ob < best || (ob == best && oi < idx);
    second = min(min(second, os), other ? best : ob);
    if (other) {
      best = ob;
      idx = oi;
    }
  }
  if (in_range && lane == 0) {
    p.idx[row] = best == INVALID ? -1 : idx;
    p.best[row] = best;
    p.second[row] = second;
  }
}

template <int W, bool MASKED, bool RADIUS>
cudaError_t launch(const Params& p, int C, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<W, MASKED, RADIUS>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hamming_nn_kernel<W, MASKED, RADIUS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.N + WARPS - 1) / WARPS, C);
  hamming_nn_kernel<W, MASKED, RADIUS><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool RADIUS>
int launch_any(const Params& p, int C, int W, int masked, void* stream) {
  if (C <= 0 || p.N <= 0) return (int)cudaSuccess;
  if (C > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = masked != 0;
  switch (W) {
    case 4:
      return (int)(m ? launch<4, true, RADIUS>(p, C, st) : launch<4, false, RADIUS>(p, C, st));
    case 8:
      return (int)(m ? launch<8, true, RADIUS>(p, C, st) : launch<8, false, RADIUS>(p, C, st));
    case 16:
      return (int)(m ? launch<16, true, RADIUS>(p, C, st) : launch<16, false, RADIUS>(p, C, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry points for ctypes. Pointers are device pointers, 16-byte
// aligned for q, db and the masks; `stream` is a cudaStream_t. Each returns
// the cudaError_t of the launch (0 = success), or cudaErrorInvalidValue for
// a word count the kernel is not built for.

// Entry B: the dense gate, rows gate_stride bytes apart (a multiple of 16).
extern "C" int hamming_nn_launch(const void* q, const void* db, const void* gate,
                                 long long gate_stride, const void* q_mask,
                                 const void* db_mask, void* idx, void* best,
                                 void* second, int C, int N, int M, int W,
                                 int masked, void* stream) {
  Params p = {};
  p.q = static_cast<const int32_t*>(q);
  p.q_mask = static_cast<const int32_t*>(q_mask);
  p.q_cstride = (long long)N * W;
  p.db = static_cast<const int32_t*>(db);
  p.db_mask = static_cast<const int32_t*>(db_mask);
  p.gate = static_cast<const uint8_t*>(gate);
  p.gate_stride = gate_stride;
  p.idx = static_cast<int32_t*>(idx);
  p.best = static_cast<int32_t*>(best);
  p.second = static_cast<int32_t*>(second);
  p.N = N;
  p.M = M;
  return launch_any<false>(p, C, W, masked, stream);
}

// Entry A: the gate built from per-row fields; q_cstride is 0 when one set
// of queries serves every camera, N * W otherwise.
extern "C" int hamming_nn_radius_launch(
    const void* q, long long q_cstride, const void* db, const void* q_uv,
    const void* q_r2, const void* q_lo, const void* q_hi, const void* q_ok,
    const void* db_xy, const void* db_lvl, const void* db_ok, const void* q_mask,
    const void* db_mask, void* idx, void* best, void* second, int C, int N,
    int M, int W, int masked, void* stream) {
  Params p = {};
  p.q = static_cast<const int32_t*>(q);
  p.q_mask = static_cast<const int32_t*>(q_mask);
  p.q_cstride = q_cstride;
  p.db = static_cast<const int32_t*>(db);
  p.db_mask = static_cast<const int32_t*>(db_mask);
  p.q_uv = static_cast<const float*>(q_uv);
  p.q_r2 = static_cast<const float*>(q_r2);
  p.q_lo = static_cast<const int32_t*>(q_lo);
  p.q_hi = static_cast<const int32_t*>(q_hi);
  p.q_ok = static_cast<const uint8_t*>(q_ok);
  p.db_xy = static_cast<const float*>(db_xy);
  p.db_lvl = static_cast<const int32_t*>(db_lvl);
  p.db_ok = static_cast<const uint8_t*>(db_ok);
  p.idx = static_cast<int32_t*>(idx);
  p.best = static_cast<int32_t*>(best);
  p.second = static_cast<int32_t*>(second);
  p.N = N;
  p.M = M;
  return launch_any<true>(p, C, W, masked, stream);
}
