// Gated Hamming nearest neighbour: per query row, the argmin, best and
// second-best Hamming distance over the database rows its gate allows.
//
// Replaces the TPU kernels fused_hamming_nn / fused_hamming_nn_masked of
// multicol_slam_tpu/ops/pallas/hamming_nn.py (bodies _kernel and
// _kernel_masked). The TPU version streams +-1 f32 tiles through the
// matrix unit and merges a running (best, second, idx) across a
// sequential grid; Hopper has a population count per thread, so here
// each thread XORs packed words and counts bits with __popc, and a block
// walks all database rows itself (blocks run in no order, so nothing
// carries between them).
//
// Contract (identical to the plain version in kernels/hamming_nn.py):
//   - ties go to the lowest column index;
//   - second = min over every allowed column except the argmin column,
//     so a duplicate of the best value gives second == best;
//   - a fully gated row gives idx -1 and best = second = 0x7FFFFFFF.
//   - masked: d = (popc((a^b)&m_a) + popc((a^b)&m_b)) / 2, truncated
//     (cORBmatcher.cpp:2455-2476).
//
// Layout: one launch serves a batch of C cameras. q (C, N, W) int32,
// db (C, M, W) int32, gate (C, N, M) bytes (bool or uint8), optional
// q_mask (C, N, W) and db_mask (C, M, W); outputs (C, N) int32 x 3.
//
// Bound on an H100: at the tracking slice's shapes (3 x 2048 x 400 and
// 3 x 400 x 400) the kernel reads about 2.5 MB of gate bytes against
// about 20 M popcounts of 32-bit words, so the gate's bytes bound it,
// not the arithmetic. This first version keeps the dense gate: a block
// stages a tile of gate bytes and database rows in shared memory with
// coalesced loads, and each thread keeps its query's words in
// registers. The plan for a later version is to build the gate inside
// the kernel from the predicted xy, level window and radius, so the
// (C, N, M) gate never exists in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;           // query rows per block (one per thread)
constexpr int DT = 64;           // database rows per shared-memory tile
constexpr int GSTRIDE = DT + 4;  // gate tile row stride in bytes: 17 words,
                                 // so a warp's column reads hit 32 banks
constexpr int32_t INVALID = 0x7FFFFFFF;

template <int W, bool MASKED>
__global__ void __launch_bounds__(QT)
hamming_nn_kernel(const int32_t* __restrict__ q,
                  const int32_t* __restrict__ db,
                  const uint8_t* __restrict__ gate,
                  const int32_t* __restrict__ q_mask,
                  const int32_t* __restrict__ db_mask,
                  int32_t* __restrict__ out_idx,
                  int32_t* __restrict__ out_best,
                  int32_t* __restrict__ out_second,
                  int N, int M) {
  __shared__ uint32_t db_s[DT][W];
  __shared__ uint32_t dbm_s[MASKED ? DT : 1][MASKED ? W : 1];
  __shared__ uint8_t gate_s[QT][GSTRIDE];

  const int c = blockIdx.y;
  const int row0 = blockIdx.x * QT;
  const int t = threadIdx.x;
  const int n = row0 + t;
  const bool live = n < N;

  const size_t qoff = ((size_t)c * N + (live ? n : 0)) * W;
  uint32_t qw[W];
  uint32_t qm[MASKED ? W : 1];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    qw[w] = live ? (uint32_t)q[qoff + w] : 0u;
    if constexpr (MASKED) qm[w] = live ? (uint32_t)q_mask[qoff + w] : 0u;
  }

  const int32_t* db_c = db + (size_t)c * M * W;
  const int32_t* dbm_c = MASKED ? db_mask + (size_t)c * M * W : nullptr;
  const uint8_t* gate_c = gate + (size_t)c * N * M;

  int32_t best = INVALID, second = INVALID, idx = -1;

  for (int j0 = 0; j0 < M; j0 += DT) {
    const int cols = min(DT, M - j0);
    __syncthreads();  // the previous tile is fully consumed
    // database tile: DT rows of W words, neighbouring threads on
    // neighbouring words
    for (int e = t; e < DT * W; e += QT) {
      const int r = e / W, w = e % W;
      uint32_t v = 0u, vm = 0u;
      if (r < cols) {
        v = (uint32_t)db_c[(size_t)(j0 + r) * W + w];
        if constexpr (MASKED) vm = (uint32_t)dbm_c[(size_t)(j0 + r) * W + w];
      }
      db_s[r][w] = v;
      if constexpr (MASKED) dbm_s[r][w] = vm;
    }
    // gate tile: QT query rows x DT columns, a row's bytes contiguous
    for (int e = t; e < QT * DT; e += QT) {
      const int r = e / DT, col = e % DT;
      uint8_t g = 0;
      if (row0 + r < N && col < cols)
        g = gate_c[(size_t)(row0 + r) * M + j0 + col];
      gate_s[r][col] = g;
    }
    __syncthreads();

    if (live) {
      for (int jj = 0; jj < cols; ++jj) {
        if (!gate_s[t][jj]) continue;
        int32_t d;
        if constexpr (MASKED) {
          int da = 0, dm = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const uint32_t x = qw[w] ^ db_s[jj][w];
            da += __popc(x & qm[w]);
            dm += __popc(x & dbm_s[jj][w]);
          }
          d = (da + dm) >> 1;
        } else {
          int s = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) s += __popc(qw[w] ^ db_s[jj][w]);
          d = s;
        }
        if (d < best) {
          second = best;
          best = d;
          idx = j0 + jj;
        } else if (d < second) {
          second = d;
        }
      }
    }
  }

  if (live) {
    const size_t o = (size_t)c * N + n;
    out_idx[o] = idx;
    out_best[o] = best;
    out_second[o] = second;
  }
}

template <int W>
cudaError_t launch_w(const int32_t* q, const int32_t* db, const uint8_t* gate,
                     const int32_t* q_mask, const int32_t* db_mask,
                     int32_t* idx, int32_t* best, int32_t* second,
                     int C, int N, int M, bool masked, cudaStream_t stream) {
  const dim3 grid((N + QT - 1) / QT, C);
  const dim3 block(QT);
  if (masked)
    hamming_nn_kernel<W, true><<<grid, block, 0, stream>>>(
        q, db, gate, q_mask, db_mask, idx, best, second, N, M);
  else
    hamming_nn_kernel<W, false><<<grid, block, 0, stream>>>(
        q, db, gate, q_mask, db_mask, idx, best, second, N, M);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Pointers are device pointers; `stream`
// is a cudaStream_t. Returns the cudaError_t of the launch (0 = success),
// or cudaErrorInvalidValue for a word count the kernel is not built for.
extern "C" int hamming_nn_launch(const void* q, const void* db,
                                 const void* gate, const void* q_mask,
                                 const void* db_mask, void* idx, void* best,
                                 void* second, int C, int N, int M, int W,
                                 int masked, void* stream) {
  if (C <= 0 || N <= 0) return (int)cudaSuccess;
  const int32_t* q_ = static_cast<const int32_t*>(q);
  const int32_t* db_ = static_cast<const int32_t*>(db);
  const uint8_t* g_ = static_cast<const uint8_t*>(gate);
  const int32_t* qm_ = static_cast<const int32_t*>(q_mask);
  const int32_t* dbm_ = static_cast<const int32_t*>(db_mask);
  int32_t* i_ = static_cast<int32_t*>(idx);
  int32_t* b_ = static_cast<int32_t*>(best);
  int32_t* s_ = static_cast<int32_t*>(second);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool m = masked != 0;
  switch (W) {
    case 4:
      return (int)launch_w<4>(q_, db_, g_, qm_, dbm_, i_, b_, s_, C, N, M, m, st);
    case 8:
      return (int)launch_w<8>(q_, db_, g_, qm_, dbm_, i_, b_, s_, C, N, M, m, st);
    case 16:
      return (int)launch_w<16>(q_, db_, g_, qm_, dbm_, i_, b_, s_, C, N, M, m, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
