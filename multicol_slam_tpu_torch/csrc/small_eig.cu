// Small dense eigensolvers for the RANSAC solvers' graphs: a batched
// symmetric eigen-decomposition (n <= 12) and a batched 3x3 SVD.
//
// Replaces no TPU kernel: the JAX package leaves eigh and svd to XLA
// inside its jitted RANSAC (multicol_slam_tpu/ops/ransac.py:56,59,135,310
// and ops/sim3.py's Horn alignment). On the card the port replays the
// RANSAC units as CUDA graphs, and torch.linalg.eigh / svd read cuSOLVER's
// info flag on the host after every call, which a capture refuses. These
// kernels read nothing back: a launch is one kernel on the caller's
// stream, with no allocation.
//
// sym_eig: Jacobi on the lower triangle (as torch.linalg.eigh's default
// UPLO='L' reads it) in parallel order. n is padded to an even m with a
// dummy index; a sweep is m - 1 rounds of the round-robin tournament
// (index m - 1 fixed, the others turning), each round m / 2 disjoint
// (p, q) pairs, so every pair p < q comes once a sweep. A pair is skipped
// (its a_pq set to 0) once |a_pq| <= eps sqrt|a_pp a_qq| or a_pq == 0; a
// sweep that rotates nothing ends the loop, at most Traits<T>::sweeps
// sweeps, so a non-finite input ends too. Eigenvalues ascending (by rank:
// each value's count of smaller values, ties and NaNs by index),
// eigenvectors as columns (V[b, i, j] = component i of vector j), as eigh
// returns them.
// svd3: one-sided (Hestenes) Jacobi on the columns of a 3x3 matrix with V
// accumulated; singular values are the column norms, sorted descending by
// three compare-and-swaps that move the columns of A and V with them; U's
// columns are the normalized columns, and a column whose singular value is
// at most 8 eps of the largest (a rank-deficient E or a zeroed DLT block)
// is completed to an orthonormal U (u2 from the axis least aligned with
// u1, u3 = u1 x u2). Returns U, S and Vh = V^T, as torch.linalg.svd does.
// Singular and eigen vectors are defined up to sign, so a column may
// differ in sign from cuSOLVER's or LAPACK's.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32, 34 TFLOP/s float64
// outside the tensor cores): a rotation costs about 18 n flops, a sweep
// n (n - 1) / 2 rotations. At GP3P's 1024 x 4x4 in float32 (6 sweeps)
// about 0.8 MFLOP against 0.15 MB: 0.05 us by bytes, far below one launch;
// the 8-point refit's single 9x9 and a 3x3 SVD are smaller still. What
// holds these kernels back is latency: a rotation is a chain of dependent
// divides and square roots, and a matrix takes a few dozen of them in a
// row. The design shortens the chain and keeps every matrix out of local
// memory:
// - sym_eig from n = 5: a warp a matrix, lane i holding row i of A and
//   column i of V in registers. A round is unrolled, so every column
//   index and its partner are compile-time constants: the lower lane of
//   each pair computes (c, s) from its row and its partner's diagonal
//   (__shfl_sync), hands it to the higher lane, rows mix with the
//   partner's row, columns with the coefficients broadcast from their
//   lanes, V's columns with the partner's column. Row i's own diagonal and
//   partner entries are picked by selects over the unrolled columns.
// - sym_eig to n = 4 (Horn's 4x4 batches) and svd3: one thread a matrix,
//   every index a compile-time constant, so the matrix stays in
//   registers; sym_eig's two rotations of a round are independent chains.
// - every rotation is computed whether it is taken or not, and (1, 0)
//   selected where it is skipped, so the skip test runs beside it; in
//   float32 the quotients and square roots of (c, s), of the skip tests
//   and of svd3's column norms are the hardware's approximations (c and
//   the inverse norms refined by one Newton step); float64 stays IEEE.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;
constexpr int MAX_N = 12;
constexpr int THREAD_MAX_N = 4;      // sym_eig on one thread a matrix up to here

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr float eps = 1.1920929e-07f;
  static constexpr int sweeps = 12;
};
template <> struct Traits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr int sweeps = 16;
};

// sqrt(x) for the skip tests, x >= 0: in float32 the hardware's
// approximation, whose NaN at x = 0 skips no nonzero entry, as sqrt's 0
// does not
__device__ __forceinline__ float root(float x) { return x * rsqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// 1 / sqrt(x), x > 0: in float32 the hardware's approximation refined by
// one Newton step
__device__ __forceinline__ float inv_root(float x) {
  const float r = rsqrtf(x);
  return r * fmaf(-0.5f * x * r, r, 1.5f);
}
__device__ __forceinline__ double inv_root(double x) { return 1.0 / sqrt(x); }

// c, s of the rotation that zeroes the (p, q) entry of a 2x2 symmetric
// block [[app, apq], [apq, aqq]] (Golub and Van Loan's sym.schur2):
// theta = (aqq - app) / 2 apq, t = sign(theta) / (|theta| + sqrt(theta^2
// + 1)), c = 1 / sqrt(1 + t^2), s = t c.
__device__ __forceinline__ void schur2(float app, float aqq, float apq, float& c, float& s) {
  const float theta = __fdividef(aqq - app, 2.0f * apq);
  const float at = fabsf(theta), d = fmaf(theta, theta, 1.0f);
  const float hyp = at > 1e18f ? at : d * rsqrtf(d);      // sqrt(theta^2 + 1)
  const float t = copysignf(__fdividef(1.0f, at + hyp), theta);
  c = inv_root(fmaf(t, t, 1.0f));
  s = t * c;
}
__device__ __forceinline__ void schur2(double app, double aqq, double apq, double& c,
                                       double& s) {
  const double theta = (aqq - app) / (2.0 * apq);
  const double t = copysign(1.0, theta) / (fabs(theta) + sqrt(theta * theta + 1.0));
  c = 1.0 / sqrt(t * t + 1.0);
  s = t * c;
}

// whether the (p, q) pair is skipped: its entry is at the noise of its
// diagonal, or 0
template <typename T>
__device__ __forceinline__ bool negligible(T app, T aqq, T apq) {
  return fabs(apq) <= Traits<T>::eps * root(fabs(app * aqq)) || apq == T(0);
}

// the pair's rotation, (1, 0) where it is skipped; whether it rotates
template <typename T>
__device__ __forceinline__ bool rotation(T app, T aqq, T apq, T& c, T& s) {
  const bool on = !negligible(app, aqq, apq);
  T cc, ss;
  schur2(app, aqq, apq, cc, ss);
  c = on ? cc : T(1);
  s = on ? ss : T(0);
  return on;
}

// The (p < q) pair k of round r of the round-robin over m indices: index
// m - 1 meets r, and r + k meets r - k (mod m - 1).
__host__ __device__ constexpr int pair_a(int r, int k, int m) {
  return k == 0 ? r : (r + k) % (m - 1);
}
__host__ __device__ constexpr int pair_b(int r, int k, int m) {
  return k == 0 ? m - 1 : (r - k + m - 1) % (m - 1);
}

// x's partner in round r: m - 1 and r meet, the others as 2r - x (mod m - 1)
__host__ __device__ constexpr int partner_of(int x, int r, int m) {
  return x == m - 1 ? r : x == r ? m - 1 : (2 * r - x + 2 * (m - 1)) % (m - 1);
}

// r[k] for a run-time k, by selects over the compile-time indices
template <typename T, int M>
__device__ __forceinline__ T pick(const T (&r)[M], int k) {
  T x = r[0];
#pragma unroll
  for (int j = 1; j < M; ++j) x = k == j ? r[j] : x;
  return x;
}

// a strict total order on (value, index): NaNs after every number, ties
// and NaNs by index
template <typename T>
__device__ __forceinline__ bool before(T x, int i, T y, int j) {
  const bool nx = isnan(x), ny = isnan(y);
  if (nx != ny) return ny;
  if (nx) return i < j;
  return x < y || (x == y && i < j);
}

// sym_eig, n <= THREAD_MAX_N: one thread a matrix in registers.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
sym_eig_thread(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
               int32_t* __restrict__ sweeps_out, long long batch) {
  constexpr int M = N + (N & 1);
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T* src = A + b * N * N;
  T a[N][N], v[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a[i][j] = i >= j ? src[i * N + j] : src[j * N + i];
      v[i][j] = i == j ? T(1) : T(0);
    }
  }
  int sweep = 0;
  for (; sweep < Traits<T>::sweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      // the round's rotations, computed first: independent chains
      T c[M / 2], s[M / 2];
      bool on[M / 2];
#pragma unroll
      for (int k = 0; k < M / 2; ++k) {
        const int p = min(pair_a(r, k, M), pair_b(r, k, M));
        const int q = max(pair_a(r, k, M), pair_b(r, k, M));
        on[k] = false;
        c[k] = T(1);
        s[k] = T(0);
        if (q < N) on[k] = rotation(a[p][p], a[q][q], a[q][p], c[k], s[k]);
      }
#pragma unroll
      for (int k = 0; k < M / 2; ++k) {
        const int p = min(pair_a(r, k, M), pair_b(r, k, M));
        const int q = max(pair_a(r, k, M), pair_b(r, k, M));
        if (q >= N) continue;
        rotated |= on[k];
        // a skipped pair's (1, 0) leaves every entry as it is
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const T aip = a[i][p], aiq = a[i][q];
          a[i][p] = c[k] * aip - s[k] * aiq;
          a[i][q] = s[k] * aip + c[k] * aiq;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const T apj = a[p][j], aqj = a[q][j];
          a[p][j] = c[k] * apj - s[k] * aqj;
          a[q][j] = s[k] * apj + c[k] * aqj;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const T vip = v[i][p], viq = v[i][q];
          v[i][p] = c[k] * vip - s[k] * viq;
          v[i][q] = s[k] * vip + c[k] * viq;
        }
        a[p][q] = a[q][p] = T(0);
      }
    }
    if (!rotated) break;
  }
  T* wo = w + b * N;
  T* vo = V + b * N * N;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int rank = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) rank += before(a[k][k], k, a[j][j], j) ? 1 : 0;
    wo[rank] = a[j][j];
#pragma unroll
    for (int i = 0; i < N; ++i) vo[i * N + rank] = v[i][j];
  }
  if (sweeps_out != nullptr) sweeps_out[b] = sweep;
}

// sym_eig, n > THREAD_MAX_N: a warp (one block) a matrix; lane i holds
// row i of A and column i of V.
template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
sym_eig_warp(const T* __restrict__ A, T* __restrict__ w, T* __restrict__ V,
             int32_t* __restrict__ sweeps_out, long long batch) {
  constexpr int M = N + (N & 1);
  constexpr unsigned ALL = 0xffffffffu;
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  if (b >= batch) return;
  const T* src = A + b * N * N;
  T row[M], col[N];
#pragma unroll
  for (int j = 0; j < M; ++j)
    row[j] = lane < N && j < N ? (lane >= j ? src[lane * N + j] : src[j * N + lane]) : T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) col[k] = k == lane ? T(1) : T(0);

  int sweep = 0;
  for (; sweep < Traits<T>::sweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int r = 0; r < M - 1; ++r) {
      // this lane's pair: the lower lane computes the rotation from its row
      const int pr = lane < M ? partner_of(lane, r, M) : lane;
      const bool real = lane < N && pr < N;
      const T dii = pick(row, lane), dip = pick(row, pr);
      const T dpp = __shfl_sync(ALL, dii, pr);
      T c = T(1), s = T(0);
      if (real && lane < pr) rotated |= rotation(dii, dpp, dip, c, s);
      const int lo = min(lane, pr);
      c = __shfl_sync(ALL, c, lo);
      s = __shfl_sync(ALL, s, lo);
      // column `lane` of G: c at lane, -s (lower) or s (higher) at pr
      const T cself = c, cpart = lane < pr ? -s : s;
      // rows: (G^T A)[lane] = c A[lane] + cpart A[pr]
      T mixed[M];
#pragma unroll
      for (int j = 0; j < M; ++j)
        mixed[j] = cself * row[j] + cpart * __shfl_sync(ALL, row[j], pr);
      // columns: (R G)[lane][j] = c_j R[lane][j] + cpart_j R[lane][p(j)]
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const T cj = __shfl_sync(ALL, cself, j), sj = __shfl_sync(ALL, cpart, j);
        row[j] = cj * mixed[j] + sj * mixed[partner_of(j, r, M)];
      }
      // a pair's own entry is 0, rotated or skipped
#pragma unroll
      for (int j = 0; j < M; ++j) row[j] = real && j == pr ? T(0) : row[j];
      // V's column lane: c V[:, lane] + cpart V[:, pr]
#pragma unroll
      for (int k = 0; k < N; ++k) col[k] = cself * col[k] + cpart * __shfl_sync(ALL, col[k], pr);
    }
    if (!__any_sync(ALL, rotated)) break;
  }

  // ascending: lane j < N writes value j and vector j at their rank
  const T wj = pick(row, lane);
  int rank = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) rank += before(__shfl_sync(ALL, wj, k), k, wj, lane) ? 1 : 0;
  if (lane < N) {
    w[b * N + rank] = wj;
    T* vo = V + b * N * N;
#pragma unroll
    for (int k = 0; k < N; ++k) vo[k * N + rank] = col[k];
  }
  if (lane == 0 && sweeps_out != nullptr) sweeps_out[b] = sweep;
}

// one Hestenes rotation of columns P < Q of a (V accumulated); whether it
// rotated
template <typename T, int P, int Q>
__device__ __forceinline__ bool hestenes(T (&a)[3][3], T (&v)[3][3]) {
  T alpha = T(0), beta = T(0), gamma = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    alpha += a[k][P] * a[k][P];
    beta += a[k][Q] * a[k][Q];
    gamma += a[k][P] * a[k][Q];
  }
  const bool on = !(gamma == T(0) || fabs(gamma) <= Traits<T>::eps * root(alpha * beta));
  T c, s;
  schur2(alpha, beta, gamma, c, s);
  c = on ? c : T(1);          // (1, 0) leaves both columns as they are
  s = on ? s : T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T akp = a[k][P], akq = a[k][Q];
    a[k][P] = c * akp - s * akq;
    a[k][Q] = s * akp + c * akq;
    const T vkp = v[k][P], vkq = v[k][Q];
    v[k][P] = c * vkp - s * vkq;
    v[k][Q] = s * vkp + c * vkq;
  }
  return on;
}

template <typename T>
__device__ __forceinline__ void swap_if(bool sw, T& x, T& y) {
  const T x2 = sw ? y : x, y2 = sw ? x : y;
  x = x2;
  y = y2;
}

// descending compare-and-swap of singular values I < J, with their
// inverses and columns of a and v; ties keep their order
template <typename T, int I, int J>
__device__ __forceinline__ void order_desc(T (&sig)[3], T (&inv)[3], T (&a)[3][3],
                                           T (&v)[3][3]) {
  const bool sw = sig[J] > sig[I];
  swap_if(sw, sig[I], sig[J]);
  swap_if(sw, inv[I], inv[J]);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    swap_if(sw, a[k][I], a[k][J]);
    swap_if(sw, v[k][I], v[k][J]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
svd3_kernel(const T* __restrict__ A, T* __restrict__ U, T* __restrict__ S,
            T* __restrict__ Vh, int32_t* __restrict__ sweeps_out, long long batch) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= batch) return;
  const T* src = A + b * 9;
  T a[3][3], v[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a[i][j] = src[i * 3 + j];
      v[i][j] = i == j ? T(1) : T(0);
    }
  }
  int sweep = 0;
  for (; sweep < Traits<T>::sweeps; ++sweep) {
    bool rotated = hestenes<T, 0, 1>(a, v);
    rotated |= hestenes<T, 0, 2>(a, v);
    rotated |= hestenes<T, 1, 2>(a, v);
    if (!rotated) break;
  }
  // singular values and their inverses: a column's norm (a zero column's
  // inverse is unused)
  T sig[3], inv[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T d = a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j];
    inv[j] = inv_root(d);
    sig[j] = d == T(0) ? T(0) : d * inv[j];
  }
  // descending, stable (a bubble pass, then the first pair again)
  order_desc<T, 0, 1>(sig, inv, a, v);
  order_desc<T, 1, 2>(sig, inv, a, v);
  order_desc<T, 0, 1>(sig, inv, a, v);

  const T thr = T(8) * Traits<T>::eps * sig[0];
  T u0[3], u1[3], u2[3];
  const bool zero = sig[0] <= T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) u0[k] = zero ? (k == 0 ? T(1) : T(0)) : a[k][0] * inv[0];
  // u1's completion: the axis least aligned with u0 (the first of the
  // smallest |u0_k|), made orthogonal to it
  const T m0 = fabs(u0[0]), m1 = fabs(u0[1]), m2 = fabs(u0[2]);
  const int e = m1 < m0 ? (m2 < m1 ? 2 : 1) : (m2 < m0 ? 2 : 0);
  const T d = e == 0 ? u0[0] : (e == 1 ? u0[1] : u0[2]);
  T x[3], n2 = T(0);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    x[k] = (k == e ? T(1) : T(0)) - d * u0[k];
    n2 += x[k] * x[k];
  }
  const T xn = inv_root(n2);
  const bool full1 = sig[1] > thr;
#pragma unroll
  for (int k = 0; k < 3; ++k) u1[k] = full1 ? a[k][1] * inv[1] : x[k] * xn;
  const bool full2 = sig[2] > thr;
  const T c0 = u0[1] * u1[2] - u0[2] * u1[1];
  const T c1 = u0[2] * u1[0] - u0[0] * u1[2];
  const T c2 = u0[0] * u1[1] - u0[1] * u1[0];
  u2[0] = full2 ? a[0][2] * inv[2] : c0;
  u2[1] = full2 ? a[1][2] * inv[2] : c1;
  u2[2] = full2 ? a[2][2] * inv[2] : c2;

  T* uo = U + b * 9;
  T* vo = Vh + b * 9;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uo[k * 3 + 0] = u0[k];
    uo[k * 3 + 1] = u1[k];
    uo[k * 3 + 2] = u2[k];
#pragma unroll
    for (int j = 0; j < 3; ++j) vo[j * 3 + k] = v[k][j];
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) S[b * 3 + j] = sig[j];
  if (sweeps_out != nullptr) sweeps_out[b] = sweep;
}

template <typename T, int N>
const void* eig_kernel_n() {
  if constexpr (N <= THREAD_MAX_N)
    return (const void*)sym_eig_thread<T, N>;
  else
    return (const void*)sym_eig_warp<T, N>;
}

// the sym_eig kernel at n (one thread a matrix to THREAD_MAX_N, a warp a
// matrix beyond), null outside 1..MAX_N
template <typename T>
const void* eig_kernel(int n) {
  static const void* const table[MAX_N] = {
      eig_kernel_n<T, 1>(), eig_kernel_n<T, 2>(),  eig_kernel_n<T, 3>(),
      eig_kernel_n<T, 4>(), eig_kernel_n<T, 5>(),  eig_kernel_n<T, 6>(),
      eig_kernel_n<T, 7>(), eig_kernel_n<T, 8>(),  eig_kernel_n<T, 9>(),
      eig_kernel_n<T, 10>(), eig_kernel_n<T, 11>(), eig_kernel_n<T, 12>()};
  return 1 <= n && n <= MAX_N ? table[n - 1] : nullptr;
}

// the kernel that entry (0 sym_eig at n, 1 svd3) launches in float64 or
// float32
const void* kernel_of(int entry, int n, int f64) {
  if (entry == 1) return f64 ? (const void*)svd3_kernel<double> : (const void*)svd3_kernel<float>;
  return f64 ? eig_kernel<double>(n) : eig_kernel<float>(n);
}

// one launch of fn on batch matrices: a warp a matrix for sym_eig beyond
// THREAD_MAX_N, else a thread a matrix; args as the kernels take them
int launch(const void* fn, bool warp, long long batch, void** args, void* stream) {
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const unsigned grid = (unsigned)(warp ? batch : (batch + THREADS - 1) / THREADS);
  return (int)cudaLaunchKernel(fn, dim3(grid), dim3(THREADS), args, 0,
                               static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Loads every kernel of the library on the current device (under lazy
// module loading a first launch would load it, which a capture refuses).
int small_eig_init() {
  cudaFuncAttributes attr;
  for (int entry = 0; entry < 2; ++entry) {
    for (int n = 1; n <= (entry == 0 ? MAX_N : 1); ++n) {
      for (int f64 = 0; f64 < 2; ++f64) {
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(entry, n, f64));
        if (err != cudaSuccess) return (int)err;
      }
    }
  }
  return 0;
}

// A read-only query: out = {registers a thread, local bytes a thread} of
// the kernel that entry (0 sym_eig, 1 svd3) launches at n (sym_eig) in
// float64 or float32.
int small_eig_attributes(int entry, int n, int f64, int* out) {
  const void* fn = kernel_of(entry, n, f64);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

// A (batch, n, n) symmetric, contiguous; w (batch, n); V (batch, n, n);
// sweeps (batch,) int32 or null: the Jacobi sweeps each matrix took.
int sym_eig_launch(const void* A, void* w, void* V, void* sweeps, long long batch, int n,
                   int f64, void* stream) {
  void* args[] = {&A, &w, &V, &sweeps, &batch};
  return launch(kernel_of(0, n, f64), n > THREAD_MAX_N, batch, args, stream);
}

// A (batch, 3, 3) contiguous; U (batch, 3, 3); S (batch, 3); Vh (batch, 3, 3);
// sweeps (batch,) int32 or null.
int svd3_launch(const void* A, void* U, void* S, void* Vh, void* sweeps, long long batch,
                int f64, void* stream) {
  void* args[] = {&A, &U, &S, &Vh, &sweeps, &batch};
  return launch(kernel_of(1, 3, f64), false, batch, args, stream);
}

}  // extern "C"
