// Small dense eigensolvers for the RANSAC solvers' graphs: a batched
// symmetric eigen-decomposition (n <= 12) and a batched 3x3 SVD.
//
// Replaces no TPU kernel: the JAX package leaves eigh and svd to XLA
// inside its jitted RANSAC (multicol_slam_tpu/ops/ransac.py:56,59,135,310
// and ops/sim3.py's Horn alignment). On the card the port replays the
// RANSAC units as CUDA graphs, and torch.linalg.eigh / svd read cuSOLVER's
// info flag on the host after every call, which a capture refuses. These
// kernels read nothing back: a launch is one kernel on the caller's
// stream.
//
// sym_eig: cyclic Jacobi, one thread per matrix, the lower triangle read
// (as torch.linalg.eigh's default UPLO='L'), rotations in the textbook
// order (p < q, row by row), a pair skipped once |a_pq| is below eps of
// sqrt(|a_pp a_qq|); a sweep with no rotation ends the loop, at most
// SWEEPS sweeps. Eigenvalues ascending, eigenvectors as columns
// (V[b, i, j] = component i of vector j), as eigh returns them.
// svd3: one-sided (Hestenes) Jacobi on the columns of a 3x3 matrix with V
// accumulated; singular values are the column norms, in descending order;
// U's columns are the normalized columns, and a column whose singular
// value is at most 8 eps of the largest (a rank-deficient E or a zeroed
// DLT block) is completed to an orthonormal U (u2 from the axis least
// aligned with u1, u3 = u1 x u2). Returns U, S and Vh = V^T, as
// torch.linalg.svd does. Singular and eigen vectors are defined up to
// sign, so a column may differ in sign from cuSOLVER's or LAPACK's.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s float32, 34 TFLOP/s float64
// outside the tensor cores): a rotation costs about 18 n flops, a sweep
// n (n - 1) / 2 rotations. At the GP3P RANSAC's 1024 x 4x4 in float32
// (6 sweeps) about 0.8 MFLOP against 0.15 MB: 0.05 us by bytes, 0.01 us
// by operations, far below one launch; the 8-point refit (1 x 9x9) and a
// 3x3 SVD are smaller still. The design is the simple one: every matrix
// stays in a thread's registers and local memory, there is no shared
// memory and no synchronization, and a launch of a few hundred threads
// costs its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_N = 12;

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr float eps = 1.1920929e-07f;
  static constexpr int sweeps = 12;
};
template <> struct Traits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr int sweeps = 16;
};

// c, s of the rotation that zeroes the (p, q) entry of a 2x2 symmetric
// block [[app, apq], [apq, aqq]] (Golub and Van Loan's sym.schur2).
template <typename T>
__device__ inline void schur2(T app, T aqq, T apq, T* c, T* s) {
  T theta = (aqq - app) / (T(2) * apq);
  T t = copysign(T(1), theta) / (fabs(theta) + sqrt(theta * theta + T(1)));
  *c = T(1) / sqrt(t * t + T(1));
  *s = t * *c;
}

template <typename T, int N>
__global__ void sym_eig_kernel(const T* __restrict__ A, T* __restrict__ w,
                               T* __restrict__ V, int32_t* __restrict__ sweeps_out,
                               long long batch) {
  long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
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
  const T eps = Traits<T>::eps;
  int sweep = 0;
  for (; sweep < Traits<T>::sweeps; ++sweep) {
    int rotated = 0;
#pragma unroll 1
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll 1
      for (int q = p + 1; q < N; ++q) {
        T apq = a[p][q];
        if (fabs(apq) <= eps * sqrt(fabs(a[p][p] * a[q][q])) || apq == T(0)) {
          a[p][q] = a[q][p] = T(0);
          continue;
        }
        ++rotated;
        T c, s;
        schur2(a[p][p], a[q][q], apq, &c, &s);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          T akp = a[k][p], akq = a[k][q];
          a[k][p] = c * akp - s * akq;
          a[k][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int k = 0; k < N; ++k) {
          T apk = a[p][k], aqk = a[q][k];
          a[p][k] = c * apk - s * aqk;
          a[q][k] = s * apk + c * aqk;
        }
        a[p][q] = a[q][p] = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          T vkp = v[k][p], vkq = v[k][q];
          v[k][p] = c * vkp - s * vkq;
          v[k][q] = s * vkp + c * vkq;
        }
      }
    }
    if (!rotated) break;
  }
  // ascending order, vectors permuted with their values
  int order[N];
#pragma unroll
  for (int i = 0; i < N; ++i) order[i] = i;
  for (int i = 0; i < N - 1; ++i) {
    int m = i;
    for (int j = i + 1; j < N; ++j)
      if (a[order[j]][order[j]] < a[order[m]][order[m]]) m = j;
    int tmp = order[i]; order[i] = order[m]; order[m] = tmp;
  }
  T* wo = w + b * N;
  T* vo = V + b * N * N;
  for (int j = 0; j < N; ++j) {
    int src_col = order[j];
    wo[j] = a[src_col][src_col];
    for (int i = 0; i < N; ++i) vo[i * N + j] = v[i][src_col];
  }
  if (sweeps_out != nullptr) sweeps_out[b] = sweep;
}

template <typename T>
__global__ void svd3_kernel(const T* __restrict__ A, T* __restrict__ U, T* __restrict__ S,
                            T* __restrict__ Vh, int32_t* __restrict__ sweeps_out,
                            long long batch) {
  long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
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
  const T eps = Traits<T>::eps;
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  int sweep = 0;
  for (; sweep < Traits<T>::sweeps; ++sweep) {
    int rotated = 0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int p = P[r], q = Q[r];
      T alpha = T(0), beta = T(0), gamma = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        alpha += a[k][p] * a[k][p];
        beta += a[k][q] * a[k][q];
        gamma += a[k][p] * a[k][q];
      }
      if (gamma == T(0) || fabs(gamma) <= eps * sqrt(alpha * beta)) continue;
      ++rotated;
      T c, s;
      schur2(alpha, beta, gamma, &c, &s);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T akp = a[k][p], akq = a[k][q];
        a[k][p] = c * akp - s * akq;
        a[k][q] = s * akp + c * akq;
        T vkp = v[k][p], vkq = v[k][q];
        v[k][p] = c * vkp - s * vkq;
        v[k][q] = s * vkp + c * vkq;
      }
    }
    if (!rotated) break;
  }
  T sig[3];
  int order[3] = {0, 1, 2};
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sig[j] = sqrt(a[0][j] * a[0][j] + a[1][j] * a[1][j] + a[2][j] * a[2][j]);
  // descending
  for (int i = 0; i < 2; ++i) {
    int m = i;
    for (int j = i + 1; j < 3; ++j)
      if (sig[order[j]] > sig[order[m]]) m = j;
    int tmp = order[i]; order[i] = order[m]; order[m] = tmp;
  }
  T u[3][3];   // u[j] = column j of U
  const T s0 = sig[order[0]];
  const T thr = T(8) * eps * s0;
  for (int j = 0; j < 3; ++j) {
    const int c = order[j];
    if (j == 0 && s0 <= T(0)) {
      u[0][0] = T(1); u[0][1] = T(0); u[0][2] = T(0);
    } else if (j == 0 || sig[c] > thr) {
      for (int k = 0; k < 3; ++k) u[j][k] = a[k][c] / sig[c];
    } else if (j == 1) {
      // the axis least aligned with u1, made orthogonal to it
      int e = 0;
      for (int k = 1; k < 3; ++k)
        if (fabs(u[0][k]) < fabs(u[0][e])) e = k;
      T x[3] = {T(0), T(0), T(0)};
      x[e] = T(1);
      T d = u[0][e];
      T n2 = T(0);
      for (int k = 0; k < 3; ++k) { x[k] -= d * u[0][k]; n2 += x[k] * x[k]; }
      T inv = T(1) / sqrt(n2);
      for (int k = 0; k < 3; ++k) u[1][k] = x[k] * inv;
    } else {
      u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
      u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
      u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
    }
  }
  T* uo = U + b * 9;
  T* vo = Vh + b * 9;
  for (int j = 0; j < 3; ++j) {
    const int c = order[j];
    S[b * 3 + j] = sig[c];
    for (int k = 0; k < 3; ++k) {
      uo[k * 3 + j] = u[j][k];
      vo[j * 3 + k] = v[k][c];
    }
  }
  if (sweeps_out != nullptr) sweeps_out[b] = sweep;
}

template <typename T, int N>
int launch_eig(const void* A, void* w, void* V, void* sweeps, long long batch,
               cudaStream_t stream) {
  long long blocks = (batch + THREADS - 1) / THREADS;
  sym_eig_kernel<T, N><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(A), static_cast<T*>(w), static_cast<T*>(V),
      static_cast<int32_t*>(sweeps), batch);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_eig(const void* A, void* w, void* V, void* sweeps, long long batch, int n,
                 cudaStream_t stream) {
  switch (n) {
    case 1: return launch_eig<T, 1>(A, w, V, sweeps, batch, stream);
    case 2: return launch_eig<T, 2>(A, w, V, sweeps, batch, stream);
    case 3: return launch_eig<T, 3>(A, w, V, sweeps, batch, stream);
    case 4: return launch_eig<T, 4>(A, w, V, sweeps, batch, stream);
    case 5: return launch_eig<T, 5>(A, w, V, sweeps, batch, stream);
    case 6: return launch_eig<T, 6>(A, w, V, sweeps, batch, stream);
    case 7: return launch_eig<T, 7>(A, w, V, sweeps, batch, stream);
    case 8: return launch_eig<T, 8>(A, w, V, sweeps, batch, stream);
    case 9: return launch_eig<T, 9>(A, w, V, sweeps, batch, stream);
    case 10: return launch_eig<T, 10>(A, w, V, sweeps, batch, stream);
    case 11: return launch_eig<T, 11>(A, w, V, sweeps, batch, stream);
    case 12: return launch_eig<T, 12>(A, w, V, sweeps, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int load_eig_kernels() {
  cudaFuncAttributes attr;
  const void* fns[MAX_N] = {
      (const void*)sym_eig_kernel<T, 1>, (const void*)sym_eig_kernel<T, 2>,
      (const void*)sym_eig_kernel<T, 3>, (const void*)sym_eig_kernel<T, 4>,
      (const void*)sym_eig_kernel<T, 5>, (const void*)sym_eig_kernel<T, 6>,
      (const void*)sym_eig_kernel<T, 7>, (const void*)sym_eig_kernel<T, 8>,
      (const void*)sym_eig_kernel<T, 9>, (const void*)sym_eig_kernel<T, 10>,
      (const void*)sym_eig_kernel<T, 11>, (const void*)sym_eig_kernel<T, 12>};
  for (int i = 0; i < MAX_N; ++i) {
    cudaError_t err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err != cudaSuccess) return (int)err;
  }
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)svd3_kernel<T>);
  return (int)err;
}

}  // namespace

extern "C" {

// Loads every kernel of the library on the current device (under lazy
// module loading a first launch would load it, which a capture refuses).
int small_eig_init() {
  int err = load_eig_kernels<float>();
  if (err != 0) return err;
  return load_eig_kernels<double>();
}

// A (batch, n, n) symmetric, contiguous; w (batch, n); V (batch, n, n);
// sweeps (batch,) int32 or null: the Jacobi sweeps each matrix took.
int sym_eig_launch(const void* A, void* w, void* V, void* sweeps, long long batch, int n,
                   int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  return f64 ? dispatch_eig<double>(A, w, V, sweeps, batch, n, s)
             : dispatch_eig<float>(A, w, V, sweeps, batch, n, s);
}

// A (batch, 3, 3) contiguous; U (batch, 3, 3); S (batch, 3); Vh (batch, 3, 3);
// sweeps (batch,) int32 or null.
int svd3_launch(const void* A, void* U, void* S, void* Vh, void* sweeps, long long batch,
                int f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0) return 0;
  long long blocks = (batch + THREADS - 1) / THREADS;
  if (f64)
    svd3_kernel<double><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const double*>(A), static_cast<double*>(U), static_cast<double*>(S),
        static_cast<double*>(Vh), static_cast<int32_t*>(sweeps), batch);
  else
    svd3_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const float*>(A), static_cast<float*>(U), static_cast<float*>(S),
        static_cast<float*>(Vh), static_cast<int32_t*>(sweeps), batch);
  return (int)cudaGetLastError();
}

}  // extern "C"
