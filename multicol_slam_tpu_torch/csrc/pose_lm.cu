// The pose-only Levenberg-Marquardt of one pose_optimization call, as one
// kernel: both LM rounds, the outlier gate between them and the final
// inlier count, each round stopping on the device once it is done.
//
// Replaces the JAX package's compiled pose LM
// (multicol_slam_tpu/models/optimizer.py:82-165: jax.jit around two
// jax.lax.while_loop rounds, which XLA fuses into a few device loops), a
// compiled unit and not a Pallas kernel. Computes what the plain version
// (models/optimizer.py::pose_optimization_reference) computes:
// - residual r = uv - world_to_img(cam, (M_t M_c)^-1 X) per observation
//   row, chi2 = |r|^2 inv_sigma2, the Huber cost over the round's rows;
// - a round starts with lam = LM_TAU max diag H(mt); an iteration solves
//   (H + lam I) d = g by LU with partial pivoting and no check (a singular
//   system gives a non-finite d, so a rejected step), evaluates the cost
//   at mt - d, accepts if it is lower (lam halved, else quadrupled), and
//   the round stops on an accepted step whose gain is under GAIN_EPS, or
//   after iters iterations;
// - round 1 runs on obs.valid; the gate keeps the rows with chi2 <=
//   huber^2 at its pose, round 2 runs on those; the final inliers are the
//   valid rows with chi2 <= huber^2 at the last pose.
//
// Design: one thread-block cluster of CLUSTER CTAs of THREADS threads a
// call (16 CTAs, a cluster size past the portable 8 that pose_lm_init
// allows before any capture: tools/pose_lm_study.py timed 16 against 8
// and other CTA widths). CTA rank r owns rows [r ceil(K / CLUSTER), (r + 1)
// ceil(K / CLUSTER)) in every pass, strided over its threads, so the
// thread that writes a row's gate bit reads it back in round 2. A pass
// over the rows at a pose evaluates each row's residual, robust cost,
// Huber weight and the written-out pose Jacobian (optimizer.pose_jacobian),
// and sums the cost, the 21 entries of the upper triangle of J^T W J and
// the 6 of J^T W r in one fixed order and with no atomics: each thread
// over its rows in row order, the warp's 32 lanes by a butterfly whose
// every sum groups the lanes as a shuffle-down tree does, the CTA's warps
// in warp order; warp 0 stores the CTA's sums into its rank's place in
// every rank's shared memory (distributed shared memory; two sets of
// places, by the pass's parity, so one cluster barrier a pass suffices),
// and after the cluster barrier every CTA adds the ranks' sums in rank
// order. So every CTA holds the same totals bit for bit and runs the same
// LM step in the registers of its two lead warps (each lane the same
// solve, accept and stop), with no broadcast; a graph's replay equals the
// eager call. The lead warps then spread the next pose's constants over
// their lanes: camera i's world-to-camera transform on warp 1's lane i, the
// 27 entries of dR / dc_m and R's 9 on warp 0's lanes 0-26, t on lanes
// 27-29. A pass is thus one __syncthreads before the rows, one after them
// and one cluster barrier. The pass at mt - d decides accept or reject,
// and on accept its H and g are the next iteration's (the plain version's
// hess(mt) there is the same values). Passes: 1 + iterations of round 1 +
// 1 (the gate, which is round 2's first pass) + iterations of round 2 + 1
// (the count). A cluster barrier before the first pass waits until every
// CTA of the cluster has started (distributed shared memory may be written
// only then); rank 0 writes the outputs; a last cluster barrier keeps
// every CTA of the cluster until all are done.
//
// Bound on an H100 (67 TFLOP/s float32, 34 TFLOP/s float64 outside the
// tensor cores; 3.35 TB/s): a pass is about 520 operations a row, so a
// call of 23 passes over 2,400 rows is some 29 MFLOP, 0.43 us in float32;
// its inputs are 0.08 MB, 0.02 us. What holds the kernel back is latency:
// the passes run one after another, each a row's chain of an atan2, a
// square root and divisions (4,400-4,800 SM cycles for one row a thread on
// an H100: tools/pose_lm_study.py --marks), the CTA's and the cluster's sums, and the lead warps' 6x6 solve. The
// cluster spreads the rows over CLUSTER SMs, so up to CLUSTER x THREADS
// rows take one row's chain; the serial rest of a pass is the barriers,
// the stores to the ranks and the solve.
//
// Built with --fmad=false (kernels/pose_lm.py): no multiply-add is
// contracted, so each row's elementwise chain (projection, Horner,
// chi2, Huber) rounds as PyTorch's separate kernels do. The matrix
// products before it (cuBLAS in the plain version) and the sums'
// order are not PyTorch's, so the sums agree only to rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the CTA width and the CTAs a cluster; tools/pose_lm_study.py builds
// other shapes with -DPOSE_LM_THREADS=N -DPOSE_LM_CLUSTER=M
#ifndef POSE_LM_THREADS
#define POSE_LM_THREADS 256
#endif
#ifndef POSE_LM_CLUSTER
#define POSE_LM_CLUSTER 16
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = POSE_LM_CLUSTER;   // CTAs a call; past 8 not portable (pose_lm_init)
constexpr int THREADS = POSE_LM_THREADS;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CAMS = 32;
constexpr int MAX_POLY = 16;
constexpr int NSUM = 28;              // cost, H's upper triangle (21), g (6)
constexpr int LEAD_WARPS = 2;         // the warps that keep the LM state
static_assert(THREADS % 32 == 0 && THREADS >= 64 && THREADS <= 1024, "CTA width");
static_assert(CLUSTER >= 2 && CLUSTER <= 16, "cluster size");

enum Mode { ROUND1 = 0, GATE = 1, ROUND2 = 2, FINAL = 3 };

template <typename T>
struct Args {
  const T* M_c;          // (C, 4, 4) camera-to-body extrinsics
  const T* c; const T* d; const T* e; const T* u0; const T* v0;   // (C,)
  const T* inv_poly;     // (C, npoly)
  const T* mt0;          // (6,)
  const T* uv;           // (K, 2)
  const int* cam;        // (K,)
  const int* pt;         // (K,)
  const T* inv_sigma2;   // (K,)
  const uint8_t* valid;  // (K,)
  const T* X;            // (P, 3)
  T* mt_out;             // (6,)
  uint8_t* inlier;       // (K,): round 2's rows, then the final inliers
  long long* n_out;      // ()
  int* it_out;           // ()
  long long K, P;
  int C, npoly, iters1, iters2;
  double huber, tau, gain_eps;
};

template <typename T>
struct Shared {
  T cam[MAX_CAMS][5];                 // c d e u0 v0
  T poly[MAX_CAMS][MAX_POLY];         // inv_poly, lowest order first
  T dpoly[MAX_CAMS][MAX_POLY];        // k inv_poly[k] at k - 1
  T Rc[MAX_CAMS][9], tc[MAX_CAMS][3]; // cayley2hom(M_c_min)
  T TR[MAX_CAMS][9], Tt[MAX_CAMS][3]; // inv_se3(M_t M_c) at the evaluated pose
  T A[MAX_CAMS][9];                   // -(R R_c)^T, the translation columns of dX_c
  T R[9], t[3], dR[3][9];             // the evaluated pose: R, t, dR / dc_m
  T part[WARPS][NSUM];                // a pass's sums by warp
  int cnt[WARPS];
  T slot[2][CLUSTER][NSUM];           // every rank's sums, by the pass's parity
  int slot_cnt[2][CLUSTER];
  int go;
};

// R = cayley2rot(c) (ops/geometry.py), in its operation order
template <typename T>
__device__ void cayley2rot(const T* c, T* R) {
  const T c1 = c[0], c2 = c[1], c3 = c[2];
  const T c1s = c1 * c1, c2s = c2 * c2, c3s = c3 * c3;
  const T scale = T(1) + c1s + c2s + c3s;
  R[0] = T(1) + c1s - c2s - c3s;   R[1] = T(2) * (c1 * c2 - c3); R[2] = T(2) * (c1 * c3 + c2);
  R[3] = T(2) * (c1 * c2 + c3);    R[4] = T(1) - c1s + c2s - c3s; R[5] = T(2) * (c2 * c3 - c1);
  R[6] = T(2) * (c1 * c3 - c2);    R[7] = T(2) * (c2 * c3 + c1); R[8] = T(1) - c1s - c2s + c3s;
  for (int i = 0; i < 9; ++i) R[i] = R[i] / scale;
}

// the Cayley vector of a rotation, C = (R - I)(R + I)^-1 with the
// adjugate inverse (geometry.rot2cayley, inv3x3)
template <typename T>
__device__ void rot2cayley(const T* R, T* c) {
  T P[9], M[9];
  for (int i = 0; i < 9; ++i) {
    const T one = (i % 4 == 0) ? T(1) : T(0);
    P[i] = R[i] + one;
    M[i] = R[i] - one;
  }
  const T a = P[0], b = P[1], cc = P[2], d = P[3], e = P[4], f = P[5];
  const T g = P[6], h = P[7], k = P[8];
  const T c00 = e * k - f * h, c01 = cc * h - b * k, c02 = b * f - cc * e;
  const T c10 = f * g - d * k, c11 = a * k - cc * g, c12 = cc * d - a * f;
  const T c20 = d * h - e * g, c21 = b * g - a * h, c22 = a * e - b * d;
  const T det = a * c00 + b * c10 + cc * c20;
  const T inv[9] = {c00 / det, c01 / det, c02 / det, c10 / det, c11 / det,
                    c12 / det, c20 / det, c21 / det, c22 / det};
  T C[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = M[3 * i] * inv[j] + M[3 * i + 1] * inv[3 + j] + M[3 * i + 2] * inv[6 + j];
  c[0] = -C[5];
  c[1] = C[2];
  c[2] = -C[1];
}

// sum_i coeffs[i] x^i, lowest order first (geometry.horner); unrolled to
// MAX_POLY with the steps past n - 1 skipped, so the coefficients' loads
// need not wait on the loop
template <typename T>
__device__ __forceinline__ T horner(const T* coeffs, int n, T x) {
  T res = T(0) + coeffs[n - 1];
#pragma unroll
  for (int i = MAX_POLY - 2; i >= 0; --i)
    if (i < n - 1) res = res * x + coeffs[i];
  return res;
}

// camera i's constants: its fields and cayley2hom(hom2cayley(M_c))
template <typename T>
__device__ void load_camera(Shared<T>& s, const Args<T>& a, int i) {
  s.cam[i][0] = a.c[i]; s.cam[i][1] = a.d[i]; s.cam[i][2] = a.e[i];
  s.cam[i][3] = a.u0[i]; s.cam[i][4] = a.v0[i];
  for (int k = 0; k < a.npoly; ++k) s.poly[i][k] = a.inv_poly[i * a.npoly + k];
  for (int k = 1; k < a.npoly; ++k) s.dpoly[i][k - 1] = s.poly[i][k] * T(k);
  const T* M = a.M_c + 16 * i;
  const T R[9] = {M[0], M[1], M[2], M[4], M[5], M[6], M[8], M[9], M[10]};
  T cay[3];
  rot2cayley(R, cay);
  cayley2rot(cay, s.Rc[i]);
  s.tc[i][0] = M[3]; s.tc[i][1] = M[7]; s.tc[i][2] = M[11];
}

// camera i at the pose mt: T = inv_se3(M_t M_c), and -(R R_c)^T
template <typename T>
__device__ __forceinline__ void pose_camera(Shared<T>& s, int i, const T* mt) {
  T R[9];
  cayley2rot(mt, R);
  const T* t = mt + 3;
  T MR[9], Mt[3];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      MR[3 * r + c] = R[3 * r] * s.Rc[i][c] + R[3 * r + 1] * s.Rc[i][3 + c]
                      + R[3 * r + 2] * s.Rc[i][6 + c];
    Mt[r] = R[3 * r] * s.tc[i][0] + R[3 * r + 1] * s.tc[i][1] + R[3 * r + 2] * s.tc[i][2]
            + t[r];
  }
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) {
      s.TR[i][3 * r + c] = MR[3 * c + r];
      s.A[i][3 * r + c] = -MR[3 * c + r];
    }
  }
  for (int r = 0; r < 3; ++r)
    s.Tt[i][r] = -(MR[r] * Mt[0] + MR[3 + r] * Mt[1] + MR[6 + r] * Mt[2]);
}

// v[i] for a runtime i in 0..n-1, by selects (an array in registers)
template <int n, typename T>
__device__ __forceinline__ T pick(const T* v, int i) {
  T r = v[0];
#pragma unroll
  for (int q = 1; q < n; ++q) r = i == q ? v[q] : r;
  return r;
}

// The constants of the pose mt (the same in every lead lane) for the next
// pass, spread over the two lead warps: on warp 1, camera i's transform on
// lane i < C; on warp 0, on lane j < 27 the entry (m, q) = (j / 9, j % 9)
// of dR / dc_m (geometry.cayley_rot_grads, in its operation order, with R's
// entry q as cayley2rot divides it), lanes j < 9 also R's entry j; t on
// lanes 27-29.
template <typename T>
__device__ __forceinline__ void set_pose(Shared<T>& s, const T* mt, int warp, int lane, int C) {
  if (warp == 1) {
    if (lane < C) pose_camera(s, lane, mt);
  } else if (lane < 27) {
    const int m = lane / 9, q = lane % 9, i = q / 3, j = q % 3;
    const T c1 = mt[0], c2 = mt[1], c3 = mt[2];
    const T c1s = c1 * c1, c2s = c2 * c2, c3s = c3 * c3;
    const T scale = T(1) + c1s + c2s + c3s;
    const T N[9] = {T(1) + c1s - c2s - c3s, T(2) * (c1 * c2 - c3), T(2) * (c1 * c3 + c2),
                    T(2) * (c1 * c2 + c3), T(1) - c1s + c2s - c3s, T(2) * (c2 * c3 - c1),
                    T(2) * (c1 * c3 - c2), T(2) * (c2 * c3 + c1), T(1) - c1s - c2s + c3s};
    const T Rq = pick<9>(N, q) / scale;
    const T sc = T(1) + (mt[0] * mt[0] + mt[1] * mt[1] + mt[2] * mt[2]);
    const T cm = pick<3>(mt, m), ci = pick<3>(mt, i), cj = pick<3>(mt, j);
    // skew(e_m)[i][j]: +1 at (m+2, m+1) and -1 at (m+1, m+2), mod 3
    const T sk = (i == (m + 2) % 3 && j == (m + 1) % 3) ? T(1)
                 : (i == (m + 1) % 3 && j == (m + 2) % 3) ? T(-1) : T(0);
    const T dN = T(-2) * cm * T(i == j) + T(2) * T(m == i) * cj
                 + T(2) * ci * T(m == j) + T(2) * sk;
    s.dR[m][q] = (dN - T(2) * cm * Rq) / sc;
    if (lane < 9) s.R[q] = Rq;
  } else if (lane < 30) {
    s.t[lane - 27] = pick<3>(mt + 3, lane - 27);
  }
}

// One step of warp_sums at lane distance W, then the next at W / 2.
template <int W, typename T>
__device__ __forceinline__ void butterfly(T (&v)[32], int lane) {
  const bool up = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const T send = up ? v[i] : v[i + W];
    const T keep = up ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
  if constexpr (W > 1) butterfly<W / 2>(v, lane);
}

// The warp's sum of each of the NSUM terms, term n ending in lane n (n <
// NSUM): a butterfly in which each lane keeps the half of its terms that
// its bit picks and adds its partner's copy of that half. Every term's sum
// groups the lanes as the shuffle-down tree (lane l + lane l + 16, then +
// 8, 4, 2, 1) does, and IEEE addition commutes, so it equals that tree's
// sum bit for bit, in 31 shuffles in place of 5 a term.
template <typename T>
__device__ __forceinline__ T warp_sums(const T (&acc)[NSUM], int lane) {
  T v[32];
#pragma unroll
  for (int n = 0; n < 32; ++n) v[n] = n < NSUM ? acc[n] : T(0);
  butterfly<16>(v, lane);
  return v[0];
}

// One pass over this CTA's rows [lo, hi) at the pose whose constants are in
// shared memory (written, and a __syncthreads passed, before the call).
// Returns, in every lane of the lead warps, the cluster's sums (cost, H's
// upper triangle row by row, g) in tot and the final inlier count in
// count.
template <typename T>
__device__ __forceinline__ void evaluate(Shared<T>& s, const Args<T>& a,
                                         cg::cluster_group& cluster, int mode,
                                         long long lo, long long hi, int parity,
                                         T (&tot)[NSUM], int& count) {
  const int tid = threadIdx.x;
  const T huber = T(a.huber), two_huber = T(2.0 * a.huber);
  const T delta2 = T(a.huber * a.huber), tiny = T(1e-12), zero_n = T(1e-14);
  T acc[NSUM];
#pragma unroll
  for (int n = 0; n < NSUM; ++n) acc[n] = T(0);
  int cnt = 0;
  for (long long k = lo + tid; k < hi; k += THREADS) {
    const int ci = a.cam[k];
    const long long pi = a.pt[k];
    const bool ok = ci >= 0 && ci < a.C && pi >= 0 && pi < a.P;
    const int cc = ok ? ci : 0;
    const T nan = T(NAN);
    const T X0 = ok ? a.X[3 * pi] : nan, X1 = ok ? a.X[3 * pi + 1] : nan;
    const T X2 = ok ? a.X[3 * pi + 2] : nan;
    const T* TR = s.TR[cc];
    const T* cm = s.cam[cc];
    // residual: X_c = T X, projected (camera.world_to_img)
    const T x = TR[0] * X0 + TR[1] * X1 + TR[2] * X2 + s.Tt[cc][0];
    const T y = TR[3] * X0 + TR[4] * X1 + TR[5] * X2 + s.Tt[cc][1];
    const T z = TR[6] * X0 + TR[7] * X1 + TR[8] * X2 + s.Tt[cc][2];
    const T n2 = x * x + y * y;
    T nrm = sqrt(n2);
    nrm = nrm == T(0) ? zero_n : nrm;
    const T theta = atan2(-z, nrm);
    const T rho = horner(s.poly[cc], a.npoly, theta);
    const T uu = x / nrm * rho, vv = y / nrm * rho;
    const T u = uu * cm[0] + vv * cm[1] + cm[3];
    const T v = uu * cm[2] + vv + cm[4];
    const T r0 = a.uv[2 * k] - u, r1 = a.uv[2 * k + 1] - v;
    const T chi2 = (r0 * r0 + r1 * r1) * a.inv_sigma2[k];
    const bool valid = a.valid[k] != 0;
    if (mode == FINAL) {
      const bool in = valid && chi2 <= delta2;
      a.inlier[k] = in;
      cnt += in;
      continue;
    }
    bool mask = valid;
    if (mode == GATE) {
      mask = valid && chi2 <= delta2;
      a.inlier[k] = mask;
    } else if (mode == ROUND2) {
      mask = a.inlier[k] != 0;
    }
    const T e = sqrt(chi2);
    const T cost = e <= huber ? chi2 : two_huber * e - delta2;
    acc[0] += mask ? cost : T(0);
    // Huber weight (optimizer._huber_w: delta / e is reciprocal(e) * delta)
    const T ew = sqrt(chi2 < tiny ? tiny : chi2);
    T w = (ew <= huber ? T(1) : (T(1) / ew) * huber) * a.inv_sigma2[k];
    w = mask ? w : T(0);
    // the pose Jacobian (optimizer.pose_jacobian): X_c again from d = X - t
    const T* Rc = s.Rc[cc];
    const T d0 = X0 - s.t[0], d1 = X1 - s.t[1], d2 = X2 - s.t[2];
    const T* Rm = s.R;
    const T Y0 = d0 * Rm[0] + d1 * Rm[3] + d2 * Rm[6] - s.tc[cc][0];
    const T Y1 = d0 * Rm[1] + d1 * Rm[4] + d2 * Rm[7] - s.tc[cc][1];
    const T Y2 = d0 * Rm[2] + d1 * Rm[5] + d2 * Rm[8] - s.tc[cc][2];
    const T xj = Rc[0] * Y0 + Rc[3] * Y1 + Rc[6] * Y2;
    const T yj = Rc[1] * Y0 + Rc[4] * Y1 + Rc[7] * Y2;
    const T zj = Rc[2] * Y0 + Rc[5] * Y1 + Rc[8] * Y2;
    // d world_to_img / d X_c (optimizer._projection_jacobian)
    const T jn2 = xj * xj + yj * yj;
    T jn = sqrt(jn2);
    jn = jn == T(0) ? zero_n : jn;
    const T jtheta = atan2(-zj, jn);
    const T jrho = horner(s.poly[cc], a.npoly, jtheta);
    const T drho = horner(s.dpoly[cc], a.npoly - 1, jtheta);
    const T q = jn2 + zj * zj;
    const T th[3] = {zj * xj / (jn * q), zj * yj / (jn * q), -jn / q};
    const T f = jrho / jn;
    const T n3 = jn * jn * jn;
    const T xyz[3] = {xj, yj, T(0)};
    T P[2][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T df = drho * th[i] / jn - jrho * xyz[i] / n3;
      const T duu = xj * df + (i == 0 ? f : T(0));
      const T dvv = yj * df + (i == 1 ? f : T(0));
      P[0][i] = cm[0] * duu + cm[1] * dvv;
      P[1][i] = cm[2] * duu + dvv;
    }
    // J = -P dX_c, a column of dX_c at a time: the rotation columns
    // R_c^T dY_m, dY_m = dR_m^T d; the translation columns -(R R_c)^T
    T J[2][6];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      T col[3];
      if (m < 3) {
        const T* dR = s.dR[m];
        const T dY0 = dR[0] * d0 + dR[3] * d1 + dR[6] * d2;
        const T dY1 = dR[1] * d0 + dR[4] * d1 + dR[7] * d2;
        const T dY2 = dR[2] * d0 + dR[5] * d1 + dR[8] * d2;
#pragma unroll
        for (int j = 0; j < 3; ++j) col[j] = Rc[j] * dY0 + Rc[3 + j] * dY1 + Rc[6 + j] * dY2;
      } else {
#pragma unroll
        for (int j = 0; j < 3; ++j) col[j] = s.A[cc][3 * j + m - 3];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) J[r][m] = -(P[r][0] * col[0] + P[r][1] * col[1] + P[r][2] * col[2]);
    }
    int n = 1;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const T w0 = J[0][i] * w, w1 = J[1][i] * w;
#pragma unroll
      for (int j = i; j < 6; ++j) acc[n++] += w0 * J[0][j] + w1 * J[1][j];
      acc[22 + i] += w0 * r0 + w1 * r1;
    }
  }

  // the sums: the warp's lanes, then the warps in warp order, sent to every
  // rank's slot for this rank; after the cluster barrier each lead warp adds
  // the ranks' slots in rank order
  const int lane = tid & 31, warp = tid >> 5;
  const T v = warp_sums(acc, lane);
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane < NSUM) s.part[warp][lane] = v;
  if (lane == 0) s.cnt[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    const unsigned me = cluster.block_rank();
    if (lane < NSUM) {
      T sum = s.part[0][lane];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum = sum + s.part[w][lane];
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) *cluster.map_shared_rank(&s.slot[parity][me][lane], r) = sum;
    } else if (lane == NSUM) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c += s.cnt[w];
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) *cluster.map_shared_rank(&s.slot_cnt[parity][me], r) = c;
    }
  }
  cluster.sync();
  if (warp < LEAD_WARPS) {
    T sum = T(0);
    int c = 0;
    if (lane < NSUM) {
      sum = s.slot[parity][0][lane];
#pragma unroll
      for (int r = 1; r < CLUSTER; ++r) sum = sum + s.slot[parity][r][lane];
    } else if (lane == NSUM) {
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) c += s.slot_cnt[parity][r];
    }
#pragma unroll
    for (int n = 0; n < NSUM; ++n) tot[n] = __shfl_sync(0xffffffffu, sum, n);
    count = __shfl_sync(0xffffffffu, c, NSUM);
  }
}

// d = (H + lam I)^-1 g by LU with partial pivoting (torch.linalg.solve_ex:
// no check; a zero pivot gives non-finite entries)
template <typename T>
__device__ __forceinline__ void solve6(const T* Hu, const T* g, T lam, T* x) {
  T A[6][6], b[6];
  int n = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = Hu[n];
      A[j][i] = Hu[n];
      ++n;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = A[i][j] + lam * T(i == j);
    b[i] = g[i];
  }
  // every index a compile-time constant (the pivot row is swapped in by
  // selects), so the system stays in registers
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    T best = fabs(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabs(A[i][k]) > best) {
        best = fabs(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const T tmp = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = tmp;
        }
        const T tmp = b[k];
        b[k] = b[i];
        b[i] = tmp;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const T l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    T sum = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) sum = sum - A[i][j] * x[j];
    x[i] = sum / A[i][i];
  }
}

template <typename T>
__device__ __forceinline__ T nan_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// The LM state lives in the lead warps' registers, the same in every lane
// of both and in every rank (each computes it from the same totals).
template <typename T>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
pose_lm_kernel(Args<T> a) {
  __shared__ Shared<T> s;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool lead = warp < LEAD_WARPS;
  const long long chunk = (a.K + CLUSTER - 1) / CLUSTER;
  const long long first = (long long)cluster.block_rank() * chunk;
  const long long lo = first < a.K ? first : a.K;
  const long long hi = lo + chunk < a.K ? lo + chunk : a.K;
  if (tid < a.C) load_camera(s, a, tid);
  __syncthreads();

  T mt_acc[6], mt[6], H[21], g[6], tot[NSUM];
  T lam = T(0), cost = T(0);
  int count = 0, it_total = 0, pass = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) mt_acc[i] = mt[i] = a.mt0[i];
  if (lead) set_pose(s, mt, warp, lane, a.C);
  // the first pass stores into every rank's shared memory: all CTAs of the
  // cluster must have started (and this CTA's constants be written)
  cluster.sync();
  for (int round = 0; round < 2; ++round) {
    evaluate(s, a, cluster, round == 0 ? ROUND1 : GATE, lo, hi, pass++ & 1, tot, count);
    const int iters = round == 0 ? a.iters1 : a.iters2;
    int it = 0;
    bool done = false;
    if (lead) {
      cost = tot[0];
#pragma unroll
      for (int n = 0; n < 21; ++n) H[n] = tot[1 + n];
#pragma unroll
      for (int i = 0; i < 6; ++i) g[i] = tot[22 + i];
      T m = H[0];
      m = nan_max(m, H[6]);
      m = nan_max(m, H[11]);
      m = nan_max(m, H[15]);
      m = nan_max(m, H[18]);
      m = nan_max(m, H[20]);
      lam = T(a.tau) * m;
    }
    for (;;) {
      if (lead) {
        const bool go = it < iters && !done;
        if (go) {
          T d[6];
          solve6(H, g, lam, d);
#pragma unroll
          for (int i = 0; i < 6; ++i) mt[i] = mt_acc[i] - d[i];
          set_pose(s, mt, warp, lane, a.C);
        }
        if (tid == 0) s.go = go;
      }
      __syncthreads();
      if (!s.go) break;
      evaluate(s, a, cluster, round == 0 ? ROUND1 : ROUND2, lo, hi, pass++ & 1, tot, count);
      if (lead) {
        const T cost_new = tot[0];
        const bool accept = cost_new < cost;
        const T gain = (cost - cost_new) / (cost_new < T(1e-12) ? T(1e-12) : cost_new);
        if (accept) {
#pragma unroll
          for (int i = 0; i < 6; ++i) mt_acc[i] = mt[i];
          cost = cost_new;
#pragma unroll
          for (int n = 0; n < 21; ++n) H[n] = tot[1 + n];
#pragma unroll
          for (int i = 0; i < 6; ++i) g[i] = tot[22 + i];
          lam = lam * T(0.5);
        } else {
          lam = lam * T(4);
        }
        ++it;
        done = accept && gain < T(a.gain_eps);
      }
    }
    if (lead) {
      it_total += it;
      set_pose(s, mt_acc, warp, lane, a.C);
    }
    __syncthreads();
  }
  evaluate(s, a, cluster, FINAL, lo, hi, pass++ & 1, tot, count);
  if (tid == 0 && cluster.block_rank() == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) a.mt_out[i] = mt_acc[i];
    *a.n_out = count;
    *a.it_out = it_total;
  }
  cluster.sync();   // every CTA stays until the cluster is done
}

template <typename T>
int launch(const void* M_c, const void* c, const void* d, const void* e, const void* u0,
           const void* v0, const void* inv_poly, int C, int npoly, const void* mt0,
           const void* uv, const int* cam, const int* pt, const void* inv_sigma2,
           const uint8_t* valid, long long K, const void* X, long long P, double huber,
           int iters1, int iters2, double tau, double gain_eps, void* mt_out,
           uint8_t* inlier, long long* n_out, int* it_out, cudaStream_t stream) {
  if (C < 1 || C > MAX_CAMS || npoly < 2 || npoly > MAX_POLY || K < 0 || P < 0)
    return (int)cudaErrorInvalidValue;
  Args<T> a;
  a.M_c = (const T*)M_c;
  a.c = (const T*)c; a.d = (const T*)d; a.e = (const T*)e;
  a.u0 = (const T*)u0; a.v0 = (const T*)v0;
  a.inv_poly = (const T*)inv_poly;
  a.mt0 = (const T*)mt0;
  a.uv = (const T*)uv;
  a.cam = cam;
  a.pt = pt;
  a.inv_sigma2 = (const T*)inv_sigma2;
  a.valid = valid;
  a.X = (const T*)X;
  a.mt_out = (T*)mt_out;
  a.inlier = inlier;
  a.n_out = n_out;
  a.it_out = it_out;
  a.K = K;
  a.P = P;
  a.C = C;
  a.npoly = npoly;
  a.iters1 = iters1;
  a.iters2 = iters2;
  a.huber = huber;
  a.tau = tau;
  a.gain_eps = gain_eps;
  pose_lm_kernel<T><<<CLUSTER, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

const void* kernel_of(int f64) {
  return f64 ? (const void*)pose_lm_kernel<double> : (const void*)pose_lm_kernel<float>;
}

}  // namespace

extern "C" {

// Loads both instances on the current device (under lazy module loading a
// first launch would load them, which a capture refuses), and allows a
// cluster past the portable 8 where the build asks for one.
int pose_lm_init() {
  for (int f64 = 0; f64 < 2; ++f64) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(f64));
    if (err == cudaSuccess && CLUSTER > 8)
      err = cudaFuncSetAttribute(kernel_of(f64),
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// A read-only query: out = {registers a thread, local bytes a thread,
// CTAs a cluster, threads a CTA, clusters of that shape the device can
// hold at once} of the float64 or float32 instance.
int pose_lm_attributes(int f64, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(f64));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(CLUSTER);
  config.blockDim = dim3(THREADS);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel_of(f64), &config);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = CLUSTER;
  out[3] = THREADS;
  out[4] = clusters;
  return 0;
}

int pose_lm_launch(const void* M_c, const void* c, const void* d, const void* e,
                   const void* u0, const void* v0, const void* inv_poly, int C, int npoly,
                   const void* mt0, const void* uv, const int* cam, const int* pt,
                   const void* inv_sigma2, const uint8_t* valid, long long K, const void* X,
                   long long P, double huber, int iters1, int iters2, double tau,
                   double gain_eps, void* mt_out, uint8_t* inlier, long long* n_out,
                   int* it_out, int f64, void* stream) {
  auto fn = f64 ? launch<double> : launch<float>;
  return fn(M_c, c, d, e, u0, v0, inv_poly, C, npoly, mt0, uv, cam, pt, inv_sigma2, valid, K,
            X, P, huber, iters1, iters2, tau, gain_eps, mt_out, inlier, n_out, it_out,
            (cudaStream_t)stream);
}

}  // extern "C"
