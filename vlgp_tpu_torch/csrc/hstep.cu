// The H-step's bounded search on log(omega), for Hopper: the counterpart of
// the lax.fori_loop of vlgp_tpu/models/gp.py:_golden_min (:255-268) that
// hstep runs at :270-272, which has no Pallas kernel (XLA compiles the
// search into one device loop).  The port's plain version
// (vlgp_tpu_torch/ops/golden.py:_hstep_search_plain, the torch
// _golden_min over gp_elbo_stats) makes ~15-20 launches per evaluation,
// some of them cuSOLVER and cuBLAS batched calls, ~1,000 per refinement.
//
// One thread-block cluster of nb blocks per latent z runs the whole
// search: the grid scan (grid candidates on [lo, hi], a NaN objective
// counted as +inf, the first candidate within tiebreak |fmin| of the
// minimum, a NaN neighbour shrinking the bracket onto the best candidate,
// an all-NaN column collapsing onto lo), then iters golden-section shrinks
// and, with polish, the vertex of the parabola through the last three
// points, each branch as in _golden_min.  The search's own arithmetic is
// rounded operation by operation (no FMA contraction), as torch rounds
// each of its ops, so the decisions differ from the plain version's only
// where the objective does.
//
// The search runs in rounds of np points (np = nb / per, per the blocks
// that evaluate one point: 1 in shared memory, 1-16 on the wide path
// below); in a round each group of per blocks evaluates at most one point,
// its first block writes the objective into every block's shared memory
// (distributed shared memory, cluster.map_shared_rank), and after
// cluster.sync() every block walks the search with the same values, so
// all take the same path:
//
//   grid round(s): candidate i on slot i mod np, ceil(grid / np) rounds;
//   first golden round: c and d, and every point the next m shrinks can
//       reach, 2 + 2 + 4 + ... + 2^m = 2^(m+1) <= np points (m = 3 at np
//       16): the shrink's comparison fc < fd is not known yet, so each
//       level holds both outcomes;
//   later rounds: a shrink's comparison is known from the round before, so
//       the next m shrinks can reach 1 + 2 + ... + 2^(m-1) = 2^m - 1 <= np
//       points (m = 4 at np 16), the tree in heap order, node k's children
//       2k (fc >= fd) and 2k + 1 (fc < fd); a short last level and any
//       slot beyond the tree idle through the round;
//   polish: the final bracket's mid, one more round.
//
// A point on the path is formed by the same rounded operations from the
// same values as in a chain of single evaluations, and an evaluation's
// arithmetic does not depend on the blocks that share it, so x does not
// depend on the plan (nb, per): nb = 1 (a cluster of one, no look-ahead)
// is the one-block chain, bit for bit.  At the default Config (grid 13,
// iters 24, no polish) a search is 8 rounds at np 16 (1 grid, 1 first, 6
// of depth 4: 3 + 4 x 5 + 1 = 24 shrinks), 11 at np 8 and 39 at np 1.
//
// Each evaluation is gp_elbo_stats (vlgp_tpu_torch/models/gp.py) of the
// statistic C[z] (T x T):
//
//   K = amp exp(-omega dsq) + gp_noise I (amp = 1 with profile_sigma,
//       sigma^2 else), dsq[i, j] = (i dt - j dt)^2;
//   L = chol(K), with the forward elimination of [C | I], so that the
//       right-hand side ends as [L^-1 C | L^-1]; a pivot that is not > 0
//       (or NaN) makes the objective NaN, as cholesky_ex's info > 0 does;
//   tr = tr(K^-1 C) = sum_ij (L^-1)_ij (L^-1 C)_ij, logdet = sum log
//       diag(L), each added in a fixed order;
//   f = 0.5 tr + nseg logdet, or with profile_sigma s = clip(tr / (nseg
//       T), 1e-2, 1e2) and f = 0.5 tr / s + nseg (0.5 T log s + logdet).
//
// In shared memory (hstep_search_kernel, T <= 138 in float32, T <= 97 in
// float64: K, [C | I] and log diag(L) of one block, 3 T^2 + T values), a
// block evaluates a point alone: right-looking, one barrier per column
// step, column k of L used as A[i][k] / L[k][k] where it is needed.  The
// flagship (T50): a chain of single evaluations (nb = 1) runs the grid + 2
// + iters (+ 1 with polish) of them one after another, 39 at ~0.9 us a
// column step, 1.80 ms a search on an H100; the cluster of 16 cuts that to
// 8 rounds, 0.383 ms (~48 us a round), with 5 clusters of 16 on 80 SMs.
// Measured on the same card and not kept (one block a latent): L^-1 C and
// the diagonal of L^-T (L^-1 C) solved a thread per column (3.67 ms a
// search), 256 threads (2.33 ms), and each lane staging its columns of row
// k in registers before its row updates (2.03 ms).
//
// The wide path (hstep_search_wide_kernel, every larger T: window=None,
// T1000).  Done as above, an evaluation was T dependent column steps, each
// re-reading the trailing matrix in device memory: ~0.34 s at T1000, 7.9 s
// a search.  Here per blocks of the cluster (up to 16 SMs) share one
// evaluation, a right-looking factorisation blocked by panels of P = 64
// on the augmented matrix M = [K | C | I] (Tp x 3 Tp, Tp = T rounded up to
// P; the pad has K = I, C = 0, I = I, so it adds exact zeros and log 1),
// in device memory (L2: 8.4 MB touched an evaluation at T1000 float32).
// Tiles are P x P; row block k of M is the panel.  Step k, two phases, a
// cluster barrier after each:
//
//   solve: the factor of K's diagonal tile (k, k) in shared memory (at
//       k = 0 each block factors it; later the first block has factored
//       it during the update before and the others read it), then the
//       columns of row block k right of it, K's upper tiles k+1.. (the
//       next U = L^T rows), every C tile and the I tiles 0..k, solved by
//       forward substitution, one column per thread in registers, spread
//       over the evaluation's threads;
//   update: for each row block i > k, the column tiles i..2 nt + k (K's
//       upper tiles, all of C, I's tiles 0..k) take M[i][j] -= U_ki^T
//       M[k][j], a task two 64 x 64 x 64 products (one in float64), 4 x 4
//       register tiles from operand tiles in shared memory (cp.async, the
//       next task's copied under the current one's products); each entry
//       sums its 64 products in order and is then subtracted once, as a
//       GEMM's epilogue does.  Task 0 holds the next diagonal tile: the
//       first block runs it, factors that tile and publishes the factor,
//       the other blocks take the other tasks in turn.
//
// and after the last step each lower tile's sum of L^-1 (.) L^-1 C (a
// fixed thread map, shuffle tree and warp order), then the first block of
// the evaluation adds the tiles' sums in a fixed tree and the tiles'
// log-diagonal sums in step order.  Each entry's operations are a function
// of (T, P) alone: no split-K and no atomics, whichever block computes
// it, so the objective, and x, are the same bits for every plan.  2 nt + 1
// cluster barriers an evaluation (33 at T1000) in place of T block ones.
// The diagonal factor is right-looking in leaves of 8 columns (one thread
// in registers, then the leaf's rows of U and the trailing entries by the
// block), each entry's operations in the unblocked column steps' order.
//
// What bounds the wide path: gp_elbo_stats needs ~T^3 / 2 FMAs an
// evaluation at least (the Cholesky T^3 / 6, K^-1 = L^-T L^-1 from L by
// trtri and lauum T^3 / 3, tr(K^-1 C) as the sum of K^-1 (.) C T^2), so a
// Z5 T1000 search of grid + 2 + iters evaluations is 2.92 ms at the card's
// FP32 rate (chip_smoke.hstep_search_bound).  This kernel does ~5 T^3 / 6
// (8.6e8 at T1000 with the pad): the forward elimination of [C | I] gives
// L^-1 C (T^3 / 2) and L^-1 (T^3 / 6) beside the Cholesky, so the trace
// needs no second triangular pass; the route through K^-1 is untried.
// Measured on an H100 (T1000 float32, Z5, clusters of 16 with 16 blocks
// an evaluation, chip_smoke.py 6c): 35.7 ms a search.  Measured and not
// kept: the diagonal factor as 64 column steps with a block barrier each,
// and as two 32-column halves each factored by one warp with shuffles;
// both took longer than the leaves, which are off the critical path but
// for step 0.  The plan (hstep_search_cluster) counts the work: the
// evaluation's time on per blocks summed per phase from its task counts
// (wide_eval_ns), times the rounds of np = nb / per points, times the
// waves of clusters; the least cost wins, with scratch (Z np evaluations)
// within SCRATCH_CAP bytes.  At Z5 T150-T200 it takes 2 blocks an
// evaluation and 8 points a round.
//
// The cluster size on the shared-memory path.  hstep_search_cluster picks
// nb in {16, 8, 4, 2, 1} from the shape and the card alone: for each size
// that cudaOccupancyMaxActiveClusters finds resident, the cost rounds(nb)
// x ceil(Z / resident clusters); the least cost wins, a tie going to the
// larger nb.  16 is the largest (non-portable) cluster on Hopper; a
// cluster's blocks share one GPC (16-18 SMs on an H100), but a block of
// 512 threads and 30 KB (the flagship's T50) leaves room for four on an
// SM, so the card holds many clusters of 16 at once, and at Z > 8 the
// clusters that do not fit wait for a free GPC (one more wave of rounds),
// which the cost counts.  A wide block takes 120 KB or more of shared
// memory, one an SM.

#include <climits>
#include <cooperative_groups.h>
#include <cmath>

#include "ns_common.cuh"

namespace {

constexpr int NT = 512;              // threads per block: a warp per row of a column step
constexpr int NW = NT / 32;
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr int GRID_MAX = 256;
constexpr int NB_MAX = 16;           // the largest cluster (non-portable) Hopper launches
// global scratch a launch may take on the wide path; a plan whose scratch
// would exceed it is not picked
constexpr size_t SCRATCH_CAP = (size_t)1 << 30;

// the wide path
constexpr int P = 64;                // panel width and tile side
constexpr int NTW = 256;             // threads per block
constexpr int NWW = NTW / 32;
constexpr size_t WIDE_SMEM_MIN = 120 * 1024;  // so that one block runs an SM

namespace cg = cooperative_groups;

template <typename T>
struct Rn;
template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};
template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

// K, [C | I] and log diag(L) of one block, in values
__host__ __device__ inline size_t per_latent(int n) { return 3 * (size_t)n * n + n; }

template <typename T>
struct Search {
  const T* C;      // this latent's T x T statistic
  T* A;            // K (n x n), its lower triangle reduced in place
  T* W;            // [C | I] (n x 2n), reduced to [L^-1 C | L^-1]
  T* lgd;          // log diag(L)
  T* red;          // per-warp partial sums of the trace
  int n;           // T
  T amp, gpn, dt, nseg;
  bool profile;
};

// -ll from tr(K^-1 C) and log|L| (gp_elbo_stats' two forms)
template <typename T>
__device__ __forceinline__ T objective(T tr, T logdet, T nseg, int n, bool profile) {
  using R = Rn<T>;
  T ll;
  if (profile) {
    T sc = tr / R::mul(nseg, (T)n);
    sc = sc < (T)1e-2 ? (T)1e-2 : (sc > (T)1e2 ? (T)1e2 : sc);  // NaN stays NaN
    ll = R::sub(R::mul((T)-0.5, tr) / sc,
                R::mul(nseg, R::add(R::mul((T)(0.5 * n), log(sc)), logdet)));
  } else {
    ll = R::sub(R::mul((T)-0.5, tr), R::mul(nseg, logdet));
  }
  return -ll;
}

// the objective -ll at log(omega) = xlog; the same value in every thread
template <typename T>
__device__ T evaluate(const Search<T>& s, T xlog) {
  using R = Rn<T>;
  const int n = s.n, w = 2 * n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T om = exp(xlog);
  const T nom = -om;
  __syncthreads();  // the last evaluation's readers are done
  for (int idx = tid; idx < n * n; idx += NT) {
    const int i = idx / n, j = idx - i * n;
    if (j <= i) {
      const T d = R::sub(R::mul((T)i, s.dt), R::mul((T)j, s.dt));
      T k = R::mul(s.amp, exp(R::mul(nom, R::mul(d, d))));
      if (i == j) k = R::add(k, s.gpn);
      s.A[idx] = k;
    }
    s.W[i * w + j] = s.C[idx];
    s.W[i * w + n + j] = (T)(i == j);
  }
  __syncthreads();

  // right-looking Cholesky with the forward elimination of [C | I] in the
  // same column steps, one barrier each.  Column k of L is used as
  // A[i][k] * (1 / L[k][k]) where it is needed and never stored, and row k
  // of the right-hand side is scaled in the next step (no step reads and
  // writes one element).  Row k of L^-1 is zero right of column k.
  T rinv_prev = (T)0;
  for (int k = 0; k < n; ++k) {
    const T d = s.A[k * n + k];
    if (!(d > (T)0)) return (T)NAN;  // uniform: every thread reads the same pivot
    const T r = sqrt(d);
    const T rinv = (T)1 / r;
    if (tid == 0) s.lgd[k] = log(r);
    if (k > 0)
      for (int j = tid; j < n + k; j += NT) s.W[(k - 1) * w + j] *= rinv_prev;
    for (int i = k + 1 + warp; i < n; i += NW) {
      const T lik = s.A[i * n + k] * rinv;
      for (int j = k + 1 + lane; j <= i; j += 32) s.A[i * n + j] -= lik * (s.A[j * n + k] * rinv);
      for (int j = lane; j < n + k + 1; j += 32) s.W[i * w + j] -= lik * (s.W[k * w + j] * rinv);
    }
    rinv_prev = rinv;
    __syncthreads();
  }
  for (int j = tid; j < 2 * n; j += NT) s.W[(n - 1) * w + j] *= rinv_prev;
  __syncthreads();

  // tr(K^-1 C) = sum_ij (L^-1)_ij (L^-1 C)_ij; partial sums in a fixed
  // assignment, a fixed shuffle tree per warp, the warps added in order by
  // every thread
  T part = (T)0;
  for (int idx = tid; idx < n * n; idx += NT) {
    const int i = idx / n, j = idx - i * n;
    if (j <= i) part += s.W[i * w + j] * s.W[i * w + n + j];
  }
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (lane == 0) s.red[warp] = part;
  __syncthreads();
  T tr = (T)0, logdet = (T)0;
  for (int t = 0; t < NW; ++t) tr += s.red[t];
  for (int i = 0; i < n; ++i) logdet += s.lgd[i];
  return objective(tr, logdet, s.nseg, n, s.profile);
}

// ---------------------------------------------------------------------------
// The wide path: one evaluation on per blocks (the header's panel steps)
// ---------------------------------------------------------------------------

__host__ __device__ inline int wide_tiles(int n) { return (n + P - 1) / P; }

// The task map, shared by the kernel and the plan's cost (wide_eval_ns).
// Columns of row block k that a step's solve takes (right of the diagonal
// tile: K's upper tiles, all of C, I's tiles 0..k; nt - k - 1 + nt + k + 1)
__host__ __device__ inline int wide_solve_cols(int nt) { return 2 * nt * P; }
// column tiles of row block i > k that step k's update takes (i .. 2 nt + k)
__host__ __device__ inline int wide_row_tiles(int nt, int k, int i) { return 2 * nt + k + 1 - i; }
// update tasks of that row, jw column tiles each (the last may take fewer)
__host__ __device__ inline int wide_row_tasks(int nt, int k, int i, int jw) {
  return (wide_row_tiles(nt, k, i) + jw - 1) / jw;
}
// a block's step through the update tasks: task 0 is the first block's,
// the others go to blocks 1 .. per - 1 in turn (all to the one block when
// per = 1)
__host__ __device__ inline int wide_task_stride(int per) { return per == 1 ? 1 : per - 1; }
// the lower tiles whose trace sums the evaluation adds
__host__ __device__ inline int wide_lower_tiles(int nt) { return nt * (nt + 1) / 2; }

// values of one evaluation's scratch: M (Tp x 3 Tp), the sum of each of
// the nt (nt + 1) / 2 lower tiles rounded up to 16 bytes, and the next
// diagonal tile's factor for the other blocks (U, 1 / diag, its flag)
__host__ __device__ inline size_t wide_parts(int n) {
  return ((size_t)wide_lower_tiles(wide_tiles(n)) + 3) & ~(size_t)3;
}
__host__ __device__ inline size_t wide_values(int n) {
  const size_t Tp = (size_t)wide_tiles(n) * P;
  return 3 * Tp * Tp + wide_parts(n) + P * P + P + 4;
}

// the wide kernel's dynamic shared memory: the diagonal tile's U rows
// (P x P), the tile staged for its factorisation, two pairs of operand
// tiles, 1 / diag(L) and log diag(L) of the tile, the warps' partial sums
extern __shared__ __align__(16) unsigned char wide_smem[];
template <typename T>
__device__ __forceinline__ T* sm_fac() { return reinterpret_cast<T*>(wide_smem); }
template <typename T>
__device__ __forceinline__ T* sm_stage() { return sm_fac<T>() + P * P; }
template <typename T>
__device__ __forceinline__ T* sm_opa() { return sm_stage<T>() + P * P; }
// column tiles an update task takes: two in float32 (U_ki read once for
// both), one in float64 (two would not fit shared memory double-buffered)
template <typename T>
__host__ __device__ constexpr int jw() { return sizeof(T) == 4 ? 2 : 1; }
template <typename T>
__device__ __forceinline__ T* sm_opb() { return sm_opa<T>() + 2 * P * P; }
template <typename T>
__device__ __forceinline__ T* sm_rinv() { return sm_opb<T>() + 2 * jw<T>() * P * P; }
template <typename T>
__device__ __forceinline__ T* sm_lg() { return sm_rinv<T>() + P; }
template <typename T>
__device__ __forceinline__ T* sm_red() { return sm_lg<T>() + P; }

template <typename T>
size_t wide_smem_bytes() {
  const size_t b = (size_t)((4 + 2 * jw<T>()) * P * P + 2 * P + NWW) * sizeof(T);
  return b < WIDE_SMEM_MIN ? WIDE_SMEM_MIN : b;
}

// one evaluation's inputs, passed by value (held in registers)
template <typename T>
struct Wide {
  const T* C;      // this latent's T x T statistic
  T* M;            // this evaluation's [K | C | I], Tp x 3 Tp
  T* part;         // the lower tiles' sums
  T* fu;           // the next diagonal tile's U (P x P), 1 / diag(U), flag
  int n, nt, Tp, per, sub;  // T, tiles a side, padded T, blocks an evaluation, this one's index
  T amp, gpn, dt, nseg;
  bool profile;
};

// four consecutive values: device memory through L2 only (other blocks of
// the cluster write them), shared memory plainly
__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void ld4(const double* p, double (&v)[4]) {
  const double2 a = __ldcg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldcg(reinterpret_cast<const double2*>(p + 2));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void st4(double* p, const double (&v)[4]) {
  __stcg(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  __stcg(reinterpret_cast<double2*>(p + 2), make_double2(v[2], v[3]));
}
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void lds4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void sts4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void sts4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// 16 bytes device -> shared memory through L2 only, asynchronously
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// every block of the cluster, its writes to device and shared memory
// visible to all of them after it
__device__ __forceinline__ void wide_sync(cg::cluster_group& cluster) {
  __threadfence();
  cluster.sync();
}

// M's tiles that the factorisation reads: K's upper tiles (the diagonal
// tiles whole), all of C, I's lower tiles; rows dealt to the blocks in
// turn, columns to the threads, C's read four columns a thread ahead of
// their stores
template <typename T>
__device__ __noinline__ void wide_build(const Wide<T> w, T xlog) {
  using R = Rn<T>;
  // the fields in registers: the stores below could alias w otherwise
  const int n = w.n, Tp = w.Tp, ld = 3 * Tp, tid = threadIdx.x, per = w.per;
  T* const M = w.M;
  const T* const C = w.C;
  const T dt = w.dt, amp = w.amp, gpn = w.gpn;
  const T om = exp(xlog);
  const T nom = -om;
  for (int r = w.sub; r < Tp; r += per) {
    const int ti = r / P;
    T* row = M + (size_t)r * ld;
    for (int c = ti * P + tid; c < Tp; c += NTW) {
      T v = (T)(r == c);
      if (r < n && c < n) {
        const T d = R::sub(R::mul((T)r, dt), R::mul((T)c, dt));
        v = R::mul(amp, exp(R::mul(nom, R::mul(d, d))));
        if (r == c) v = R::add(v, gpn);
      }
      __stcg(row + c, v);
    }
    const T* crow = C + (size_t)r * n;
    for (int c0 = 0; c0 < Tp; c0 += 4 * NTW) {
      T v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + q * NTW + tid;
        v[q] = r < n && c < n ? __ldg(crow + c) : (T)0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = c0 + q * NTW + tid;
        if (c < Tp) __stcg(row + Tp + c, v[q]);
      }
    }
    for (int c = tid; c < (ti + 1) * P; c += NTW) __stcg(row + 2 * Tp + c, (T)(r == c));
  }
}

// K's diagonal tile (k, k) factored in leaves of LF columns: thread 0
// factors the leaf's LF x LF block in registers, the threads solve the
// leaf's rows of U to its right (one column a thread) and update the
// trailing upper entries (A[i][j] -= sum over the leaf's rows s of U[s][i]
// U[s][j]); three barriers a leaf.  Each entry takes the unblocked
// right-looking column steps' operations in the same order (A[i][j] =
// fma(-u_i, u_j, A[i][j]) for s ascending, u = A[s][.] / U[s][s]), so the
// factor does not depend on LF, bit for bit.  U's rows (scaled) land in
// fac for the solve, 1 / U[s][s] in rinv; logdet (warp 0) += the tile's
// log-diagonal sum over the real rows.  False when a pivot is not > 0;
// every thread (and every block of the evaluation) sees the same pivots.
constexpr int LF = 8;
template <typename T>
__device__ __noinline__ bool wide_factor(const Wide<T> w, int k, T& logdet) {
  const int ld = 3 * w.Tp, tid = threadIdx.x, n = w.n;
  T* fac = sm_fac<T>();
  T* rinv = sm_rinv<T>();
  T* lg = sm_lg<T>();
  T* a = sm_stage<T>();
  T* flag = sm_red<T>();
  const T* src = w.M + (size_t)k * P * ld + (size_t)k * P;
  for (int e = tid; e < P * P / 4; e += NTW) {
    const int r = e / (P / 4), c = 4 * (e % (P / 4));
    T v[4];
    ld4(src + (size_t)r * ld + c, v);
    sts4(a + r * P + c, v);
  }
  if (tid == 0) flag[0] = (T)1;
  __syncthreads();
  for (int o = 0; o < P; o += LF) {
    if (tid == 0) {
      T m[LF][LF];
      bool good = true;
#pragma unroll
      for (int i = 0; i < LF; ++i)
#pragma unroll
        for (int j = i; j < LF; ++j) m[i][j] = a[(o + i) * P + o + j];
#pragma unroll
      for (int s = 0; s < LF; ++s) {
        const T d = m[s][s];
        good = good && d > (T)0;
        const T rt = sqrt(d);
        const T ri = (T)1 / rt;
        rinv[o + s] = ri;
        lg[o + s] = rt;
        T u[LF];
#pragma unroll
        for (int j = s + 1; j < LF; ++j) {
          u[j] = m[s][j] * ri;
          fac[(o + s) * P + o + j] = u[j];
        }
#pragma unroll
        for (int i = s + 1; i < LF; ++i)
#pragma unroll
          for (int j = i; j < LF; ++j) m[i][j] = fma(-u[i], u[j], m[i][j]);
      }
      if (!good) flag[0] = (T)0;
    }
    __syncthreads();
    // the leaf's rows of U right of it: column j, x_s = v_s / U[s][s],
    // then v_r -= U[s][r] x_s
    for (int j = o + LF + tid; j < P; j += NTW) {
      T v[LF];
#pragma unroll
      for (int r = 0; r < LF; ++r) v[r] = a[(o + r) * P + j];
#pragma unroll
      for (int s = 0; s < LF; ++s) {
        const T xs = v[s] * rinv[o + s];
        fac[(o + s) * P + j] = xs;
#pragma unroll
        for (int r = s + 1; r < LF; ++r) v[r] = fma(-fac[(o + s) * P + o + r], xs, v[r]);
      }
    }
    __syncthreads();
    // the trailing upper entries (i, j), o + LF <= i <= j, in place
    const int n1 = P - o - LF;
    for (int e = tid; e < n1 * n1; e += NTW) {
      const int i = o + LF + e / n1, j = o + LF + e % n1;
      if (i > j) continue;
      T v = a[i * P + j];
#pragma unroll
      for (int s = 0; s < LF; ++s) v = fma(-fac[(o + s) * P + i], fac[(o + s) * P + j], v);
      a[i * P + j] = v;
    }
    __syncthreads();
  }
  if (flag[0] == (T)0) return false;
  if (tid < P) lg[tid] = log(lg[tid]);
  __syncthreads();
  if (tid < 32) {
    const int r0 = k * P + tid;
    T v = (r0 < n ? lg[tid] : (T)0) + (r0 + 32 < n ? lg[tid + 32] : (T)0);
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    logdet += v;
  }
  return true;
}

// row block k's columns right of the diagonal tile, (k + 1) P .. (2 nt + k
// + 1) P, each solved in place by forward substitution with the factored
// tile, one column a thread: x_s = v_s / L_ss, then v_r -= L_rs x_s
template <typename T>
__device__ __noinline__ void wide_solve(const Wide<T> w, int k) {
  const int ld = 3 * w.Tp, ncol = wide_solve_cols(w.nt), stride = w.per * NTW;
  const T* U = sm_fac<T>();
  const T* rinv = sm_rinv<T>();
  T* const base = w.M + (size_t)k * P * ld + (size_t)(k + 1) * P;
  for (int u = w.sub * NTW + (int)threadIdx.x; u < ncol; u += stride) {
    T* col = base + u;
    T v[P];
#pragma unroll
    for (int r = 0; r < P; ++r) v[r] = __ldcg(col + (size_t)r * ld);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const T xs = v[s] * rinv[s];
      v[s] = xs;
#pragma unroll
      for (int q = (s + 1) / 4; q < P / 4; ++q) {
        T u4[4];
        lds4(U + s * P + 4 * q, u4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e > s) v[4 * q + e] = fma(-u4[e], xs, v[4 * q + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < P; ++r) __stcg(col + (size_t)r * ld, v[r]);
  }
}

// the trailing update of step k: task q (row block i > k, column tiles j
// .. j + JW - 1 of i .. 2 nt + k, row by row; the row's last task may take
// fewer), M[i][j] -= U_ki^T M[k][j].  Task 0 holds the next diagonal tile
// (k + 1, k + 1): the evaluation's first block runs it and then factors
// that tile (wide_factor), publishing U and 1 / diag(U) in fu for the
// other blocks, so the next step's solve does not wait for a factor; the
// other tasks go to the other blocks in turn (all to the one block when
// per = 1).  Returns the factor's verdict (true on the other blocks).
template <typename T>
__device__ __noinline__ bool wide_update(const Wide<T> w, int k, T& logdet) {
  constexpr int JW = jw<T>();
  const int nt = w.nt, ld = 3 * w.Tp, tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int per = w.per, sub = w.sub;
  T* const M = w.M;
  T* const fu = w.fu;
  const T* rowk = M + (size_t)k * P * ld;
  T* opa = sm_opa<T>();
  T* opb = sm_opb<T>();
  // task t: row block ti, first column tile tj, tiles nj
  auto task = [&](int t, int& ti, int& tj, int& nj) {
    for (ti = k + 1; ti < nt; ++ti) {
      const int count = wide_row_tiles(nt, k, ti), tasks = wide_row_tasks(nt, k, ti, JW);
      if (t < tasks) {
        tj = ti + JW * t;
        nj = count - JW * t < JW ? count - JW * t : JW;
        return true;
      }
      t -= tasks;
    }
    return false;
  };
  // the operand tiles U_ki and M[k][j..] into buffer b, one commit group
  auto fetch = [&](int buf, int ti, int tj, int nj) {
    constexpr int CH = 16 / sizeof(T);
    T* ua = opa + buf * P * P;
    T* ub = opb + buf * JW * P * P;
    for (int e = tid; e < P * P / CH; e += NTW) {
      const int r = e / (P / CH), c = CH * (e % (P / CH));
      const T* src = rowk + (size_t)r * ld + c;
      cp16(ua + r * P + c, src + (size_t)ti * P);
      for (int jj = 0; jj < nj; ++jj) cp16(ub + jj * P * P + r * P + c, src + (size_t)(tj + jj) * P);
    }
    asm volatile("cp.async.commit_group;" ::);
  };
  const int stride = wide_task_stride(per);
  const bool first_only = sub == 0 && per > 1;
  bool good = true;
  int q = sub, i, j, nj, b = 0;
  bool has = task(q, i, j, nj);
  if (has) fetch(0, i, j, nj);
  while (has) {
    int i2, j2, nj2;
    const bool next = !first_only && task(q + stride, i2, j2, nj2);
    if (next) {
      fetch(b ^ 1, i2, j2, nj2);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    T* out = M + (size_t)(i * P + 4 * ty) * ld + (size_t)j * P + 4 * tx;
    T old[JW][4][4], acc[JW][4][4];
#pragma unroll
    for (int jj = 0; jj < JW; ++jj)
      if (jj < nj)
#pragma unroll
        for (int r = 0; r < 4; ++r) ld4(out + (size_t)r * ld + jj * P, old[jj][r]);
#pragma unroll
    for (int jj = 0; jj < JW; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[jj][r][c] = (T)0;
    const T* ua = opa + b * P * P + 4 * ty;
    const T* ub = opb + b * JW * P * P + 4 * tx;
#pragma unroll 8
    for (int m = 0; m < P; ++m) {
      T x[4];
      lds4(ua + m * P, x);
#pragma unroll
      for (int jj = 0; jj < JW; ++jj) {
        T y[4];
        lds4(ub + jj * P * P + m * P, y);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[jj][r][c] = fma(x[r], y[c], acc[jj][r][c]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < JW; ++jj) {
      if (jj >= nj) break;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        T o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = old[jj][r][c] - acc[jj][r][c];
        st4(out + (size_t)r * ld + jj * P, o);
      }
    }
    __syncthreads();  // buffer b is free for the task after next
    if (q == 0) {  // the next diagonal tile is final: factor it
      good = wide_factor(w, k + 1, logdet);
      if (per > 1) {
        const T* fac = sm_fac<T>();
        const T* rinv = sm_rinv<T>();
        for (int e = tid; e < P * P / 4; e += NTW) {
          T v[4];
          lds4(fac + 4 * e, v);
          st4(fu + 4 * e, v);
        }
        if (tid < P) __stcg(fu + P * P + tid, rinv[tid]);
        if (tid == 0) __stcg(fu + P * P + P, good ? (T)1 : (T)0);
      }
    }
    q += stride;
    i = i2;
    j = j2;
    nj = nj2;
    has = next;
    b ^= 1;
  }
  return good;
}

// the factor of diagonal tile k (k >= 1) that the first block published at
// step k - 1, into this block's shared memory; false when it failed
template <typename T>
__device__ __noinline__ bool wide_take_factor(const Wide<T> w) {
  T* fac = sm_fac<T>();
  T* rinv = sm_rinv<T>();
  const T* const fu = w.fu;
  const int tid = threadIdx.x;
  for (int e = tid; e < P * P / 4; e += NTW) {
    T v[4];
    ld4(fu + 4 * e, v);
    sts4(fac + 4 * e, v);
  }
  if (tid < P) rinv[tid] = __ldcg(fu + P * P + tid);
  const bool good = __ldcg(fu + P * P + P) != (T)0;
  __syncthreads();
  return good;
}

// each lower tile (i, j <= i) of L^-1 (.) L^-1 C summed (thread t: row t / 4,
// 16 columns from 16 (t mod 4)), tile t on block t mod per
template <typename T>
__device__ __noinline__ void wide_partials(const Wide<T> w) {
  const int Tp = w.Tp, ld = 3 * Tp, nt = w.nt, per = w.per, sub = w.sub;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid >> 2, c0 = 16 * (tid & 3);
  const T* const M = w.M;
  T* const part = w.part;
  T* red = sm_red<T>();
  int t = 0;
  for (int i = 0; i < nt; ++i) {
    for (int j = 0; j <= i; ++j, ++t) {
      if (t % per != sub) continue;
      const T* y = M + (size_t)(i * P + r) * ld + Tp + (size_t)j * P + c0;
      const T* l = y + Tp;
      T s = (T)0;
#pragma unroll
      for (int c = 0; c < 16; c += 4) {
        T a[4], b[4];
        ld4(l + c, a);
        ld4(y + c, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) s = fma(a[e], b[e], s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) red[warp] = s;
      __syncthreads();
      if (tid == 0) {
        T sum = (T)0;
        for (int q = 0; q < NWW; ++q) sum += red[q];
        __stcg(part + t, sum);
      }
      __syncthreads();
    }
  }
}

// the objective -ll at log(omega) = xlog, evaluated by this block's group
// of per blocks when active; every block of the cluster calls it for every
// evaluation (idle ones pass active = false), since each of its 2 nt + 1
// cluster barriers takes all of them.  The value holds in warp 0 of the
// group's first block (sub 0), NaN elsewhere.  Not inlined: the search
// calls it from six places.
template <typename T>
__device__ __noinline__ T evaluate_wide(const Wide<T>& wr, cg::cluster_group& cluster,
                                        bool active, T xlog) {
  const Wide<T> w = wr;
  bool ok = active;
  T logdet = (T)0;
  if (ok) wide_build(w, xlog);
  wide_sync(cluster);
  bool next_ok = true;  // the first block's verdict on the next diagonal tile
  for (int k = 0; k < w.nt; ++k) {
    if (ok) {
      // the diagonal tile's factor: every block's own at k = 0, then the
      // first block's from the update before (the others read it)
      if (k == 0)
        ok = wide_factor(w, 0, logdet);
      else
        ok = w.sub == 0 ? next_ok : wide_take_factor(w);
      if (ok) wide_solve(w, k);
    }
    wide_sync(cluster);
    if (k + 1 < w.nt) {
      if (ok) next_ok = wide_update(w, k, logdet);
      wide_sync(cluster);
    }
  }
  if (ok) wide_partials(w);
  wide_sync(cluster);
  if (!ok || w.sub != 0) return (T)NAN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntl = wide_lower_tiles(w.nt);
  T* red = sm_red<T>();
  T v = (T)0;
  for (int q = tid; q < ntl; q += NTW) v += __ldcg(w.part + q);
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // the last tile's readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T tr = (T)0;
  for (int q = 0; q < NWW; ++q) tr += red[q];
  return objective(tr, logdet, w.nseg, w.n, w.profile);
}

// ---------------------------------------------------------------------------
// The search, shared by both kernels
// ---------------------------------------------------------------------------

// one golden-section shrink of _golden_min's loop with its comparison
// `left` (fc < fd) given: the bracket moves and the point the shrink
// evaluates is returned, each value rounded as the chain rounds it
template <typename T>
__device__ __forceinline__ T shrink(T& lo, T& hi, T& c, T& d, bool left) {
  using R = Rn<T>;
  const T phi = (T)0.6180339887498949;
  const T lo_n = left ? lo : c;
  const T hi_n = left ? d : hi;
  const T c_n = left ? R::sub(hi_n, R::mul(phi, R::sub(hi_n, lo_n))) : d;
  const T d_n = left ? c : R::add(lo_n, R::mul(phi, R::sub(hi_n, lo_n)));
  lo = lo_n;
  hi = hi_n;
  c = c_n;
  d = d_n;
  return left ? c_n : d_n;
}

// fc, fd after a shrink whose point gave f_new
template <typename T>
__device__ __forceinline__ void take(T& fc, T& fd, bool left, T f_new) {
  const T fc_n = left ? f_new : fd;
  const T fd_n = left ? fc : f_new;
  fc = fc_n;
  fd = fd_n;
}

// the grid's candidate i: NaN (a failed evaluation), and its objective with
// NaN counted as +inf
template <typename T>
__device__ __forceinline__ bool is_nan(const T* f, int i) {
  return f[i] != f[i];
}
template <typename T>
__device__ __forceinline__ T inf_nan(const T* f, int i) {
  return is_nan(f, i) ? (T)INFINITY : f[i];
}

__host__ __device__ inline int ilog2(int x) {
  int l = 0;
  while (x >>= 1) ++l;
  return l;
}

// rounds of a search with np points a round (the header's schedule)
__host__ __device__ inline int rounds(int np, int grid, int iters, int polish) {
  int r = grid >= 3 ? (grid + np - 1) / np : 0;
  int rem = iters;
  if (np == 1) {
    r += 2;
  } else {
    const int m = ilog2(np) - 1 < rem ? ilog2(np) - 1 : rem;
    r += 1;
    rem -= m;
  }
  const int depth = ilog2(np + 1);
  return r + (rem + depth - 1) / depth + (polish ? 1 : 0);
}

// A point evaluated by one block in its shared memory
template <typename T>
struct SmemPoint {
  static constexpr bool kWide = false;
  const Search<T>& s;
  cg::cluster_group& cluster;
  int nb;
  // evaluate x when active and write its objective into slot i of every
  // block's array a; the round's cluster.sync() makes it visible
  __device__ void run(bool active, T x, T* a, int i) {
    if (!active) return;
    const T f = evaluate(s, x);
    if ((int)threadIdx.x < nb) *cluster.map_shared_rank(a + i, threadIdx.x) = f;
  }
  __device__ T own(bool, T x) { return evaluate(s, x); }
};

// A point evaluated by a group of per blocks (the wide path)
template <typename T>
struct WidePoint {
  static constexpr bool kWide = true;
  const Wide<T>& w;
  cg::cluster_group& cluster;
  int nb;
  __device__ void run(bool active, T x, T* a, int i) {
    const T f = evaluate_wide(w, cluster, active, x);
    if (active && w.sub == 0 && (int)threadIdx.x < nb) *cluster.map_shared_rank(a + i, threadIdx.x) = f;
  }
  __device__ T own(bool active, T x) { return evaluate_wide(w, cluster, active, x); }
};

// The search of latent z on its cluster: np points a round, this block's
// slot; thread 0 of the cluster's first block writes x.  A round writes
// the ftree parity its readers of two rounds before have finished with.
template <typename T, class Point>
__device__ void search(Point& pt, cg::cluster_group& cluster, T* fgrid, T (*ftree)[NB_MAX], T lo,
                       T hi, int np, int slot, int iters, int polish, int grid, double tiebreak,
                       T* x_out) {
  using R = Rn<T>;
  if (grid >= 3) {
    const T span = R::sub(hi, lo);
    const T last = (T)(grid - 1);
    for (int i0 = 0; i0 < grid; i0 += np) {
      const int i = i0 + slot;
      pt.run(i < grid, R::add(lo, R::mul((T)i / last, span)), fgrid, i);
    }
    cluster.sync();
    T fmin = (T)INFINITY;
    for (int i = 0; i < grid; ++i) fmin = inf_nan(fgrid, i) < fmin ? inf_nan(fgrid, i) : fmin;
    const T thr = R::add(fmin, R::mul((T)tiebreak, fabs(fmin)));
    int best = 0;
    while (best < grid - 1 && !(inf_nan(fgrid, best) <= thr)) ++best;
    if (!(inf_nan(fgrid, best) <= thr)) best = 0;
    int lo_i = best > 0 ? best - 1 : 0;
    if (is_nan(fgrid, lo_i)) lo_i = best;
    int hi_i = best + 1 < grid ? best + 1 : grid - 1;
    if (is_nan(fgrid, hi_i)) hi_i = best;
    bool allbad = true;
    for (int i = 0; i < grid; ++i) allbad = allbad && is_nan(fgrid, i);
    const T lo_b = R::add(lo, R::mul((T)lo_i / last, span));
    const T hi_b = R::add(lo, R::mul((T)hi_i / last, span));
    hi = allbad ? lo : hi_b;
    lo = allbad ? lo : lo_b;
  }
  const T phi = (T)0.6180339887498949;
  T c = R::sub(hi, R::mul(phi, R::sub(hi, lo)));
  T d = R::add(lo, R::mul(phi, R::sub(hi, lo)));
  T fc, fd;
  int rem = iters, round = 0;
  if (np == 1) {
    if constexpr (Point::kWide) {  // the group's first block holds the value: exchange it
      pt.run(true, c, ftree[0], 0);
      pt.run(true, d, ftree[0], 1);
      cluster.sync();
      fc = ftree[0][0];
      fd = ftree[0][1];
      ++round;
    } else {
      fc = pt.own(true, c);
      fd = pt.own(true, d);
    }
  } else {
    // c, d and the first m shrinks: slot 0 c, 1 d, node k >= 2 the point
    // of level ilog2(k) - 1 whose comparisons are k's bits below its
    // leading one, most significant first (1: fc < fd)
    const int m = ilog2(np) - 1 < rem ? ilog2(np) - 1 : rem;
    T* ft = ftree[round & 1];
    const bool active = slot < (2 << m);
    T x = slot == 0 ? c : d;
    if (active && slot >= 2) {
      T l2 = lo, h2 = hi, c2 = c, d2 = d;
      const int j = ilog2(slot) - 1;
      for (int l = 0; l <= j; ++l) x = shrink(l2, h2, c2, d2, (slot >> (j - l)) & 1);
    }
    pt.run(active, x, ft, slot);
    cluster.sync();
    fc = ft[0];
    fd = ft[1];
    for (int l = 0, node = 1; l < m; ++l) {
      const bool left = fc < fd;
      shrink(lo, hi, c, d, left);
      node = 2 * node + left;
      take(fc, fd, left, ft[node]);
    }
    rem -= m;
    ++round;
  }
  // the next m shrinks: node k >= 1 (slot k - 1) the point of level
  // ilog2(k), its first comparison the known fc < fd and the others k's
  // bits below its leading one
  const int depth = ilog2(np + 1);
  while (rem > 0) {
    const int m = depth < rem ? depth : rem;
    T* ft = ftree[round & 1];
    const bool active = slot < (1 << m) - 1;
    T x = lo;
    if (active) {
      const int node = slot + 1, j = ilog2(node);
      T l2 = lo, h2 = hi, c2 = c, d2 = d;
      x = shrink(l2, h2, c2, d2, fc < fd);
      for (int l = 1; l <= j; ++l) x = shrink(l2, h2, c2, d2, (node >> (j - l)) & 1);
    }
    pt.run(active, x, ft, slot);
    cluster.sync();
    for (int l = 0, node = 1; l < m; ++l) {
      const bool left = fc < fd;
      shrink(lo, hi, c, d, left);
      if (l > 0) node = 2 * node + left;
      take(fc, fd, left, ft[node - 1]);
    }
    rem -= m;
    ++round;
  }
  const T mid = R::mul((T)0.5, R::add(lo, hi));
  T out = mid;
  if (polish) {  // in shared memory every block evaluates the mid itself; on
                 // the wide path slot 0's group, whose first block writes x
    const T fm = pt.own(slot == 0, mid);
    const T mc = R::sub(mid, c), md = R::sub(mid, d);
    const T gd = R::sub(fm, fd), gc = R::sub(fm, fc);
    const T num = R::sub(R::mul(R::mul(mc, mc), gd), R::mul(R::mul(md, md), gc));
    const T den = R::sub(R::mul(mc, gd), R::mul(md, gc));
    const bool safe = fabs(den) > (T)1e-30;
    const T x_star = R::sub(mid, R::mul((T)0.5, safe ? num / den : (T)0));
    out = safe && x_star > lo && x_star < hi ? x_star : mid;
  }
  if (x_out != nullptr && threadIdx.x == 0) *x_out = out;
}

template <typename T>
__global__ void __launch_bounds__(NT) hstep_search_kernel(
    const T* __restrict__ C, const T* __restrict__ nseg_p, const T* __restrict__ sigsq,
    const T* __restrict__ lo_in, const T* __restrict__ hi_in, T* __restrict__ xout, int n,
    double gp_noise, double dt, int profile, int iters, int polish, int grid, double tiebreak) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T fgrid[GRID_MAX];   // the grid's objectives, NaN kept
  __shared__ T ftree[2][NB_MAX];  // a golden round's objectives, by the round's parity
  __shared__ T red[NW];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int z = blockIdx.x / nb;
  T* buf = reinterpret_cast<T*>(smem_raw);
  Search<T> s;
  s.C = C + (size_t)z * n * n;
  s.A = buf;
  s.W = buf + (size_t)n * n;
  s.lgd = buf + 3 * (size_t)n * n;
  s.red = red;
  s.n = n;
  s.amp = profile ? (T)1 : sigsq[z];
  s.gpn = (T)gp_noise;
  s.dt = (T)dt;
  s.nseg = nseg_p[0];
  s.profile = profile != 0;
  cluster.sync();  // every block has started before any writes into its shared memory
  SmemPoint<T> pt{s, cluster, nb};
  search(pt, cluster, fgrid, ftree, lo_in[z], hi_in[z], nb, rank, iters, polish, grid, tiebreak,
         rank == 0 ? xout + z : nullptr);
}

// the wide path: the cluster's np = nb / per groups of per blocks each
// evaluate one point of a round; scratch holds Z np evaluations
template <typename T>
__global__ void __launch_bounds__(NTW, 1) hstep_search_wide_kernel(
    const T* __restrict__ C, const T* __restrict__ nseg_p, const T* __restrict__ sigsq,
    const T* __restrict__ lo_in, const T* __restrict__ hi_in, T* __restrict__ xout,
    T* __restrict__ scratch, int n, double gp_noise, double dt, int profile, int iters,
    int polish, int grid, double tiebreak, int per) {
  __shared__ T fgrid[GRID_MAX];
  __shared__ T ftree[2][NB_MAX];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int z = blockIdx.x / nb, np = nb / per, slot = rank / per;
  Wide<T> w;
  w.C = C + (size_t)z * n * n;
  w.M = scratch + ((size_t)z * np + slot) * wide_values(n);
  w.nt = wide_tiles(n);
  w.Tp = w.nt * P;
  w.part = w.M + 3 * (size_t)w.Tp * w.Tp;
  w.fu = w.part + wide_parts(n);
  w.n = n;
  w.per = per;
  w.sub = rank - slot * per;
  w.amp = profile ? (T)1 : sigsq[z];
  w.gpn = (T)gp_noise;
  w.dt = (T)dt;
  w.nseg = nseg_p[0];
  w.profile = profile != 0;
  cluster.sync();  // every block has started before any writes into its shared memory
  WidePoint<T> pt{w, cluster, nb};
  search(pt, cluster, fgrid, ftree, lo_in[z], hi_in[z], np, slot, iters, polish, grid, tiebreak,
         rank == 0 ? xout + z : nullptr);
}

// the shared-memory path holds a block's buffers (3 n^2 + n values) with
// the static arrays (objectives, partial sums) beside them; every larger n
// takes the wide path
bool is_wide(int n, size_t elem) {
  const size_t static_bytes = (GRID_MAX + 2 * NB_MAX + NW) * elem;
  return (size_t)per_latent(n) * elem + static_bytes > (size_t)SMEM_MAX;
}

template <typename T>
size_t smem_bytes(int n) {
  return is_wide(n, sizeof(T)) ? wide_smem_bytes<T>() : per_latent(n) * sizeof(T);
}

template <typename T>
cudaError_t configure(int n, int nb) {
  const void* fn = is_wide(n, sizeof(T)) ? (const void*)hstep_search_wide_kernel<T>
                                         : (const void*)hstep_search_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<T>(n));
  if (err == cudaSuccess && nb > 8)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Z clusters of nb blocks
template <typename T>
inline cudaLaunchConfig_t launch_config(int n, int Z, int nb, cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Z * nb));
  cfg.blockDim = dim3(is_wide(n, sizeof(T)) ? NTW : NT);
  cfg.dynamicSmemBytes = smem_bytes<T>(n);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of nb blocks resident at once on the current device (0: none
// fits), or -error
template <typename T>
int resident(int n, int nb) {
  cudaError_t err = configure<T>(n, nb);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T>(n, 1, nb, 0, attr);
  int count = 0;
  err = is_wide(n, sizeof(T))
            ? cudaOccupancyMaxActiveClusters(&count, hstep_search_wide_kernel<T>, &cfg)
            : cudaOccupancyMaxActiveClusters(&count, hstep_search_kernel<T>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// The modelled time (ns) of one wide evaluation at T = n on per blocks:
// each phase's tasks dealt to the blocks as the kernel deals them (the
// task map above), the slowest block's share times a task's time, plus a
// cluster barrier a phase; the first block's task 0 and factor of the next
// diagonal tile beside the other blocks' update tasks.  The task times are
// clock64 readings of the first block on an H100 at T1000 float32, 16
// blocks an evaluation, taken while the kernel was designed; float64 tasks
// count twice.  They rank the plans and nothing else: the plan is checked
// against every plan's measured time by tools/torch_kernel_ab.py --hstep
// (PERF.md).
template <typename T>
double wide_eval_ns(int n, int per) {
  const double E_BUILD = 138.0;    // a row of M, a thread's 256 columns
  const double E_FACTOR = 14000.0; // the diagonal tile's factor
  const double E_TAKE = 2000.0;    // reading the published factor
  const double E_SOLVE = 6000.0;   // a thread's column substitution
  const double E_TILE = 2600.0;    // one 64 x 64 x 64 update tile
  const double E_PART = 2200.0;    // one tile's trace sum
  const double E_SYNC = 1500.0;    // a cluster barrier with its fence
  const double f = sizeof(T) == 8 ? 2.0 : 1.0;
  const int nt = wide_tiles(n), Tp = nt * P, JW = jw<T>(), stride = wide_task_stride(per);
  auto up = [](long a, long b) { return (double)((a + b - 1) / b); };
  double t = up(Tp, per) * up(3 * Tp, NTW) * E_BUILD + E_SYNC;
  for (int k = 0; k < nt; ++k) {
    t += (k == 0 ? f * E_FACTOR : E_TAKE) +
         up(wide_solve_cols(nt), (long)per * NTW) * f * E_SOLVE + E_SYNC;
    if (k + 1 < nt) {
      long tasks = 0;
      for (int i = k + 1; i < nt; ++i) tasks += wide_row_tasks(nt, k, i, JW);
      const double task = f * E_TILE * JW, lead = task + f * E_FACTOR;
      const double rest = up(tasks - 1, stride) * task;
      t += (per == 1 ? lead + rest : (lead > rest ? lead : rest)) + E_SYNC;
    }
  }
  return t + up(wide_lower_tiles(nt), per) * E_PART + E_SYNC;
}

// the plan at T = n for Z latents: nb, and per (blocks an evaluation) in
// *per; 0 when no size is resident, or -error
template <typename T>
int choose(int n, int Z, int grid, int iters, int polish, int* per_out) {
  *per_out = 1;
  if (!is_wide(n, sizeof(T))) {
    int best = 0;
    long long best_cost = LLONG_MAX;
    for (int nb = NB_MAX; nb >= 1; nb /= 2) {
      const int nc = resident<T>(n, nb);
      if (nc < 0) return nc;
      if (nc == 0) continue;
      const long long cost = (long long)rounds(nb, grid, iters, polish) * ((Z + nc - 1) / nc);
      if (cost < best_cost) {
        best_cost = cost;
        best = nb;
      }
    }
    return best;
  }
  int best = 0;
  double best_cost = 0.0;
  for (int nb = NB_MAX; nb >= 1; nb /= 2) {
    const int nc = resident<T>(n, nb);
    if (nc < 0) return nc;
    if (nc == 0) continue;
    for (int per = nb; per >= 1; per /= 2) {
      const int np = nb / per;
      if ((size_t)Z * np * wide_values(n) * sizeof(T) > SCRATCH_CAP) continue;
      const double cost = rounds(np, grid, iters, polish) * (double)((Z + nc - 1) / nc) *
                          wide_eval_ns<T>(n, per);
      if (best == 0 || cost < best_cost) {
        best_cost = cost;
        best = nb;
        *per_out = per;
      }
    }
  }
  return best;
}

template <typename T>
cudaError_t launch(const T* C, const T* nseg, const T* sigsq, const T* lo, const T* hi, T* x,
                   T* scratch, int Z, int n, double gp_noise, double dt, int profile, int iters,
                   int polish, int grid, double tiebreak, int nb, int per, cudaStream_t st) {
  cudaError_t err = configure<T>(n, nb);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<T>(n, Z, nb, st, attr);
  if (is_wide(n, sizeof(T)))
    err = cudaLaunchKernelEx(&cfg, hstep_search_wide_kernel<T>, C, nseg, sigsq, lo, hi, x,
                             scratch, n, gp_noise, dt, profile, iters, polish, grid, tiebreak,
                             per);
  else
    err = cudaLaunchKernelEx(&cfg, hstep_search_kernel<T>, C, nseg, sigsq, lo, hi, x, n,
                             gp_noise, dt, profile, iters, polish, grid, tiebreak);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Values of global scratch per evaluation that the search at T = n needs:
// 0 on the shared-memory path, else the wide path's M and tile sums (-1
// beyond an int).
int hstep_search_scratch(int n, int is_double) {
  if (n < 1 || !is_wide(n, is_double ? sizeof(double) : sizeof(float))) return 0;
  return wide_values(n) > (size_t)INT_MAX ? -1 : (int)wide_values(n);
}

// The plan for Z latents at T = n on the current device (the header's
// rule): returns nb, 1 <= nb <= 16, and writes the blocks per evaluation
// into *per (1 on the shared-memory path); 0 when no size is resident, or
// -error.
int hstep_search_cluster(int n, int is_double, int Z, int grid, int iters, int polish, int* per) {
  *per = 1;
  if (Z < 1 || n < 1 || grid < 0 || grid > GRID_MAX || iters < 0) return 0;
  return is_double ? choose<double>(n, Z, grid, iters, polish, per)
                   : choose<float>(n, Z, grid, iters, polish, per);
}

// Clusters of nb blocks the current device holds at once at T = n (0:
// none), or -error.
int hstep_search_resident(int n, int is_double, int nb) {
  if (n < 1 || nb < 1 || nb > NB_MAX) return 0;
  return is_double ? resident<double>(n, nb) : resident<float>(n, nb);
}

// Rounds of one search with np points a round (np = nb / per).
int hstep_search_rounds(int np, int grid, int iters, int polish) {
  if (np < 1 || np > NB_MAX || iters < 0) return 0;
  return rounds(np, grid, iters, polish);
}

// C (Z, n, n), sigsq, lo, hi and x (Z,), nseg one value, all contiguous,
// float64 when is_double else float32; scratch NULL, or Z (nb / per) times
// the values hstep_search_scratch gives.  0 <= grid <= GRID_MAX (a grid
// below 3 is off); 1 <= nb <= 16 blocks per latent and per blocks an
// evaluation, per dividing nb (1 on the shared-memory path), as
// hstep_search_cluster plans; every plan gives the same x (nb = 1 runs the
// chain of single evaluations).
int hstep_search(const void* C, const void* nseg, const void* sigsq, const void* lo,
                 const void* hi, void* x, void* scratch, int Z, int n, double gp_noise, double dt,
                 int profile, int iters, int polish, int grid, double tiebreak, int is_double,
                 int nb, int per, void* stream) {
  if (Z < 1 || n < 1 || iters < 0 || grid < 0 || grid > GRID_MAX || nb < 1 || nb > NB_MAX ||
      per < 1 || nb % per != 0)
    return (int)cudaErrorInvalidValue;
  const bool wide = hstep_search_scratch(n, is_double) != 0;
  if (wide != (scratch != nullptr) || (!wide && per != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch((const double*)C, (const double*)nseg, (const double*)sigsq,
                       (const double*)lo, (const double*)hi, (double*)x, (double*)scratch, Z, n,
                       gp_noise, dt, profile, iters, polish, grid, tiebreak, nb, per, st);
  return (int)launch((const float*)C, (const float*)nseg, (const float*)sigsq, (const float*)lo,
                     (const float*)hi, (float*)x, (float*)scratch, Z, n, gp_noise, dt, profile,
                     iters, polish, grid, tiebreak, nb, per, st);
}

}  // extern "C"
