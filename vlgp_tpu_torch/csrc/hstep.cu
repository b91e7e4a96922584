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
// The search runs in rounds; in a round every block of the cluster
// evaluates at most one point in its own shared memory, writes the
// objective into every block's shared memory (distributed shared memory,
// cluster.map_shared_rank), and after cluster.sync() every block walks the
// search with the same values, so all take the same path:
//
//   grid round(s): candidate i on block i mod nb, ceil(grid / nb) rounds;
//   first golden round: c and d, and every point the next m shrinks can
//       reach, 2 + 2 + 4 + ... + 2^m = 2^(m+1) <= nb points (m = 3 at nb
//       16): the shrink's comparison fc < fd is not known yet, so each
//       level holds both outcomes;
//   later rounds: a shrink's comparison is known from the round before, so
//       the next m shrinks can reach 1 + 2 + ... + 2^(m-1) = 2^m - 1 <= nb
//       points (m = 4 at nb 16), the tree in heap order, node k's children
//       2k (fc >= fd) and 2k + 1 (fc < fd); a short last level and any
//       block beyond the tree idle through the round;
//   polish: the final bracket's mid, one more round, every block
//       evaluating it itself.
//
// A point on the path is formed by the same rounded operations from the
// same values as in a chain of single evaluations, and evaluate is the
// same code, so x does not depend on nb: nb = 1 (a cluster of one, no
// look-ahead) is the one-block chain, bit for bit.  At the default Config
// (grid 13, iters 24, no polish) a search is 8 rounds at nb 16
// (1 grid, 1 first, 6 of depth 4: 3 + 4 x 5 + 1 = 24 shrinks), 11 at nb 8
// and 39 at nb 1.
//
// Each evaluation is gp_elbo_stats (vlgp_tpu_torch/models/gp.py) of the
// statistic C[z] (T x T):
//
//   K = amp exp(-omega dsq) + gp_noise I (amp = 1 with profile_sigma,
//       sigma^2 else), dsq[i, j] = (i dt - j dt)^2;
//   L = chol(K), right-looking, one barrier per column step, with the
//       forward elimination of [C | I] in the same steps, so that after
//       the last one the right-hand side holds [L^-1 C | L^-1]; a pivot
//       that is not > 0 (or NaN) makes the objective NaN, as cholesky_ex's
//       info > 0 does;
//   tr = tr(K^-1 C) = sum_ij (L^-1)_ij (L^-1 C)_ij, logdet = sum log
//       diag(L), each added in a fixed order and read by every thread (so
//       all hold the same bits);
//   f = 0.5 tr + nseg logdet, or with profile_sigma s = clip(tr / (nseg
//       T), 1e-2, 1e2) and f = 0.5 tr / s + nseg (0.5 T log s + logdet).
//
// K, [C | I] and log diag(L) live in each block's shared memory (3 T^2 + T
// values: T <= 138 in float32, T <= 97 in float64); a larger T puts them
// in global scratch given by the wrapper, Z nb (3 T^2 + T) values, one
// share per block of each cluster (T1000 float32: 12.0 MB a block).
//
// The cluster size.  hstep_search_cluster picks nb in {16, 8, 4, 2, 1}
// from the shape and the card alone: for each size that
// cudaOccupancyMaxActiveClusters finds resident (and, on the scratch path,
// whose scratch stays within SCRATCH_CAP bytes), the cost rounds(nb) x
// ceil(Z / resident clusters); the least cost wins, a tie going to the
// larger nb.  16 is the largest (non-portable) cluster on Hopper; a
// cluster's blocks share one GPC (16-18 SMs on an H100), but a block of
// 512 threads and 30 KB (the flagship's T50) leaves room for four on an
// SM, so the card holds many clusters of 16 at once, and at Z > 8 the
// clusters that do not fit wait for a free GPC (one more wave of rounds),
// which the cost counts.
//
// What bounds it on this card: the chain.  An evaluation is T dependent
// column steps, one barrier each, with ~3 T^2 / 2 FMAs per step spread
// over the block; the ~5 T^3 / 6 = 104k FMAs of a T50 evaluation are
// nothing to the card.  A chain of single evaluations (nb = 1) runs the
// grid + 2 + iters (+ 1 with polish) of them one after another: 39 at the
// flagship (T50, grid 13, iters 24), ~0.9 us a step, 1.80 ms a search on
// an H100 (1.77 in the earlier one-block kernel).  The cluster cuts the
// chain to 8 rounds, 0.383 ms (~48 us a round: the cluster's barrier and
// exchange add ~2 us to an evaluation), with 5 clusters of 16 on 80 SMs.
// At T1000 (window=None) an evaluation is 1,000 dependent steps over 12
// MB of global scratch a block, ~0.34 s alone; the 80 of a round share L2
// and device memory and take ~1.0 s: 7.9 s a search against the chain's
// 13.3 s.  Measured on
// the same card and not kept (one block a latent): L^-1 C and the
// diagonal of L^-T (L^-1 C) solved a thread per column (T^2 / 2 dependent
// FMAs through shared memory each, 3.67 ms a search), 256 threads (2.33
// ms), and each lane staging its columns of row k in registers before its
// row updates (2.03 ms).

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
// global scratch a launch may take on the scratch path; a cluster size whose
// scratch would exceed it is not picked (1 GiB: nb 16 up to T1000 float32 Z5)
constexpr size_t SCRATCH_CAP = (size_t)1 << 30;

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
  T ll;
  if (s.profile) {
    T sc = tr / R::mul(s.nseg, (T)n);
    sc = sc < (T)1e-2 ? (T)1e-2 : (sc > (T)1e2 ? (T)1e2 : sc);  // NaN stays NaN
    ll = R::sub(R::mul((T)-0.5, tr) / sc,
                R::mul(s.nseg, R::add(R::mul((T)(0.5 * n), log(sc)), logdet)));
  } else {
    ll = R::sub(R::mul((T)-0.5, tr), R::mul(s.nseg, logdet));
  }
  return -ll;
}

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

// rounds of a search on a cluster of nb blocks (the header's schedule)
__host__ __device__ inline int rounds(int nb, int grid, int iters, int polish) {
  int r = grid >= 3 ? (grid + nb - 1) / nb : 0;
  int rem = iters;
  if (nb == 1) {
    r += 2;
  } else {
    const int m = ilog2(nb) - 1 < rem ? ilog2(nb) - 1 : rem;
    r += 1;
    rem -= m;
  }
  const int depth = ilog2(nb + 1);
  return r + (rem + depth - 1) / depth + (polish ? 1 : 0);
}

template <typename T>
__global__ void __launch_bounds__(NT) hstep_search_kernel(
    const T* __restrict__ C, const T* __restrict__ nseg_p, const T* __restrict__ sigsq,
    const T* __restrict__ lo_in, const T* __restrict__ hi_in, T* __restrict__ xout,
    T* __restrict__ scratch, int n, double gp_noise, double dt, int profile, int iters,
    int polish, int grid, double tiebreak) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T fgrid[GRID_MAX];   // the grid's objectives, NaN kept
  __shared__ T ftree[2][NB_MAX];  // a golden round's objectives, by the round's parity
  __shared__ T red[NW];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int z = blockIdx.x / nb;
  T* buf = scratch != nullptr ? scratch + ((size_t)z * nb + rank) * per_latent(n)
                              : reinterpret_cast<T*>(smem_raw);
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
  // the objective f of slot i into every block's array a; a round's
  // cluster.sync() makes it visible.  A round writes the parity its
  // readers of two rounds before have finished with
  auto publish = [&](T* a, int i, T f) {
    if ((int)threadIdx.x < nb) *cluster.map_shared_rank(a + i, threadIdx.x) = f;
  };
  cluster.sync();  // every block has started before any writes into its shared memory

  T lo = lo_in[z], hi = hi_in[z];
  if (grid >= 3) {
    const T span = R::sub(hi, lo);
    const T last = (T)(grid - 1);
    for (int i = rank; i < grid; i += nb)
      publish(fgrid, i, evaluate(s, R::add(lo, R::mul((T)i / last, span))));
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
  if (nb == 1) {
    fc = evaluate(s, c);
    fd = evaluate(s, d);
  } else {
    // c, d and the first m shrinks: slot 0 c, 1 d, node k >= 2 the point
    // of level ilog2(k) - 1 whose comparisons are k's bits below its
    // leading one, most significant first (1: fc < fd)
    const int m = ilog2(nb) - 1 < rem ? ilog2(nb) - 1 : rem;
    T* ft = ftree[round & 1];
    if (rank < (2 << m)) {
      T x = rank == 0 ? c : d;
      if (rank >= 2) {
        T l2 = lo, h2 = hi, c2 = c, d2 = d;
        const int j = ilog2(rank) - 1;
        for (int l = 0; l <= j; ++l) x = shrink(l2, h2, c2, d2, (rank >> (j - l)) & 1);
      }
      publish(ft, rank, evaluate(s, x));
    }
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
  const int depth = ilog2(nb + 1);
  while (rem > 0) {
    const int m = depth < rem ? depth : rem;
    T* ft = ftree[round & 1];
    if (rank < (1 << m) - 1) {
      const int node = rank + 1, j = ilog2(node);
      T l2 = lo, h2 = hi, c2 = c, d2 = d;
      T x = shrink(l2, h2, c2, d2, fc < fd);
      for (int l = 1; l <= j; ++l) x = shrink(l2, h2, c2, d2, (node >> (j - l)) & 1);
      publish(ft, rank, evaluate(s, x));
    }
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
  if (polish) {  // every block evaluates the mid itself: no exchange
    const T fm = evaluate(s, mid);
    const T mc = R::sub(mid, c), md = R::sub(mid, d);
    const T gd = R::sub(fm, fd), gc = R::sub(fm, fc);
    const T num = R::sub(R::mul(R::mul(mc, mc), gd), R::mul(R::mul(md, md), gc));
    const T den = R::sub(R::mul(mc, gd), R::mul(md, gc));
    const bool safe = fabs(den) > (T)1e-30;
    const T x_star = R::sub(mid, R::mul((T)0.5, safe ? num / den : (T)0));
    out = safe && x_star > lo && x_star < hi ? x_star : mid;
  }
  if (rank == 0 && threadIdx.x == 0) xout[z] = out;
}

size_t scratch_values(int n, size_t elem) {
  // the static arrays (objectives, partial sums) take the rest
  const size_t static_bytes = (GRID_MAX + 2 * NB_MAX + NW) * elem;
  return per_latent(n) * elem + static_bytes <= (size_t)SMEM_MAX ? 0 : per_latent(n);
}

template <typename T>
cudaError_t configure(size_t smem, int nb) {
  cudaError_t err = cudaFuncSetAttribute(hstep_search_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && nb > 8)
    err = cudaFuncSetAttribute(hstep_search_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Z clusters of nb blocks
inline cudaLaunchConfig_t launch_config(int Z, int nb, size_t smem, cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(Z * nb));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
size_t smem_bytes(int n) {
  return scratch_values(n, sizeof(T)) != 0 ? 0 : per_latent(n) * sizeof(T);
}

// clusters of nb blocks resident at once on the current device (0: none
// fits), or -error
template <typename T>
int resident(int n, int nb) {
  const size_t smem = smem_bytes<T>(n);
  cudaError_t err = configure<T>(smem, nb);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, nb, smem, 0, attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, hstep_search_kernel<T>, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

template <typename T>
int choose(int n, int Z, int grid, int iters, int polish) {
  const bool scr = scratch_values(n, sizeof(T)) != 0;
  int best = 0;
  long long best_cost = LLONG_MAX;
  for (int nb = NB_MAX; nb >= 1; nb /= 2) {
    if (scr && (size_t)Z * nb * per_latent(n) * sizeof(T) > SCRATCH_CAP) continue;
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

template <typename T>
cudaError_t launch(const T* C, const T* nseg, const T* sigsq, const T* lo, const T* hi, T* x,
                   T* scratch, int Z, int n, double gp_noise, double dt, int profile, int iters,
                   int polish, int grid, double tiebreak, int nb, cudaStream_t st) {
  const size_t smem = smem_bytes<T>(n);
  cudaError_t err = configure<T>(smem, nb);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(Z, nb, smem, st, attr);
  err = cudaLaunchKernelEx(&cfg, hstep_search_kernel<T>, C, nseg, sigsq, lo, hi, x, scratch, n,
                           gp_noise, dt, profile, iters, polish, grid, tiebreak);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Values of global scratch per block that the search at T = n needs: 0
// when its buffers (3 n^2 + n values) fit in one block's shared memory.
int hstep_search_scratch(int n, int is_double) {
  return (int)scratch_values(n, is_double ? sizeof(double) : sizeof(float));
}

// The cluster size for Z latents at T = n on the current device (the
// header's rule): 1 <= nb <= 16, 0 when no size is resident, or -error.
int hstep_search_cluster(int n, int is_double, int Z, int grid, int iters, int polish) {
  if (Z < 1 || n < 1 || grid < 0 || grid > GRID_MAX || iters < 0) return 0;
  return is_double ? choose<double>(n, Z, grid, iters, polish)
                   : choose<float>(n, Z, grid, iters, polish);
}

// Clusters of nb blocks the current device holds at once at T = n (0:
// none), or -error.
int hstep_search_resident(int n, int is_double, int nb) {
  if (n < 1 || nb < 1 || nb > NB_MAX) return 0;
  return is_double ? resident<double>(n, nb) : resident<float>(n, nb);
}

// Rounds of one search on a cluster of nb blocks.
int hstep_search_rounds(int nb, int grid, int iters, int polish) {
  if (nb < 1 || nb > NB_MAX || iters < 0) return 0;
  return rounds(nb, grid, iters, polish);
}

// C (Z, n, n), sigsq, lo, hi and x (Z,), nseg one value, all contiguous,
// float64 when is_double else float32; scratch NULL, or Z nb times the
// values hstep_search_scratch gives.  0 <= grid <= GRID_MAX (a grid below
// 3 is off); 1 <= nb <= 16 blocks per latent (hstep_search_cluster's
// choice; 1 runs the chain of single evaluations, with the same result).
int hstep_search(const void* C, const void* nseg, const void* sigsq, const void* lo,
                 const void* hi, void* x, void* scratch, int Z, int n, double gp_noise, double dt,
                 int profile, int iters, int polish, int grid, double tiebreak, int is_double,
                 int nb, void* stream) {
  if (Z < 1 || n < 1 || iters < 0 || grid < 0 || grid > GRID_MAX || nb < 1 || nb > NB_MAX ||
      (hstep_search_scratch(n, is_double) != 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch((const double*)C, (const double*)nseg, (const double*)sigsq,
                       (const double*)lo, (const double*)hi, (double*)x, (double*)scratch, Z, n,
                       gp_noise, dt, profile, iters, polish, grid, tiebreak, nb, st);
  return (int)launch((const float*)C, (const float*)nseg, (const float*)sigsq, (const float*)lo,
                     (const float*)hi, (float*)x, (float*)scratch, Z, n, gp_noise, dt, profile,
                     iters, polish, grid, tiebreak, nb, st);
}

}  // extern "C"
