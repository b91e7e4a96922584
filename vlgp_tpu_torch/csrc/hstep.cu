// The H-step's bounded search on log(omega), for Hopper: the counterpart of
// the lax.fori_loop of vlgp_tpu/models/gp.py:_golden_min (:255-268) that
// hstep runs at :270-272, which has no Pallas kernel (XLA compiles the
// search into one device loop).  The port's plain version
// (vlgp_tpu_torch/ops/golden.py:_hstep_search_plain, the torch
// _golden_min over gp_elbo_stats) makes ~15-20 launches per evaluation,
// some of them cuSOLVER and cuBLAS batched calls, ~1,000 per refinement.
//
// One block per latent z runs the whole search: the grid scan (grid
// candidates on [lo, hi], a NaN objective counted as +inf, the first
// candidate within tiebreak |fmin| of the minimum, a NaN neighbour
// shrinking the bracket onto the best candidate, an all-NaN column
// collapsing onto lo), then iters golden-section shrinks and, with polish,
// the vertex of the parabola through the last three points, each branch as
// in _golden_min.  The search's own arithmetic is rounded operation by
// operation (no FMA contraction), as torch rounds each of its ops, so the
// decisions differ from the plain version's only where the objective does.
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
// K, [C | I] and log diag(L) live in shared memory (3 T^2 + T values: T <=
// 138 in float32, T <= 97 in float64); a larger T puts them in global
// scratch given by the wrapper, in the same kernel.  Every thread runs the
// search's scalar logic on the same values, so the control flow is
// uniform.
//
// What bounds it on this card: the chain.  An evaluation is T dependent
// column steps, one barrier each, with ~3 T^2 / 2 FMAs per step spread
// over the block; the grid + 2 + iters (+ 1 with polish) evaluations of a
// search run one after another.  At the flagship (T50, grid 13, iters 24)
// that is 39 evaluations of 50 steps, ~0.9 us a step on an H100 (1.77 ms
// a search); the ~5 T^3 / 6 = 104k FMAs of an evaluation are nothing to
// the card, and Z blocks run side by side.  Measured on the same card and
// not kept: L^-1 C and the diagonal of L^-T (L^-1 C) solved a thread per
// column (T^2 / 2 dependent FMAs through shared memory each, 3.67 ms a
// search), 256 threads (2.33 ms), and each lane staging its columns of
// row k in registers before its row updates (2.03 ms).

#include <cmath>

#include "ns_common.cuh"

namespace {

constexpr int NT = 512;              // threads per block: a warp per row of a column step
constexpr int NW = NT / 32;
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr int GRID_MAX = 256;

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

// K, [C | I] and log diag(L) of one latent, in values
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

template <typename T>
__global__ void __launch_bounds__(NT) hstep_search_kernel(
    const T* __restrict__ C, const T* __restrict__ nseg_p, const T* __restrict__ sigsq,
    const T* __restrict__ lo_in, const T* __restrict__ hi_in, T* __restrict__ xout,
    T* __restrict__ scratch, int n, double gp_noise, double dt, int profile, int iters,
    int polish, int grid, double tiebreak) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T fcand[GRID_MAX];
  __shared__ T red[NW];
  __shared__ unsigned char bad[GRID_MAX];
  const int z = blockIdx.x;
  T* buf = scratch != nullptr ? scratch + z * per_latent(n) : reinterpret_cast<T*>(smem_raw);
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

  T lo = lo_in[z], hi = hi_in[z];
  if (grid >= 3) {
    const T span = R::sub(hi, lo);
    const T last = (T)(grid - 1);
    T fmin = (T)INFINITY;
    for (int i = 0; i < grid; ++i) {
      const T cand = R::add(lo, R::mul((T)i / last, span));
      const T f = evaluate(s, cand);
      const bool nan = f != f;
      const T fi = nan ? (T)INFINITY : f;
      if (threadIdx.x == 0) {
        fcand[i] = fi;
        bad[i] = nan;
      }
      fmin = fi < fmin ? fi : fmin;
    }
    __syncthreads();
    const T thr = R::add(fmin, R::mul((T)tiebreak, fabs(fmin)));
    int best = 0;
    while (best < grid - 1 && !(fcand[best] <= thr)) ++best;
    if (!(fcand[best] <= thr)) best = 0;
    int lo_i = best > 0 ? best - 1 : 0;
    if (bad[lo_i]) lo_i = best;
    int hi_i = best + 1 < grid ? best + 1 : grid - 1;
    if (bad[hi_i]) hi_i = best;
    bool allbad = true;
    for (int i = 0; i < grid; ++i) allbad = allbad && bad[i];
    const T lo_b = R::add(lo, R::mul((T)lo_i / last, span));
    const T hi_b = R::add(lo, R::mul((T)hi_i / last, span));
    hi = allbad ? lo : hi_b;
    lo = allbad ? lo : lo_b;
  }
  const T phi = (T)0.6180339887498949;
  T c = R::sub(hi, R::mul(phi, R::sub(hi, lo)));
  T d = R::add(lo, R::mul(phi, R::sub(hi, lo)));
  T fc = evaluate(s, c);
  T fd = evaluate(s, d);
  for (int it = 0; it < iters; ++it) {
    const bool left = fc < fd;
    const T lo_n = left ? lo : c;
    const T hi_n = left ? d : hi;
    const T c_n = left ? R::sub(hi_n, R::mul(phi, R::sub(hi_n, lo_n))) : d;
    const T d_n = left ? c : R::add(lo_n, R::mul(phi, R::sub(hi_n, lo_n)));
    const T f_new = evaluate(s, left ? c_n : d_n);
    const T fc_n = left ? f_new : fd;
    const T fd_n = left ? fc : f_new;
    fc = fc_n;
    fd = fd_n;
    lo = lo_n;
    hi = hi_n;
    c = c_n;
    d = d_n;
  }
  const T mid = R::mul((T)0.5, R::add(lo, hi));
  T out = mid;
  if (polish) {
    const T fm = evaluate(s, mid);
    const T mc = R::sub(mid, c), md = R::sub(mid, d);
    const T gd = R::sub(fm, fd), gc = R::sub(fm, fc);
    const T num = R::sub(R::mul(R::mul(mc, mc), gd), R::mul(R::mul(md, md), gc));
    const T den = R::sub(R::mul(mc, gd), R::mul(md, gc));
    const bool safe = fabs(den) > (T)1e-30;
    const T x_star = R::sub(mid, R::mul((T)0.5, safe ? num / den : (T)0));
    out = safe && x_star > lo && x_star < hi ? x_star : mid;
  }
  if (threadIdx.x == 0) xout[z] = out;
}

template <typename T>
cudaError_t launch(const T* C, const T* nseg, const T* sigsq, const T* lo, const T* hi, T* x,
                   T* scratch, int Z, int n, double gp_noise, double dt, int profile, int iters,
                   int polish, int grid, double tiebreak, cudaStream_t st) {
  const size_t smem = scratch != nullptr ? 0 : per_latent(n) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(hstep_search_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  hstep_search_kernel<T><<<Z, NT, smem, st>>>(C, nseg, sigsq, lo, hi, x, scratch, n, gp_noise, dt,
                                              profile, iters, polish, grid, tiebreak);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Values of global scratch per latent that the search at T = n needs: 0
// when its buffers (3 n^2 + n values) fit in one block's shared memory.
int hstep_search_scratch(int n, int is_double) {
  const size_t bytes = per_latent(n) * (is_double ? sizeof(double) : sizeof(float));
  // the static arrays (objectives, flags, partial sums) take the rest
  const size_t static_bytes = GRID_MAX * (sizeof(double) + 1) + NW * sizeof(double);
  return bytes + static_bytes <= (size_t)SMEM_MAX ? 0 : (int)per_latent(n);
}

// C (Z, n, n), sigsq, lo, hi and x (Z,), nseg one value, all contiguous,
// float64 when is_double else float32; scratch NULL, or Z times the
// values hstep_search_scratch gives.  1 <= grid <= GRID_MAX (a grid below 3 is off).
int hstep_search(const void* C, const void* nseg, const void* sigsq, const void* lo,
                 const void* hi, void* x, void* scratch, int Z, int n, double gp_noise, double dt,
                 int profile, int iters, int polish, int grid, double tiebreak, int is_double,
                 void* stream) {
  if (Z < 1 || n < 1 || iters < 0 || grid < 0 || grid > GRID_MAX ||
      (hstep_search_scratch(n, is_double) != 0) != (scratch != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch((const double*)C, (const double*)nseg, (const double*)sigsq,
                       (const double*)lo, (const double*)hi, (double*)x, (double*)scratch, Z, n,
                       gp_noise, dt, profile, iters, polish, grid, tiebreak, st);
  return (int)launch((const float*)C, (const float*)nseg, (const float*)sigsq, (const float*)lo,
                     (const float*)hi, (float*)x, (float*)scratch, Z, n, gp_noise, dt, profile,
                     iters, polish, grid, tiebreak, st);
}

}  // extern "C"
