// The right singular vectors of the loading, vh of a = U S Vh, for Hopper:
// the counterpart of jnp.linalg.svd(a, full_matrices=False)[2] in
// vlgp_tpu/models/vlgp.py:constrain_loading (:512), which has no Pallas
// kernel (XLA's SVD).  torch.linalg.svd reads its solver's info on the
// host, which a CUDA graph capture refuses; this kernel reads nothing back,
// so constrain_loading="svd" runs inside the captured EM step.
//
// a is (Z, Y), float32 or float64, Z <= 128 and Y any size; vh is (K, Y)
// with K = min(Z, Y), in a's dtype.  One block does everything, in float64:
//
//   1. the Z x Z Gram a a' in shared memory (the packed upper triangle),
//      a streamed through shared memory in chunks of CH columns, each
//      thread summing its entries over y in increasing order.  A
//      non-finite diagonal entry (a NaN or inf in a, or overflow) fills vh
//      with NaN and ends the kernel, as the plain version does;
//   2. cyclic Jacobi on the Gram, the pairs of each round chosen by the
//      round-robin schedule (Z rounded up to even, the pad index a zero
//      row that is never rotated), so the Z/2 rotations of a round touch
//      disjoint rows: one thread computes each rotation, then each thread
//      updates a 2 x 2 block of the Gram, J_P' G_PQ J_Q, or two entries of
//      a row of V in place.  Rutishauser's rotation; a pair is skipped when
//      |g_pq| <= eps sqrt|g_pp g_qq|.  At most MAX_SWEEPS sweeps; a sweep
//      starts only while the off-diagonal norm exceeds TOL_SWEEP times the
//      trace, a test that a NaN fails, so it cannot loop;
//   3. the eigenvalues (the Gram's diagonal) ranked in descending order,
//      ties by index;
//   4. the rows w_k = V_k' a in that order, streamed over the chunks of a,
//      each normalised by its own computed norm (not by sqrt(lambda_k),
//      whose absolute error eps lambda_max would spoil the small rows);
//   5. rows whose squared norm is at most RANK_TOL lambda_max (a zero row
//      of a, or a rank deficiency) are not normalised but replaced, in
//      order, by the unit vector e_j with the largest remainder 1 -
//      sum_i vh[i, j]^2 after the rows before it, orthogonalised against
//      them twice (classical Gram-Schmidt with one re-orthogonalisation):
//      finite, orthonormal rows, never 0 / 0.
//
// Sign convention, shared with the plain version (ops/linalg.py): the
// entry of largest absolute value of each row is positive, the first such
// entry on a tie.  (jnp's LAPACK picks another sign for some rows: the
// model is unchanged when a row of vh and the column of mu that goes with
// it are negated.)
//
// Why the Gram and not one-sided (Hestenes) Jacobi on the rows of a: the
// Gram is formed once in O(Z^2 Y) and the sweeps then cost O(Z^3) in
// shared memory, where Hestenes rotates rows of length Y in device memory
// every sweep.  Forming it squares the condition number, but in float64
// and with each row normalised by its own norm the orthogonality error is
// ~eps kappa (float64 eps), below float32 rounding for kappa < 1e8.  In
// the fit, a has orthonormal rows after every constraint, so kappa ~ 1.
//
// What bounds it on this card.  At the flagship (Z5 Y100) the work is ~10^4
// flops and 4 KB: the bound is under a microsecond, and the kernel's time
// is the latency of one block's serial phases (a handful of Jacobi rounds,
// two barriers each).  It runs once per EM iteration.  No atomics: every
// sum has a fixed order, so repeated calls give the same bits.

#include <cfloat>
#include <cmath>

#include "ns_common.cuh"

namespace {

constexpr int NT = 512;              // threads per block
constexpr int NW = NT / 32;          // warps per block
constexpr int ZMAX = 128;            // largest Z (rows of a)
constexpr int KPMAX = (ZMAX * (ZMAX + 1) / 2 + NT - 1) / NT;  // Gram entries per thread
constexpr int MAX_SWEEPS = 30;
constexpr int CH_MAX = 64;           // columns of a per streamed chunk
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr double TOL_SWEEP = ZMAX * DBL_EPSILON;
constexpr double RANK_TOL = 1e-12;   // squared norm of a null row, relative to lambda_max

// packed index of (i, j), i <= j, in the upper triangle stored by columns
__device__ __forceinline__ int pk(int i, int j) { return j * (j + 1) / 2 + i; }
__device__ __forceinline__ int pks(int i, int j) { return i <= j ? pk(i, j) : pk(j, i); }

// (i, j), i <= j, of packed index p
__device__ __forceinline__ void unpk(int p, int& i, int& j) {
  j = (int)((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  i = p - j * (j + 1) / 2;
}

// the pair of slot k in round r of the round-robin schedule over n (even)
// indices: every index once per round, every pair once per n - 1 rounds
__device__ __forceinline__ void rr_pair(int n, int r, int k, int& p, int& q) {
  const int m = n - 1;
  int u, v;
  if (k == 0) {
    u = m;
    v = r;
  } else {
    u = (r + k) % m;
    v = (r - k + m) % m;
  }
  p = min(u, v);
  q = max(u, v);
}

__device__ __forceinline__ double warp_sum_d(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// (|value|, index) max over a warp, the lower index on a tie
__device__ __forceinline__ void warp_argmax(double& v, int& j) {
  for (int o = 16; o > 0; o >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oj = __shfl_xor_sync(0xffffffffu, j, o);
    if (ov > v || (ov == v && oj < j)) {
      v = ov;
      j = oj;
    }
  }
}

struct Shared {
  double* G;      // packed Gram, Zp (Zp + 1) / 2
  double* V;      // Zp x Zp, column k the k-th eigenvector
  double* chunk;  // Z x CH columns of a
  double* rc;     // rotation of each slot of a round: c, s, t (Zp / 2 each)
  double* rs;
  double* rt;
  double* scale;  // per output row: sign / norm; coefficients in step 5
  double* red;    // 2 NW block-reduction scratch
  int* order;     // Zp: index of the k-th largest eigenvalue
  int* pa;        // Zp / 2: the pair of each slot
  int* pb;
  int* redi;      // NW + 2
};

__host__ __device__ inline size_t smem_bytes(int Z, int ch) {
  const int zp = Z + (Z & 1);
  const size_t nd = (size_t)zp * (zp + 1) / 2 + (size_t)zp * zp + (size_t)Z * ch +
                    3 * (zp / 2) + zp + 2 * NW;
  const size_t ni = zp + 2 * (zp / 2) + NW + 2;
  return sizeof(double) * nd + sizeof(int) * ni;
}

// Sum of two values over the block; every thread gets both.
__device__ void block_sum2(double& a, double& b, double* red) {
  a = warp_sum_d(a);
  b = warp_sum_d(b);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) {
    red[w] = a;
    red[NW + w] = b;
  }
  __syncthreads();
  a = 0.0;
  b = 0.0;
  for (int i = 0; i < NW; ++i) {
    a += red[i];
    b += red[NW + i];
  }
}

// (|value|, index) max over the block; every thread gets the winner.
__device__ void block_argmax(double& v, int& j, double* red, int* redi) {
  warp_argmax(v, j);
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) {
    red[w] = v;
    redi[w] = j;
  }
  __syncthreads();
  v = red[0];
  j = redi[0];
  for (int i = 1; i < NW; ++i)
    if (red[i] > v || (red[i] == v && redi[i] < j)) {
      v = red[i];
      j = redi[i];
    }
}

// Load columns [y0, y0 + ch) of a (Z, Y) into the chunk as float64, zero
// past Y.
template <typename T>
__device__ void load_chunk(const T* a, double* chunk, int Z, int Y, int y0, int ch) {
  for (int t = threadIdx.x; t < Z * ch; t += NT) {
    const int i = t / ch, c = t % ch;
    chunk[t] = y0 + c < Y ? (double)a[(size_t)i * Y + y0 + c] : 0.0;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) svd_loading_kernel(const T* __restrict__ a,
                                                         T* __restrict__ vh, int Z, int Y,
                                                         int K, int ch) {
  extern __shared__ double smem[];
  const int zp = Z + (Z & 1), h = zp / 2, tid = threadIdx.x;
  const int npk = zp * (zp + 1) / 2;
  Shared s;
  s.G = smem;
  s.V = s.G + npk;
  s.chunk = s.V + zp * zp;
  s.rc = s.chunk + Z * ch;
  s.rs = s.rc + h;
  s.rt = s.rs + h;
  s.scale = s.rt + h;
  s.red = s.scale + zp;
  s.order = reinterpret_cast<int*>(s.red + 2 * NW);
  s.pa = s.order + zp;
  s.pb = s.pa + h;
  s.redi = s.pb + h;

  // 1. the Gram, each thread its packed entries p = tid + NT e
  double acc[KPMAX];
#pragma unroll
  for (int e = 0; e < KPMAX; ++e) acc[e] = 0.0;
  for (int y0 = 0; y0 < Y; y0 += ch) {
    __syncthreads();
    load_chunk(a, s.chunk, Z, Y, y0, ch);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < KPMAX; ++e) {
      const int p = tid + NT * e;
      if (p < npk) {
        int i, j;
        unpk(p, i, j);
        if (j < Z) {
          const double* ri = s.chunk + i * ch;
          const double* rj = s.chunk + j * ch;
          double sum = acc[e];
          for (int c = 0; c < ch; ++c) sum = fma(ri[c], rj[c], sum);
          acc[e] = sum;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < KPMAX; ++e) {
    const int p = tid + NT * e;
    if (p < npk) s.G[p] = acc[e];
  }
  for (int t = tid; t < zp * zp; t += NT) s.V[t] = (t / zp == t % zp) ? 1.0 : 0.0;
  __syncthreads();
  // a non-finite input: NaN out, as the plain version
  double bad = 0.0, unused = 0.0;
  for (int i = tid; i < Z; i += NT) bad += isfinite(s.G[pk(i, i)]) ? 0.0 : 1.0;
  block_sum2(bad, unused, s.red);
  if (bad > 0.0) {
    for (size_t t = tid; t < (size_t)K * Y; t += NT) vh[t] = (T)NAN;
    return;
  }

  // 2. Jacobi sweeps
  const int nblk = h * (h + 1) / 2;
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    double off = 0.0, tr = 0.0;
    for (int p = tid; p < npk; p += NT) {
      int i, j;
      unpk(p, i, j);
      const double g = s.G[p];
      if (i == j)
        tr += g;
      else
        off += g * g;
    }
    block_sum2(off, tr, s.red);
    if (!(sqrt(off) > TOL_SWEEP * tr)) break;  // NaN stops too
    for (int r = 0; r < zp - 1; ++r) {
      if (tid < h) {
        int p, q;
        rr_pair(zp, r, tid, p, q);
        s.pa[tid] = p;
        s.pb[tid] = q;
        const double app = s.G[pk(p, p)], aqq = s.G[pk(q, q)], apq = s.G[pk(p, q)];
        double c = 1.0, sn = 0.0, t = 0.0;
        if (fabs(apq) > DBL_EPSILON * sqrt(fabs(app * aqq))) {
          const double theta = (aqq - app) / (2.0 * apq);
          t = copysign(1.0, theta) / (fabs(theta) + hypot(1.0, theta));
          c = 1.0 / sqrt(1.0 + t * t);
          sn = t * c;
        }
        s.rc[tid] = c;
        s.rs[tid] = sn;
        s.rt[tid] = t;
      }
      __syncthreads();
      for (int task = tid; task < nblk + zp * h; task += NT) {
        if (task < nblk) {
          int k1, k2;
          unpk(task, k1, k2);
          const double s1 = s.rs[k1], s2 = s.rs[k2];
          if (s1 == 0.0 && s2 == 0.0) continue;
          const int p1 = s.pa[k1], p2 = s.pb[k1];
          if (k1 == k2) {
            const double apq = s.G[pk(p1, p2)], t = s.rt[k1];
            s.G[pk(p1, p1)] -= t * apq;
            s.G[pk(p2, p2)] += t * apq;
            s.G[pk(p1, p2)] = 0.0;
          } else {
            const double c1 = s.rc[k1], c2 = s.rc[k2];
            const int q1 = s.pa[k2], q2 = s.pb[k2];
            const int i11 = pks(p1, q1), i12 = pks(p1, q2), i21 = pks(p2, q1), i22 = pks(p2, q2);
            const double g11 = s.G[i11], g12 = s.G[i12], g21 = s.G[i21], g22 = s.G[i22];
            // rows by J_P', then columns by J_Q
            const double r11 = c1 * g11 - s1 * g21, r12 = c1 * g12 - s1 * g22;
            const double r21 = s1 * g11 + c1 * g21, r22 = s1 * g12 + c1 * g22;
            s.G[i11] = c2 * r11 - s2 * r12;
            s.G[i12] = s2 * r11 + c2 * r12;
            s.G[i21] = c2 * r21 - s2 * r22;
            s.G[i22] = s2 * r21 + c2 * r22;
          }
        } else {
          const int row = (task - nblk) / h, k = (task - nblk) % h;
          const double sn = s.rs[k];
          if (sn == 0.0) continue;
          const double c = s.rc[k];
          double* vr = s.V + row * zp;
          const int p = s.pa[k], q = s.pb[k];
          const double vp = vr[p], vq = vr[q];
          vr[p] = c * vp - sn * vq;
          vr[q] = sn * vp + c * vq;
        }
      }
      __syncthreads();
    }
  }

  // 3. descending order of the eigenvalues, ties by index
  for (int i = tid; i < Z; i += NT) {
    const double li = s.G[pk(i, i)];
    int rank = 0;
    for (int j = 0; j < Z; ++j) {
      const double lj = s.G[pk(j, j)];
      rank += (lj > li) || (lj == li && j < i);
    }
    s.order[rank] = i;
  }
  __syncthreads();
  const double lmax = fmax(s.G[pk(s.order[0], s.order[0])], 0.0);

  // 4. raw rows w_k = V_k' a, k < K
  for (int y0 = 0; y0 < Y; y0 += ch) {
    load_chunk(a, s.chunk, Z, Y, y0, ch);
    __syncthreads();
    for (int t = tid; t < K * ch; t += NT) {
      const int k = t / ch, c = t % ch;
      if (y0 + c >= Y) continue;
      const int col = s.order[k];
      double wk = 0.0;
      for (int i = 0; i < Z; ++i) wk = fma(s.V[i * zp + col], s.chunk[i * ch + c], wk);
      vh[(size_t)k * Y + y0 + c] = (T)wk;
    }
    __syncthreads();
  }
  // each row's squared norm and its entry of largest |.|: a warp per row
  const int w = tid / 32, lane = tid % 32;
  for (int k = w; k < K; k += NW) {
    const T* row = vh + (size_t)k * Y;
    double n2 = 0.0, best = -1.0;
    int jb = Y;
    for (int y = lane; y < Y; y += 32) {
      const double v = (double)row[y];
      n2 = fma(v, v, n2);
      if (fabs(v) > best) {
        best = fabs(v);
        jb = y;
      }
    }
    n2 = warp_sum_d(n2);
    warp_argmax(best, jb);
    if (lane == 0) {
      const bool good = n2 > RANK_TOL * lmax;
      s.scale[k] = good ? (row[jb] < (T)0 ? -1.0 : 1.0) / sqrt(n2) : 0.0;
    }
  }
  __syncthreads();
  if (tid == 0) {  // the leading run of normalisable rows
    int r = 0;
    while (r < K && s.scale[r] != 0.0) ++r;
    s.redi[NW] = r;
  }
  __syncthreads();
  const int r = s.redi[NW];
  for (size_t t = tid; t < (size_t)r * Y; t += NT)
    vh[t] = (T)((double)vh[t] * s.scale[t / Y]);
  __syncthreads();

  // 5. complete the null rows k >= r to an orthonormal set
  for (int k = r; k < K; ++k) {
    T* row = vh + (size_t)k * Y;
    // the unit vector e_j least covered by the rows before
    double best = -1.0;
    int jb = Y;
    for (int j = tid; j < Y; j += NT) {
      double cover = 0.0;
      for (int i = 0; i < k; ++i) {
        const double v = (double)vh[(size_t)i * Y + j];
        cover = fma(v, v, cover);
      }
      const double rem = 1.0 - cover;
      if (rem > best) {
        best = rem;
        jb = j;
      }
    }
    block_argmax(best, jb, s.red, s.redi);
    const int js = jb < Y ? jb : 0;
    for (int i = tid; i < k; i += NT) s.scale[i] = (double)vh[(size_t)i * Y + js];
    __syncthreads();
    for (int y = tid; y < Y; y += NT) {
      double u = y == js ? 1.0 : 0.0;
      for (int i = 0; i < k; ++i) u = fma(-s.scale[i], (double)vh[(size_t)i * Y + y], u);
      row[y] = (T)u;
    }
    __syncthreads();
    // re-orthogonalise: coefficients <vh_i, u>, a warp per row
    for (int i = w; i < k; i += NW) {
      double d = 0.0;
      for (int y = lane; y < Y; y += 32)
        d = fma((double)vh[(size_t)i * Y + y], (double)row[y], d);
      d = warp_sum_d(d);
      if (lane == 0) s.scale[i] = d;
    }
    __syncthreads();
    double n2 = 0.0, unused2 = 0.0;
    for (int y = tid; y < Y; y += NT) {
      double u = (double)row[y];
      for (int i = 0; i < k; ++i) u = fma(-s.scale[i], (double)vh[(size_t)i * Y + y], u);
      row[y] = (T)u;
    }
    __syncthreads();
    // normalise with the sign convention
    double bv = -1.0;
    int bj = Y;
    for (int y = tid; y < Y; y += NT) {
      const double v = (double)row[y];
      n2 = fma(v, v, n2);
      if (fabs(v) > bv) {
        bv = fabs(v);
        bj = y;
      }
    }
    block_sum2(n2, unused2, s.red);
    block_argmax(bv, bj, s.red, s.redi);
    const double sc = (row[bj < Y ? bj : 0] < (T)0 ? -1.0 : 1.0) / sqrt(n2);
    __syncthreads();
    for (int y = tid; y < Y; y += NT) row[y] = (T)((double)row[y] * sc);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const T* a, T* vh, int Z, int Y, int K, cudaStream_t st) {
  int ch = CH_MAX;
  while (ch > 1 && smem_bytes(Z, ch) > (size_t)SMEM_MAX) --ch;
  const size_t smem = smem_bytes(Z, ch);
  cudaError_t err = cudaFuncSetAttribute(svd_loading_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  svd_loading_kernel<T><<<1, NT, smem, st>>>(a, vh, Z, Y, K, ch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (Z, Y) and vh (min(Z, Y), Y), contiguous, float64 when is_double else
// float32; 1 <= Z <= 128, Y >= 1.
int svd_loading(const void* a, void* vh, int Z, int Y, int is_double, void* stream) {
  if (Z < 1 || Z > ZMAX || Y < 1 || a == nullptr || vh == nullptr)
    return (int)cudaErrorInvalidValue;
  const int K = Z < Y ? Z : Y;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch((const double*)a, (double*)vh, Z, Y, K, st);
  return (int)launch((const float*)a, (float*)vh, Z, Y, K, st);
}

}  // extern "C"
