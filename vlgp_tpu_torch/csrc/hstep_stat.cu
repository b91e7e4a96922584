// The H-step's pooled posterior statistic for Hopper, in two launches: the
// counterpart of vlgp_tpu/models/gp.py:435-450 (P, Q and the three einsums
// of hstep's F), which has no Pallas kernel (XLA fuses it).  The port's
// plain version (vlgp_tpu_torch/ops/hstat.py:_hstep_stat_plain) writes P
// = diag(w~) G and Q = P X, (Z, S, T, R) each, and a copy of valid * Q and
// two permuted copies, then runs sum_QP as one (T, S R) x (S R, T) GEMM per
// latent, which cuBLAS tiles with a handful of 32 x 32 blocks.
//
// Per latent z, with P_s = diag(w~_s) G and Q_s = P_s X_s (X_s used as
// stored: Newton-Schulz leaves it not exactly symmetric):
//
//   sum_QP = sum_s valid_s Q_s P_s'   (T, T), every entry computed
//   sum_X  = sum_s valid_s X_s        (R, R)
//   sum_QA = sum_s valid_s (P_s - Q_s) (T, R)
//
// multiplied by valid, never skipped, so a NaN in a segment with valid 0
// still poisons its latent's sums as 0 * NaN does in the plain version.  P
// and Q never reach device memory.
//
// hstep_stat_kernel: a block of 256 threads per (latent, tile pair, chunk
// of segments).  A tile pair is a 64 x 64 tile (t, u) of sum_QP; T <= 64
// (the flagship's window-50 segments) is one tile.  Over its chunk's
// segments, in order, the block
//
//   1. stages P_s[t-tile, q-chunk] (w~ times G, rounded as the plain
//      version rounds P) and X_s[q-chunk, r-tile] in shared memory, 64 x
//      64 each, and P_s[u-tile, r-tile];
//   2. forms Q_s[t-tile, r-tile] = sum over the q-chunks of P X, a 4 x 4
//      register tile per thread (a 16 x 16 grid of them);
//   3. stores valid_s Q_s in shared memory and adds valid_s Q_s P_s' into
//      the 4 x 4 register tile of sum_QP that the thread owns.
//
// The r-tiles (64 columns of Q) are the outermost loop, so sum_QP's
// accumulators live in registers through the whole chunk.  The diagonal
// tile pairs (t-tile = u-tile) also add valid_s (P_s - Q_s) into registers
// (P_s[t, r] is their u-tile's P) and, for the q-chunk of their own index,
// valid_s X_s, both written out after each r-tile.  Each of the three is
// summed by exactly one block per (latent, chunk), in segment order.
//
// What each tile re-reads.  X_s[:, r-tile] is read once per tile pair: at
// T <= 64 once in all; at T = 1000 (window=None) by the 16 tile pairs of
// each t-tile row and column, 256 times in all, from L2 mostly.  Q_s[t-tile]
// is recomputed by each of the T / 64 u-tiles of its row: T R^2 FMAs each
// time, against the T^2 R of sum_QP (at T1000 R50 the two are 2.5e6 x 16
// and 5e7 per segment).  G's tiles are staged in shared memory once per
// r-tile (G[t-tile] too when R <= 64, else per q-chunk from L1 and L2), w~
// comes from L1 and L2, and each X chunk is copied (cp.async) into one of
// two buffers while the block works on the chunk before it.
//
// hstep_stat_reduce_kernel: the chunks' partial sums, part (Z, C, NE) with
// NE = T^2 + T R + R^2 per latent (sum_QP | sum_QA | sum_X), added in chunk
// order for every entry, written to the three outputs in their layouts.
// No atomics: every run gives the same bits.  The chunk count is a function
// of the shape alone (BLOCK_TARGET), so the bits do not depend on the card.
//
// What bounds it on this card.  At the flagship (Z5 S2000 T50 R40 float32)
// the function reads X and w~ (64 MB and 2 MB: ~20 us at 3.35 TB/s) and
// does 2 Z S T R (R + T) = 3.6 GFLOP (~54 us at 67 TFLOP/s): FLOPs bind.
// The 64 x 64 tiles hold 50 x 40 (Q) and 50 x 50 (sum_QP) live entries;
// the register tiles of dead rows and columns skip the products, so the
// FMA slots are 52 x 40 and 52 x 52, ~1.3x the useful work; each k step of
// a 4 x 4 tile reads two 16-byte words from shared memory per 16 FMAs.  On
// an H100 it takes 0.25 ms there, ~4.7x the bound, two blocks an SM
// (128 registers; one block an SM, 188 registers, took 0.36 ms).  At T1000 R50
// S100 it takes 3.6 ms against the plain version's 2.1: half its FMA slots
// recompute Q, at ~half the FP32 rate (tools/torch_variant_ab.py).

#include <cmath>

#include "ns_common.cuh"

namespace {

constexpr int NT = 256;   // threads per block: a 16 x 16 grid of 4 x 4 register tiles
constexpr int BT = 64;    // rows t and columns u of a tile of sum_QP
constexpr int RC = 64;    // columns r of Q per r-tile
constexpr int KC = 64;    // rows q of X per chunk of the contraction Q = P X
constexpr int PER = BT * KC / NT;  // staged values per thread of a 64 x 64 tile
constexpr int NTR = 256;  // threads per block of the reduction
// blocks a launch aims at (two per SM of an H100); a constant, so that the
// chunks, and with them the bits, are a function of the shape alone
constexpr int BLOCK_TARGET = 264;

struct Plan {
  int nt, nr, nq, spc, chunks;
  long long ne;
};

inline Plan make_plan(int Z, int S, int T, int R) {
  Plan p;
  p.nt = (T + BT - 1) / BT;
  p.nr = (R + RC - 1) / RC;
  p.nq = (R + KC - 1) / KC;
  const long long tiles = (long long)Z * p.nt * p.nt;
  long long want = BLOCK_TARGET / tiles;
  want = want < 1 ? 1 : (want > S ? S : want);
  p.spc = (int)((S + want - 1) / want);
  p.chunks = (S + p.spc - 1) / p.spc;
  p.ne = (long long)T * T + (long long)T * R + (long long)R * R;
  return p;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// acc[i][j] += sum_{k < n} A[k][4 ti + i] B[k][4 tj + j]: A and B 64 wide,
// each k step two vector loads and 16 FMAs, k in increasing order
template <typename T>
__device__ __forceinline__ void tile_fma(const T* __restrict__ A, const T* __restrict__ B, int n,
                                         int ti, int tj, T (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    T a[4], b[4];
    load4(A + k * BT + 4 * ti, a);
    load4(B + k * BT + 4 * tj, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// the X chunk (q0.., r0..) of a segment into dst, element i = tid + NT e
// of the KC x RC tile (row i / RC), 0 outside the live ql x rl corner: by
// cp.async, committed as one group, so the chunk bypasses the registers and
// arrives while the block works on the chunk before it
template <typename T>
__device__ __forceinline__ void copy_x(T* dst, const T* __restrict__ Xs, int R, int q0, int ql,
                                       int r0, int rl) {
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + NT * e, k = i / RC, r = i - k * RC;
    const bool ok = k < ql && r < rl;
    const T* src = ok ? Xs + (size_t)(q0 + k) * R + r0 + r : Xs;
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + i);
    if (sizeof(T) == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src),
                   "r"(ok ? 8 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
                   "r"(ok ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;" ::);
}

// two blocks an SM in float32; float64's tiles fill an SM's shared memory
// with one, so its registers are not capped
template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == sizeof(float) ? 2 : 1) hstep_stat_kernel(
    const T* __restrict__ G, const T* __restrict__ w, const T* __restrict__ X,
    const T* __restrict__ valid, T* __restrict__ part, int S, int Tn, int R, int nt, int nr,
    int nq, int spc, int chunks, long long ne) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Pt = reinterpret_cast<T*>(smem_raw);  // [k][t]: P_s[t-tile, q-chunk]
  T* Xk = Pt + BT * KC;                    // [k][r]: X_s[q-chunk, r-tile]
  T* Pu = Xk + KC * RC;                    // [r][u]: P_s[u-tile, r-tile]
  T* Qs = Pu + RC * BT;                    // [r][t]: valid_s Q_s[t-tile, r-tile]
  T* Gt = Qs + RC * BT;                    // [k][t]: G[t-tile, q-chunk] when nq == 1
  T* Gu = Gt + KC * BT;                    // [r][u]: G[u-tile, r-tile]
  T* Xk1 = Gu + RC * BT;                   // the other buffer of the X chunks
  const int tid = threadIdx.x;
  const int ti = tid % 16, tj = tid / 16;
  const int c = blockIdx.x, z = blockIdx.z;
  const int tt = blockIdx.y / nt, tu = blockIdx.y - tt * nt;
  const int t0 = tt * BT, u0 = tu * BT;
  const bool diag = tt == tu;
  const int s_begin = c * spc, s_end = min(S, s_begin + spc);
  const T* Gz = G + (size_t)z * Tn * R;
  const T* wz = w + (size_t)z * S * Tn;
  const T* Xz = X + (size_t)z * S * R * R;
  T* pz = part + ((size_t)z * chunks + c) * ne;
  // the staging map of a 64 x 64 tile [row][col]: col tid % 64 (t or u),
  // rows tid / 64 + 4 e (k or r).  Gt and Gu are written and read by the
  // same thread under this map, so they need no barrier of their own
  const int col = tid % BT, row0 = tid / BT;
  constexpr int RSTEP = NT / BT;
  const int t = t0 + col, u = u0 + col;
  // register tiles holding live rows t and columns u: the others skip the
  // products (at T = 50, 13 x 13 of the 16 x 16)
  const bool live_t = 4 * ti < Tn - t0, live_u = 4 * tj < Tn - u0;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = (T)0;
  // the X chunk of step j of the block's order (r-tiles, segments,
  // q-chunks) lands in buffer j % 2, copied during step j - 1
  copy_x(Xk, Xz + (size_t)s_begin * R * R, R, 0, min(KC, R), 0, min(RC, R));
  int step = 0;

  for (int rt = 0; rt < nr; ++rt) {
    const int r0 = rt * RC, rl = min(RC, R - r0);
#pragma unroll 4
    for (int e = 0; e < RC / RSTEP; ++e) {
      const int r = row0 + RSTEP * e;
      Gu[r * BT + col] = u < Tn && r < rl ? Gz[(size_t)u * R + r0 + r] : (T)0;
    }
    if (nq == 1) {
#pragma unroll 4
      for (int e = 0; e < KC / RSTEP; ++e) {
        const int k = row0 + RSTEP * e;
        Gt[k * BT + col] = t < Tn && k < R ? Gz[(size_t)t * R + k] : (T)0;
      }
    }
    T qa[4][4], sx[PER];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[i][j] = (T)0;
#pragma unroll
    for (int e = 0; e < PER; ++e) sx[e] = (T)0;

    for (int s = s_begin; s < s_end; ++s) {
      const T v = valid[s];
      const T* ws = wz + (size_t)s * Tn;
      const T wt = t < Tn ? ws[t] : (T)0;
      T q[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) q[i][j] = (T)0;
      for (int qc = 0; qc < nq; ++qc) {
        const int q0 = qc * KC, ql = min(KC, R - q0);
        __syncthreads();  // the last step's readers of Pt, its X buffer, Pu and Qs are done
        {
          int nqc = qc + 1, ns = s, nrt = rt;
          if (nqc == nq) {
            nqc = 0;
            if (++ns == s_end) {
              ns = s_begin;
              ++nrt;
            }
          }
          if (nrt < nr) {
            const int nq0 = nqc * KC, nr0 = nrt * RC;
            copy_x(step & 1 ? Xk : Xk1, Xz + (size_t)ns * R * R, R, nq0, min(KC, R - nq0), nr0,
                   min(RC, R - nr0));
          } else {
            asm volatile("cp.async.commit_group;" ::);  // none: keep one group per step
          }
        }
        // P = w~ G, rounded once as the plain version's P
        for (int k = row0; k < ql; k += RSTEP)
          Pt[k * BT + col] = wt * (nq == 1 ? Gt[k * BT + col]
                                           : (t < Tn ? Gz[(size_t)t * R + q0 + k] : (T)0));
        if (qc == 0) {
          const T wu = u < Tn ? ws[u] : (T)0;
          for (int r = row0; r < rl; r += RSTEP) Pu[r * BT + col] = wu * Gu[r * BT + col];
        }
        asm volatile("cp.async.wait_group 1;" ::: "memory");  // this step's X chunk
        __syncthreads();
        const T* Xc = step & 1 ? Xk1 : Xk;
        ++step;
        if (diag && qc == tt) {  // this block sums X's q-chunk tt
#pragma unroll
          for (int e = 0; e < PER; ++e) sx[e] = fma(v, Xc[tid + NT * e], sx[e]);
        }
        if (live_t && 4 * tj < rl) tile_fma(Pt, Xc, ql, ti, tj, q);
      }
      // Q_s[t-tile, r-tile] is in q: the diagonal blocks add valid (P - Q),
      // P_s[t, r] being their u-tile's Pu[r][t] (rows r < rl are live; the
      // others are never written out); then valid Q to Qs
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T vq[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (diag) qa[i][j] = fma(v, Pu[(4 * tj + j) * BT + 4 * ti + i] - q[i][j], qa[i][j]);
          vq[i] = v * q[i][j];
        }
        store4(Qs + (4 * tj + j) * BT + 4 * ti, vq);
      }
      __syncthreads();
      if (live_t && live_u) tile_fma(Qs, Pu, rl, ti, tj, acc);
    }

    if (diag) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tr = t0 + 4 * ti + i, r = 4 * tj + j;
          if (tr < Tn && r < rl) pz[(size_t)Tn * Tn + (size_t)tr * R + r0 + r] = qa[i][j];
        }
      if (tt < nq) {
        const int q0 = tt * KC, ql = min(KC, R - q0);
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const int i = tid + NT * e, k = i / RC, r = i - k * RC;
          if (k < ql && r < rl)
            pz[(size_t)Tn * Tn + (size_t)Tn * R + (size_t)(q0 + k) * R + r0 + r] = sx[e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int tr = t0 + 4 * ti + i, uc = u0 + 4 * tj + j;
      if (tr < Tn && uc < Tn) pz[(size_t)tr * Tn + uc] = acc[i][j];
    }
}

// out[z][e] = sum over the chunks, in chunk order, of part[z][c][e], into
// sum_QP (Z, T, T), sum_QA (Z, T, R) and sum_X (Z, R, R)
template <typename T>
__global__ void __launch_bounds__(NTR) hstep_stat_reduce_kernel(
    const T* __restrict__ part, T* __restrict__ qp, T* __restrict__ qa, T* __restrict__ xo,
    int Tn, int R, int chunks, long long ne) {
  const long long e = (long long)blockIdx.x * NTR + threadIdx.x;
  if (e >= ne) return;
  const int z = blockIdx.y;
  const T* p = part + (size_t)z * chunks * ne + e;
  T s = p[0];
  int c = 1;
  // eight loads in flight, added in chunk order
  for (; c + 8 <= chunks; c += 8) {
    T v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = p[(size_t)(c + k) * ne];
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[k];
  }
  for (; c < chunks; ++c) s += p[(size_t)c * ne];
  const long long tt = (long long)Tn * Tn, tr = (long long)Tn * R;
  if (e < tt)
    qp[(size_t)z * tt + e] = s;
  else if (e < tt + tr)
    qa[(size_t)z * tr + (e - tt)] = s;
  else
    xo[(size_t)z * R * R + (e - tt - tr)] = s;
}

template <typename T>
cudaError_t launch(const T* G, const T* w, const T* X, const T* valid, T* part, T* qp, T* qa,
                   T* xo, int Z, int S, int Tn, int R, cudaStream_t st) {
  const Plan p = make_plan(Z, S, Tn, R);
  const size_t smem = (size_t)(2 * BT * KC + 2 * KC * RC + 3 * RC * BT) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(hstep_stat_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.chunks, p.nt * p.nt, Z);
  hstep_stat_kernel<T><<<grid, NT, smem, st>>>(G, w, X, valid, part, S, Tn, R, p.nt, p.nr, p.nq,
                                               p.spc, p.chunks, p.ne);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((unsigned)((p.ne + NTR - 1) / NTR), Z);
  hstep_stat_reduce_kernel<T><<<rgrid, NTR, 0, st>>>(part, qp, qa, xo, Tn, R, p.chunks, p.ne);
  return cudaGetLastError();
}

bool valid_shape(int Z, int S, int T, int R) {
  // the grid's y dimension holds the tile pairs; R <= T, as hstep's rank is
  return Z >= 1 && Z <= 65535 && S >= 1 && T >= 1 && R >= 1 && R <= T &&
         (long long)((T + BT - 1) / BT) * ((T + BT - 1) / BT) <= 65535;
}

}  // namespace

extern "C" {

// The chunks of a call: the second dimension of part (Z, chunks, T^2 + T R
// + R^2); 0 for a shape the kernel does not take.
int hstep_stat_plan(int Z, int S, int T, int R) {
  if (!valid_shape(Z, S, T, R)) return 0;
  return make_plan(Z, S, T, R).chunks;
}

// G (Z, T, R), w (Z, S, T), X (Z, S, R, R), valid (S,), part (Z, chunks,
// T^2 + T R + R^2) scratch, sum_QP (Z, T, T), sum_QA (Z, T, R) and sum_X
// (Z, R, R), all contiguous, float64 when is_double else float32.
int hstep_stat(const void* G, const void* w, const void* X, const void* valid, void* part,
               void* sum_qp, void* sum_qa, void* sum_x, int Z, int S, int T, int R, int is_double,
               void* stream) {
  if (!valid_shape(Z, S, T, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch((const double*)G, (const double*)w, (const double*)X,
                       (const double*)valid, (double*)part, (double*)sum_qp, (double*)sum_qa,
                       (double*)sum_x, Z, S, T, R, st);
  return (int)launch((const float*)G, (const float*)w, (const float*)X, (const float*)valid,
                     (float*)part, (float*)sum_qp, (float*)sum_qa, (float*)sum_x, Z, S, T, R, st);
}

}  // extern "C"
