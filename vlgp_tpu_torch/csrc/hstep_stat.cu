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
// Above T = 64 (window=None) hstep_stat_wide_kernel (below) takes the tiles
// instead: each block forms Q once for 256 columns of sum_QP.
//
// hstep_stat_reduce_kernel: the chunks' partial sums, part (Z, C, NE) with
// NE = T^2 + T R + R^2 per latent (sum_QP | sum_QA | sum_X), added in chunk
// order for every entry, written to the three outputs in their layouts
// (above T = 64, sum_X summed from X).  No atomics: every run gives the
// same bits.  The chunk count is a function of the shape alone
// (BLOCK_TARGET, WIDE_TARGET), so the bits do not depend on the card.
//
// What bounds it on this card.  At the flagship (Z5 S2000 T50 R40 float32)
// the function reads X and w~ (64 MB and 2 MB: ~20 us at 3.35 TB/s) and
// does 2 Z S T R (R + T) = 3.6 GFLOP (~54 us at 67 TFLOP/s): FLOPs bind.
// The 64 x 64 tiles hold 50 x 40 (Q) and 50 x 50 (sum_QP) live entries;
// the register tiles of dead rows and columns skip the products, so the
// FMA slots are 52 x 40 and 52 x 52, ~1.3x the useful work; each k step of
// a 4 x 4 tile reads two 16-byte words from shared memory per 16 FMAs.  On
// an H100 it takes 0.25 ms there, ~4.7x the bound, two blocks an SM
// (128 registers; one block an SM, 188 registers, took 0.36 ms).
//
// At T1000 R50 S100 (window=None) the 64 x 64 kernel took 3.6 ms against
// the plain version's 2.06: half its FMA slots recomputed Q.  The wide
// kernel does 3.3e10 FMAs there (Q 20% of them), 0.98 ms at 67 TFLOP/s,
// and takes 2.0 ms with the SM clock at its 1980 MHz, ~49% of the FP32
// rate.  A build that runs each tile product twice takes 1.0 ms more, so
// the products alone run at ~78% of the rate; a build without Q's
// products takes 1.54-1.60 ms, so Q costs ~0.46 ms, and each segment's
// staging and barriers, with the chunks' reduction, the other ~0.5 ms.
// Measured in turns (tools/torch_variant_ab.py) and not kept: Q shared by
// a cluster of 4 (or 2) u-tile blocks through distributed shared memory,
// one cluster barrier a segment (2.50 and 2.12 ms: the barrier couples
// the cluster's SMs), 64 x 256 tiles of 256 threads two blocks an SM with
// P staged from G' in device memory (3.15 and 3.53 ms), 128 x 128 tiles of
// 256 threads (2.66-2.87 ms), the next k's operands loaded ahead by hand
// (+0.06 ms), a warp over 16 x 2 threads of the grid (2.06 ms), sum_QA in
// the tiles' registers (spills: 2.1-2.4 ms), 3 or 6 waves of chunks in
// place of 4 (+0.07 and +0.10 ms), and Q formed from the staged G with w~
// applied after, P_s[t-tile] never staged, three barriers a segment (2.05
// against 2.01 ms).

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

// T > 64 takes hstep_stat_wide_kernel (below), T <= 64 the 64 x 64 kernel
inline bool is_wide(int T) { return T > BT; }

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

// the X chunk (q0.., r0..) of a segment into dst, element i = tid + NTH e
// of the KC x RC tile (row i / RC), 0 outside the live ql x rl corner: by
// cp.async, committed as one group, so the chunk bypasses the registers and
// arrives while the block works on the chunk before it
template <typename T, int NTH = NT>
__device__ __forceinline__ void copy_x(T* dst, const T* __restrict__ Xs, int R, int q0, int ql,
                                       int r0, int rl) {
#pragma unroll
  for (int e = 0; e < KC * RC / NTH; ++e) {
    const int i = threadIdx.x + NTH * e, k = i / RC, r = i - k * RC;
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

// ---------------------------------------------------------------------------
// The T > 64 route: hstep_stat_wide_kernel
//
// A block of NTW threads per (latent, BM x BN tile of sum_QP, chunk of
// segments): float32 128 x 256 with 512 threads (8 x 8 register tiles, one
// block an SM: 224 KB of shared memory), float64 64 x 64 with 256 threads
// (4 x 4).  Per r-tile and segment the block forms Q_s[t-tile, r-tile]
// once (4 x 4 register tiles over its BM x 64 corner) and adds valid_s Q_s
// P_s[u-tile]' into its BM x BN accumulators, so Q is formed once per BN
// columns of sum_QP where the T <= 64 kernel forms it once per 64: at
// T1000 R50 its share of the FMA slots is R / (R + BN) ~ 1/6 (1/2 in the
// T <= 64 kernel).  A thread's 8 x 8 tile is two 4-row groups BM / 2 apart
// by two 4-column groups BN / 2 apart, and a warp holds 4 x 8 threads of
// the grid, so per k step its 4 16-byte reads of Qs and Pu are 4
// shared-memory wavefronts for 64 FMAs.  G[t-tile] (R <= 64) and
// G[u-tile, r-tile] are staged once per r-tile, so P = w~ G is formed from
// shared memory every segment.
//
// The sum_QA blocks (blockIdx.y >= nt nu, one per t-tile and chunk) form
// Q once more for their t rows and add valid_s (P_s - Q_s), P_s[t, r] =
// w~_s[t] G[t, r] rounded as the staged P; with the sums in their own
// blocks, a tile's block holds no more than its accumulators and Q in
// registers.  sum_X = sum_s valid_s X_s is added by the reduction launch
// straight from X, in segment order.  P and Q stay in shared memory and
// registers; the chunk count is a function of the shape alone
// (WIDE_TARGET).
// ---------------------------------------------------------------------------

template <typename T>
struct Wide;
template <>
struct Wide<float> {
  static constexpr int BM = 128, BN = 256, NTW = 512, TM = 8, TN = 8;
};
template <>
struct Wide<double> {
  static constexpr int BM = 64, BN = 64, NTW = 256, TM = 4, TN = 4;
};
// blocks a wide launch aims at: four waves of one block per SM of an
// H100, a constant, so that the chunks are a function of the shape alone
constexpr int WIDE_TARGET = 4 * 132;

__device__ __forceinline__ void load4p(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4p(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// acc[4 g + i][4 h + j] += sum_{k < n} A[k][4 ti + i + SA g] B[k][4 tj + j +
// SB h]: A rows LDA wide, B rows LDB wide, k in increasing order
template <typename T, int GM, int GN, int LDA, int LDB, int SA, int SB, int UNROLL>
__device__ __forceinline__ void tile_fma_g(const T* __restrict__ A, const T* __restrict__ B,
                                           int n, int ti, int tj, T (&acc)[4 * GM][4 * GN]) {
#pragma unroll UNROLL
  for (int k = 0; k < n; ++k) {
    T a[4 * GM], b[4 * GN];
#pragma unroll
    for (int g = 0; g < GM; ++g) load4p(A + k * LDA + 4 * ti + SA * g, a + 4 * g);
#pragma unroll
    for (int h = 0; h < GN; ++h) load4p(B + k * LDB + 4 * tj + SB * h, b + 4 * h);
#pragma unroll
    for (int i = 0; i < 4 * GM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * GN; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// One block's pass of the wide route over its chunk of segments.  QA false:
// a BM x BN tile (tt, tu) of sum_QP; QA true: the BM rows of t-tile tt of
// sum_QA, Q formed once more for them.  The two are separate instances, so
// neither holds the other's accumulators in registers.
template <typename T, bool QA>
__device__ __forceinline__ void wide_pass(
    const T* __restrict__ G, const T* __restrict__ w, const T* __restrict__ X,
    const T* __restrict__ valid, T* __restrict__ pz, int S, int Tn, int R, int nr, int nq,
    int s_begin, int s_end, int z, int tt, int tu, unsigned char* smem_raw) {
  constexpr int BM = Wide<T>::BM, BN = Wide<T>::BN, NTW = Wide<T>::NTW;
  constexpr int GM = Wide<T>::TM / 4, GN = Wide<T>::TN / 4;
  constexpr int MT = BM / Wide<T>::TM;      // thread rows of the sum_QP tile
  constexpr int QG = BM * RC / (16 * NTW);  // 4-row groups of a thread's Q tile
  constexpr int QT = BM / (4 * QG);         // thread rows of the Q tile
  static_assert(MT * (BN / Wide<T>::TN) == NTW && QT * (RC / 4) == NTW, "thread maps");
  static_assert(NTW % BM == 0 && NTW % BN == 0 && KC == RC && QT % 8 == 0, "maps");
  T* Pt = reinterpret_cast<T*>(smem_raw);  // [k][t]: P_s[t-tile, q-chunk]; then Qs [r][t]
  T* Pu = Pt + KC * BM;                     // [r][u]: P_s[u-tile, r-tile]
  T* Gt = Pu + RC * BN;                     // [k][t]: G[t-tile, q-chunk] when nq == 1
  T* Gu = Gt + KC * BM;                     // [r][u]: G[u-tile, r-tile]
  T* Xk = Gu + RC * BN;                     // [k][r]: X_s[q-chunk, r-tile], two buffers
  T* Xk1 = Xk + KC * RC;
  const int tid = threadIdx.x;
  // sum_QP map: a warp holds 4 x 8 of the MT x BN / TN thread grid, so
  // that its lanes read 4 words of Qs and 8 of Pu per k step
  const int ti = (tid / 32 % (MT / 4)) * 4 + tid % 4, tj = (tid / 32 / (MT / 4)) * 8 + tid % 32 / 4;
  // Q map: a warp holds 8 x 4 of the QT x RC / 4 thread grid, so that its
  // lanes read 8 words of Pt and 4 of X per k step
  const int lane = tid % 32, wq = tid / 32;
  const int qi = (wq % (QT / 8)) * 8 + lane % 8, qj = (wq / (QT / 8)) * 4 + lane / 8;
  const int t0 = tt * BM, u0 = tu * BN;
  const T* Gz = G + (size_t)z * Tn * R;
  const T* wz = w + (size_t)z * S * Tn;
  const T* Xz = X + (size_t)z * S * R * R;
  // staging maps: column tid % BM (t) or tid % BN (u), rows every NTW / BM
  // or NTW / BN; Gt and Gu are written and read by the same thread under
  // them, so they need no barrier of their own
  const int ct = tid % BM, rt0 = tid / BM, cu = tid % BN, ru0 = tid / BN;
  constexpr int TSTEP = NTW / BM, USTEP = NTW / BN;
  const int t = t0 + ct, u = u0 + cu;
  const bool live_t = 4 * ti < Tn - t0, live_u = 4 * tj < Tn - u0, live_q = 4 * qi < Tn - t0;

  T acc[QA ? 1 : 4 * GM][QA ? 1 : 4 * GN];
  if constexpr (!QA) {
#pragma unroll
    for (int i = 0; i < 4 * GM; ++i)
#pragma unroll
      for (int j = 0; j < 4 * GN; ++j) acc[i][j] = (T)0;
  }
  copy_x<T, NTW>(Xk, Xz + (size_t)s_begin * R * R, R, 0, min(KC, R), 0, min(RC, R));
  int step = 0;

  for (int rt = 0; rt < nr; ++rt) {
    const int r0 = rt * RC, rl = min(RC, R - r0);
    if (!QA)
      for (int r = ru0; r < RC; r += USTEP)
        Gu[r * BN + cu] = u < Tn && r < rl ? Gz[(size_t)u * R + r0 + r] : (T)0;
    if (nq == 1)
      for (int k = rt0; k < KC; k += TSTEP)
        Gt[k * BM + ct] = t < Tn && k < R ? Gz[(size_t)t * R + k] : (T)0;
    T qa[QA ? 4 * QG : 1][4];
    if constexpr (QA) {
#pragma unroll
      for (int i = 0; i < 4 * QG; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) qa[i][j] = (T)0;
    }

    for (int s = s_begin; s < s_end; ++s) {
      const T v = valid[s];
      const T* ws = wz + (size_t)s * Tn;
      const T wt = t < Tn ? ws[t] : (T)0;
      T q[4 * QG][4];
#pragma unroll
      for (int i = 0; i < 4 * QG; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) q[i][j] = (T)0;
      for (int qc = 0; qc < nq; ++qc) {
        const int q0 = qc * KC, ql = min(KC, R - q0);
        __syncthreads();  // the last step's readers of Pt / Qs, its X buffer and Pu are done
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
            copy_x<T, NTW>(step & 1 ? Xk : Xk1, Xz + (size_t)ns * R * R, R, nq0,
                           min(KC, R - nq0), nr0, min(RC, R - nr0));
          } else {
            asm volatile("cp.async.commit_group;" ::);  // none: keep one group per step
          }
        }
        // P = w~ G, rounded once as the plain version's P
        for (int k = rt0; k < ql; k += TSTEP)
          Pt[k * BM + ct] = wt * (nq == 1 ? Gt[k * BM + ct]
                                          : (t < Tn ? Gz[(size_t)t * R + q0 + k] : (T)0));
        if (!QA && qc == 0) {
          const T wu = u < Tn ? ws[u] : (T)0;
          for (int r = ru0; r < rl; r += USTEP) Pu[r * BN + cu] = wu * Gu[r * BN + cu];
        }
        asm volatile("cp.async.wait_group 1;" ::: "memory");  // this step's X chunk
        __syncthreads();
        const T* Xc = step & 1 ? Xk1 : Xk;
        ++step;
        if (live_q && 4 * qj < rl)
          tile_fma_g<T, QG, 1, BM, RC, BM / QG, 0, 4>(Pt, Xc, ql, qi, qj, q);
      }
      if constexpr (QA) {
        // Q_s[t-tile, r-tile] is in q: add valid (P - Q), P_s[t, r] from Pt
        // (R <= 64: its one q-chunk is the r-tile) or formed as Pt forms it
#pragma unroll
        for (int g = 0; g < QG; ++g)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int tb = 4 * qi + i + (BM / QG) * g, tr = t0 + tb;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int r = 4 * qj + j;
              if (tr < Tn && r < rl) {
                const T p = nq == 1 ? Pt[r * BM + tb] : ws[tr] * Gz[(size_t)tr * R + r0 + r];
                qa[4 * g + i][j] = fma(v, p - q[4 * g + i][j], qa[4 * g + i][j]);
              }
            }
          }
      } else {
        __syncthreads();  // every reader of Pt is done: Qs takes its place
        T* Qs = Pt;
#pragma unroll
        for (int g = 0; g < QG; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            T vq[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) vq[i] = v * q[4 * g + i][j];
            store4(Qs + (4 * qj + j) * BM + 4 * qi + (BM / QG) * g, vq);
          }
        __syncthreads();
        if (live_t && live_u)
          tile_fma_g<T, GM, GN, BM, BN, BM / GM, BN / GN, 2>(Qs, Pu, rl, ti, tj, acc);
      }
    }

    if constexpr (QA) {
#pragma unroll
      for (int g = 0; g < QG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tr = t0 + 4 * qi + i + (BM / QG) * g, r = 4 * qj + j;
            if (tr < Tn && r < rl)
              pz[(size_t)Tn * Tn + (size_t)tr * R + r0 + r] = qa[4 * g + i][j];
          }
    }
  }
  if constexpr (!QA) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < GN; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int tr = t0 + 4 * ti + i + (BM / GM) * g;
            const int uc = u0 + 4 * tj + j + (BN / GN) * h;
            if (tr < Tn && uc < Tn) pz[(size_t)tr * Tn + uc] = acc[4 * g + i][4 * h + j];
          }
  }
}

// blockIdx.y < nt nu: the tile pair (y / nu, y % nu) of sum_QP; above, the
// t-tile y - nt nu of sum_QA
template <typename T>
__global__ void __launch_bounds__(Wide<T>::NTW, 1) hstep_stat_wide_kernel(
    const T* __restrict__ G, const T* __restrict__ w, const T* __restrict__ X,
    const T* __restrict__ valid, T* __restrict__ part, int S, int Tn, int R, int nt, int nu,
    int nr, int nq, int spc, int chunks, long long ne) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int c = blockIdx.x, z = blockIdx.z, y = blockIdx.y;
  const int s_begin = c * spc, s_end = min(S, s_begin + spc);
  T* pz = part + ((size_t)z * chunks + c) * ne;
  if (y >= nt * nu)
    wide_pass<T, true>(G, w, X, valid, pz, S, Tn, R, nr, nq, s_begin, s_end, z, y - nt * nu, 0,
                       smem_raw);
  else
    wide_pass<T, false>(G, w, X, valid, pz, S, Tn, R, nr, nq, s_begin, s_end, z, y / nu, y % nu,
                        smem_raw);
}

// out[z][e] = sum over the chunks, in chunk order, of part[z][c][e], into
// sum_QP (Z, T, T), sum_QA (Z, T, R) and sum_X (Z, R, R); with x_direct
// (the wide route) sum_X is sum_s valid_s X_s in segment order instead
template <typename T>
__global__ void __launch_bounds__(NTR) hstep_stat_reduce_kernel(
    const T* __restrict__ part, const T* __restrict__ X, const T* __restrict__ valid,
    T* __restrict__ qp, T* __restrict__ qa, T* __restrict__ xo, int S, int Tn, int R,
    int chunks, long long ne, int x_direct) {
  const long long e = (long long)blockIdx.x * NTR + threadIdx.x;
  if (e >= ne) return;
  const int z = blockIdx.y;
  const long long tt = (long long)Tn * Tn, tr = (long long)Tn * R;
  if (x_direct && e >= tt + tr) {
    const long long rr = (long long)R * R, f = e - tt - tr;
    const T* x = X + (size_t)z * S * rr + f;
    T s = (T)0;
    for (int k = 0; k < S; ++k) s = fma(valid[k], x[(size_t)k * rr], s);
    xo[(size_t)z * rr + f] = s;
    return;
  }
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
  if (e < tt)
    qp[(size_t)z * tt + e] = s;
  else if (e < tt + tr)
    qa[(size_t)z * tr + (e - tt)] = s;
  else
    xo[(size_t)z * R * R + (e - tt - tr)] = s;
}

inline Plan make_plan(int Z, int S, int T, int R, bool dbl) {
  Plan p;
  p.nt = (T + BT - 1) / BT;
  p.nr = (R + RC - 1) / RC;
  p.nq = (R + KC - 1) / KC;
  long long tiles, target;
  if (is_wide(T)) {
    const int bm = dbl ? Wide<double>::BM : Wide<float>::BM;
    const int bn = dbl ? Wide<double>::BN : Wide<float>::BN;
    tiles = (long long)Z * ((T + bm - 1) / bm) * ((T + bn - 1) / bn);
    target = WIDE_TARGET + tiles - 1;  // at least WIDE_TARGET blocks where S allows
  } else {
    tiles = (long long)Z * p.nt * p.nt;
    target = BLOCK_TARGET;
  }
  long long want = target / tiles;
  want = want < 1 ? 1 : (want > S ? S : want);
  p.spc = (int)((S + want - 1) / want);
  p.chunks = (S + p.spc - 1) / p.spc;
  p.ne = (long long)T * T + (long long)T * R + (long long)R * R;
  return p;
}

template <typename T>
cudaError_t launch(const T* G, const T* w, const T* X, const T* valid, T* part, T* qp, T* qa,
                   T* xo, int Z, int S, int Tn, int R, cudaStream_t st) {
  const Plan p = make_plan(Z, S, Tn, R, sizeof(T) == sizeof(double));
  const bool wide = is_wide(Tn);
  cudaError_t err;
  if (wide) {
    constexpr int BM = Wide<T>::BM, BN = Wide<T>::BN;
    const size_t smem = (size_t)(2 * KC * BM + 2 * RC * BN + 2 * KC * RC) * sizeof(T);
    err = cudaFuncSetAttribute(hstep_stat_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int nt = (Tn + BM - 1) / BM, nu = (Tn + BN - 1) / BN;
    const dim3 grid(p.chunks, nt * nu + nt, Z);
    hstep_stat_wide_kernel<T><<<grid, Wide<T>::NTW, smem, st>>>(
        G, w, X, valid, part, S, Tn, R, nt, nu, p.nr, p.nq, p.spc, p.chunks, p.ne);
  } else {
    const size_t smem = (size_t)(2 * BT * KC + 2 * KC * RC + 3 * RC * BT) * sizeof(T);
    err = cudaFuncSetAttribute(hstep_stat_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.chunks, p.nt * p.nt, Z);
    hstep_stat_kernel<T><<<grid, NT, smem, st>>>(G, w, X, valid, part, S, Tn, R, p.nt, p.nr,
                                                 p.nq, p.spc, p.chunks, p.ne);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((unsigned)((p.ne + NTR - 1) / NTR), Z);
  hstep_stat_reduce_kernel<T><<<rgrid, NTR, 0, st>>>(part, X, valid, qp, qa, xo, S, Tn, R,
                                                     p.chunks, p.ne, (int)wide);
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
int hstep_stat_plan(int Z, int S, int T, int R, int is_double) {
  if (!valid_shape(Z, S, T, R)) return 0;
  return make_plan(Z, S, T, R, is_double != 0).chunks;
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
