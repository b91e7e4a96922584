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
// hstep_stat_kernel (T <= 64, the flagship's window-50 segments): a block
// per (latent, chunk of segments), sized to the live shape.  With T and R
// padded to multiples of 4 (tp, rp), sum_QP has ntg^2 4 x 4 tiles and Q
// ntg nrg (ntg = tp / 4, nrg = rp / 4); the block holds one warp per 32
// tiles of each, so every lane but those of the last warp of each kind
// owns a live tile (at T50 R40: 169 and 130 tiles, 6 + 5 warps, 85% of the
// lanes).  The two kinds of warps work a segment apart: while the Q warps
// form Q_s = P_s X_s, store valid_s Q_s' in shared memory and add valid_s
// (P_s - Q_s) and valid_s X_s into registers, the sum_QP warps add valid
// Q_{s-1} P_{s-1}' into theirs, stage P_{s+1} = diag(w~_{s+1}) G (rounded
// once, as the plain version rounds P; G' read from shared memory, where
// the block copies it once, in float32) and start the cp.async copy of a
// later segment's X (three stages in float32, two in float64): one block
// barrier a segment.  P is read from shared memory in three buffers, Q in
// two; X's live R x R only (16-byte copies where R sizeof(T) is a multiple
// of 16).  Each entry is summed in the order of the 64 x 64 kernel before
// it (the chunk map, segments in order within a chunk, r or q in order
// within a segment), so the two give the same bits.
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
// On an H100 (tools/torch_variant_ab.py, in turns) it takes 0.201 ms
// against the 64 x 64 kernel's 0.248 (256 threads over a 64 x 64 tile, of
// which 130 formed Q and 169 summed Q P', three block barriers and P
// staged twice a segment, a 64 x 64 copy of X, 112 KB of shared memory);
// forming P from strided device loads of G every segment, before G' was
// staged in shared memory, cost it a few percent.  Its products issue well
// below one instruction a clock a scheduler: in draft timing builds (not
// in the repo) running each product twice cost about two thirds of the
// kernel's time more, while dropping the B operand's loads saved almost
// nothing, so shared-memory bandwidth does not bind them.  Each k step's
// loads are issued a few FMAs ahead of their use (80 registers leave no
// room for more), and the warps that each phase's barrier releases
// together likely wait on them together.  Tried in such builds and not
// kept, all with the same bits and all slower: 8 x 8 tiles of sum_QP and
// 8 x 4 of Q (a quarter-warp a row of tiles, conflict-free; 5 warps, 168
// registers: too few warps to hide the loads' latency and each warp's
// serial issue), 4 x 8 and 8 x 4 tiles (7 warps, 128 registers and
// spills), sum_X on the sum_QP warps, one block an SM, the tile loop
// unrolled 1, 2 or 8 times in place of 4.  Measured in turns and not
// kept: independent segment groups (tools/variants/hstep_stat_groups.cu:
// 6-warp groups, each forming Q and then adding Q P' for its own segments
// behind its own named barrier) 0.264-0.277 ms, a barrier a segment all
// the same, spills at 80-96 registers, no overlap of the two products;
// the products on the FP64 tensor cores (tools/variants/hstep_stat_tc.cu,
// mma.sync m16n8k16 .f64) 0.348 ms, bound by their float64 operands'
// trips through shared memory and three barriers a segment.
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

constexpr int BT = 64;    // largest T of hstep_stat_kernel; the wide kernel's tiles above
constexpr int RC = 64;    // columns r of Q per r-tile of the wide kernel
constexpr int KC = 64;    // rows q of X per chunk of the wide kernel's contraction Q = P X
constexpr int NTR = 256;  // threads per block of the reduction
// blocks a launch aims at (two per SM of an H100); a constant, so that the
// chunks, and with them the bits, are a function of the shape alone
constexpr int BLOCK_TARGET = 264;

struct Plan {
  int nr, nq, spc, chunks;
  long long ne;
};

// T > 64 takes hstep_stat_wide_kernel (below), T <= 64 hstep_stat_kernel
inline bool is_wide(int T) { return T > BT; }

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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// the X chunk (q0.., r0..) of a segment into dst, element i = tid + NTH e
// of the KC x RC tile (row i / RC), 0 outside the live ql x rl corner: by
// cp.async, committed as one group, so the chunk bypasses the registers and
// arrives while the block works on the chunk before it
template <typename T, int NTH>
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

// ---------------------------------------------------------------------------
// The T <= 64 route: hstep_stat_kernel
// ---------------------------------------------------------------------------

template <typename T>
struct Small;
template <>
struct Small<float> {
  static constexpr int NS = 3;     // stages of X
  static constexpr bool GS = true;  // G' in shared memory
};
template <>
struct Small<double> {
  static constexpr int NS = 2;  // three would not fit beside P and Q at T = R = 64
  static constexpr bool GS = false;  // nor would G': P is staged from device memory
};
constexpr int SMALL_NT_MAX = 512;  // threads at T = R = 64: 8 + 8 warps
// sum_X entries a Q-warp lane holds: R rp <= 16 ntg nrg <= 16 lanes of the Q warps
constexpr int SX_MAX = 16;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

// threads of the sum_QP warps and of the whole block at (T, R)
__host__ __device__ inline int small_prod_threads(int T) {
  const int ntg = pad4(T) / 4;
  return 32 * ((ntg * ntg + 31) / 32);
}
inline int small_threads(int T, int R) {
  const int nq = (pad4(T) / 4) * (pad4(R) / 4);
  return small_prod_threads(T) + 32 * ((nq + 31) / 32);
}
template <typename T>
size_t small_smem(int Tn, int R) {  // P (3 buffers), Q (2) and G' of rp x tp, NS stages of X
  return (size_t)((5 + Small<T>::GS) * pad4(R) * pad4(Tn) + Small<T>::NS * R * pad4(R)) *
         sizeof(T);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// wait until at most NS - 2 of this thread's cp.async groups are pending
template <int NS>
__device__ __forceinline__ void wait_x() {
  if constexpr (NS == 3)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// acc[i][j] = fma(A[k][i], B[k][j], acc[i][j]) for k < n in order: A and B
// 4 wide at row strides lda and ldb
template <typename T>
__device__ __forceinline__ void tile4(const T* __restrict__ A, int lda, const T* __restrict__ B,
                                      int ldb, int n, T (&acc)[4][4]) {
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    T a[4], b[4];
    load4p(A + k * lda, a);
    load4p(B + k * ldb, b);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
  }
}

// Threads [0, nprod) are the sum_QP warps, the rest the Q warps (see the
// head of the file).  Phase k (k = 0 .. n, n segments in the chunk) ends
// in the block's barrier k + 1: the Q warps take segment k (P_k in P
// buffer k % 3, X_k in stage k % NS, valid Q_k' into Q buffer k % 2), the
// sum_QP warps segment k - 1, and stage P_{k+1} and start X_{k+NS-1}.
template <typename T, int NTMAX, int MINB>
__global__ void __launch_bounds__(NTMAX, MINB) hstep_stat_kernel(
    const T* __restrict__ G, const T* __restrict__ w, const T* __restrict__ X,
    const T* __restrict__ valid, T* __restrict__ part, int S, int Tn, int R, int spc, int chunks,
    long long ne, int vec) {
  constexpr int NS = Small<T>::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = pad4(Tn), rp = pad4(R);
  const int ntg = tp / 4, nrg = rp / 4;
  const int nprod = small_prod_threads(Tn);
  const size_t pbuf = (size_t)rp * tp;
  T* Pb = reinterpret_cast<T*>(smem_raw);  // 3 x [rp][tp]: P_s[t, q] at [q][t]
  T* Qb = Pb + 3 * pbuf;                   // 2 x [rp][tp]: valid_s Q_s[t, r] at [r][t]
  T* Xb = Qb + 2 * pbuf;                   // NS x [R][rp]: X_s
  T* Gs = Xb + (size_t)NS * R * rp;        // [rp][tp]: G', where Small<T>::GS
  const int tid = threadIdx.x;
  const int c = blockIdx.x, z = blockIdx.z;
  const int s0 = c * spc, n = min(S, s0 + spc) - s0;
  const T* Gz = G + (size_t)z * Tn * R;
  const T* wz = w + ((size_t)z * S + s0) * Tn;
  const T* Xz = X + ((size_t)z * S + s0) * R * R;
  const T* vz = valid + s0;
  T* pz = part + ((size_t)z * chunks + c) * ne;

  if (tid < nprod) {
    // ---- the sum_QP warps: tile (tg, ug), rows t0.., columns u0.. ----
    const int tg = tid / ntg, t0 = 4 * tg, u0 = 4 * (tid - tg * ntg);
    const bool live = tg < ntg;
    // staging map of P: column pt, rows pq0, pq0 + pstep, ... (threads
    // from pstep tp on stage nothing); a thread's w~[pt] is loaded a phase
    // ahead.  Where Small<T>::GS, each stager first copies its entries of
    // G' to shared memory (it alone reads them: no barrier), so that P is
    // formed from conflict-free shared loads in place of strided device ones
    const int pstep = nprod / tp, pt = tid % tp, pq0 = tid / tp;
    const bool stager = pq0 < pstep;
    auto w_of = [&](int k) { return stager && pt < Tn && k < n ? wz[(size_t)k * Tn + pt] : (T)0; };
    auto g_at = [&](int q) { return pt < Tn ? __ldg(Gz + (size_t)pt * R + q) : (T)0; };
    if (Small<T>::GS && stager)
      for (int q = pq0; q < R; q += pstep) Gs[q * tp + pt] = g_at(q);
    auto stage_p = [&](int b, T wk) {
      T* dst = Pb + b * pbuf;
      if (stager)
        for (int q = pq0; q < R; q += pstep)
          dst[q * tp + pt] = wk * (Small<T>::GS ? Gs[q * tp + pt] : g_at(q));
    };
    auto copy_x_stage = [&](int k) {  // X_k into stage k % NS, one cp.async group a call
      if (k < n) {
        T* dst = Xb + (size_t)(k % NS) * R * rp;
        const T* src = Xz + (size_t)k * R * R;
        if (vec) {
          constexpr int VW = 16 / sizeof(T);
          const int rw = R / VW;
          for (int i = tid; i < R * rw; i += nprod) {
            const int q = i / rw, r = (i - q * rw) * VW;
            cp_async16(dst + q * rp + r, src + q * R + r);
          }
        } else {
          for (int e = tid; e < R * R; e += nprod) {
            const int q = e / R;
            cp_async(dst + q * rp + (e - q * R), src + e);
          }
        }
      }
      asm volatile("cp.async.commit_group;" ::);
    };
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = (T)0;
    for (int k = 0; k < NS - 1; ++k) copy_x_stage(k);
    stage_p(0, w_of(0));
    T wnext = w_of(1);
    wait_x<NS>();
    __syncthreads();
    for (int k = 0; k <= n; ++k) {
      copy_x_stage(k + NS - 1);
      if (k + 1 < n) stage_p((k + 1) % 3, wnext);
      wnext = w_of(k + 2);
      if (k >= 1 && live)
        tile4(Qb + ((k - 1) & 1) * pbuf + t0, tp, Pb + ((k - 1) % 3) * pbuf + u0, tp, R, acc);
      wait_x<NS>();  // X_{k+1} is here
      __syncthreads();
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t0 + i < Tn && u0 + j < Tn) pz[(size_t)(t0 + i) * Tn + u0 + j] = acc[i][j];
    }
  } else {
    // ---- the Q warps: tile (tg, rg) of Q, rows t0.., columns r0.. ----
    const int tq = tid - nprod, nqt = blockDim.x - nprod;
    const int tg = tq / nrg, t0 = 4 * tg, r0 = 4 * (tq - tg * nrg);
    const bool live = tg < ntg;
    T qa[4][4], sx[SX_MAX];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[i][j] = (T)0;
#pragma unroll
    for (int m = 0; m < SX_MAX; ++m) sx[m] = (T)0;
    __syncthreads();
    for (int k = 0; k <= n; ++k) {
      if (k < n) {
        const T v = vz[k];
        const T* Pk = Pb + (k % 3) * pbuf;
        const T* Xk = Xb + (size_t)(k % NS) * R * rp;
        if (live) {
          T q[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) q[i][j] = (T)0;
          tile4(Pk + t0, tp, Xk + r0, rp, R, q);
          T* Qk = Qb + (k & 1) * pbuf;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            T p[4], vq[4];
            load4p(Pk + (r0 + j) * tp + t0, p);  // P_k[t, r]
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              qa[i][j] = fma(v, p[i] - q[i][j], qa[i][j]);
              vq[i] = v * q[i][j];
            }
            store4(Qk + (r0 + j) * tp + t0, vq);
          }
        }
        // sum_X over the padded layout [q][rp]: entries tq + nqt m
#pragma unroll
        for (int m = 0; m < SX_MAX; ++m) {
          const int e = tq + nqt * m;
          if (e < R * rp) sx[m] = fma(v, Xk[e], sx[m]);
        }
      }
      __syncthreads();
    }
    T* qa_out = pz + (size_t)Tn * Tn;
    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (t0 + i < Tn && r0 + j < R) qa_out[(size_t)(t0 + i) * R + r0 + j] = qa[i][j];
    }
    T* sx_out = qa_out + (size_t)Tn * R;
#pragma unroll
    for (int m = 0; m < SX_MAX; ++m) {
      const int e = tq + nqt * m, q = e / rp, r = e - q * rp;
      if (e < R * rp && r < R) sx_out[(size_t)q * R + r] = sx[m];
    }
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
// columns of sum_QP where a 64 x 64 tile would form it once per 64: at
// T1000 R50 its share of the FMA slots is R / (R + BN) ~ 1/6 (1/2 with
// 64 x 64 tiles).  A thread's 8 x 8 tile is two 4-row groups BM / 2 apart
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
  p.nr = (R + RC - 1) / RC;
  p.nq = (R + KC - 1) / KC;
  long long tiles, target;
  if (is_wide(T)) {
    const int bm = dbl ? Wide<double>::BM : Wide<float>::BM;
    const int bn = dbl ? Wide<double>::BN : Wide<float>::BN;
    tiles = (long long)Z * ((T + bm - 1) / bm) * ((T + bn - 1) / bn);
    target = WIDE_TARGET + tiles - 1;  // at least WIDE_TARGET blocks where S allows
  } else {
    tiles = Z;  // one block per (latent, chunk)
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
    // two blocks an SM (registers capped at 85) where a block has at most
    // 384 threads in float32; T = R = 64 (512 threads) and float64 one
    const int nth = small_threads(Tn, R);
    auto kernel = hstep_stat_kernel<T, SMALL_NT_MAX, 1>;
    if constexpr (sizeof(T) == sizeof(float))
      if (nth <= 384) kernel = hstep_stat_kernel<T, 384, 2>;
    const size_t smem = small_smem<T>(Tn, R);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int vec = (R * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(X) % 16 == 0;
    const dim3 grid(p.chunks, 1, Z);
    kernel<<<grid, nth, smem, st>>>(G, w, X, valid, part, S, Tn, R, p.spc, p.chunks, p.ne, vec);
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
