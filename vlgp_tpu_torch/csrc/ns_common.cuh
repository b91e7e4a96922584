// Device routines shared by the port's kernels (ns_inverse.cu, sweep.cu,
// spd_inverse.cu; the bulk copy and its wait, mstep.cu and estep.cu; the
// staging of spans through a ring, estep.cu and ns_inverse.cu's streaming
// path): a NaN-propagating max, warp and block reductions, a bulk copy to
// shared memory completing on an mbarrier, the wait on one, spans of any
// address staged by bulk copies with their ragged ends by plain loads, and
// the register-tiled Newton-Schulz pieces X <- X (2I - M X), the Gram build
// M = I + G' diag(w) G streamed over T and v = diag(G X G'): a thread owns
// a 4 x 4 tile of a padded product in 16 registers and reads two 16-byte
// words per 16 FMAs (see "Register-tiled routines" below).  Then the pair
// index map and the GEMM tile of ns_gram's long-T design ("Pair-form GEMM
// routines").
//
// Every routine is called by all threads of the block with block-uniform
// arguments, so each __syncthreads is reached by all of them.  Every
// multiply is a full float32 FMA: no TF32 and no bf16.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace vlgp {

constexpr int TC = 32;          // rows of G per streamed chunk
constexpr int RMAX = 128;       // largest R the kernels take
constexpr float RESID_TOL = 1e-2f;  // vlgp_tpu/ops/spd.py:_RESID_TOL

// max that returns NaN when either operand is NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A bulk copy (the tensor memory accelerator) of bytes from global src to
// shared dst, both 16-byte aligned, bytes a multiple of 16, completing on
// the mbarrier bar.  One thread.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned m = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(d), "l"(src), "r"(bytes), "r"(m)
      : "memory");
}

// wait until the mbarrier bar has completed the phase of parity `parity`;
// a copy that never completes traps rather than hangs
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned m = (unsigned)__cvta_generic_to_shared(bar);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, "
        "p; }"
        : "=r"(done)
        : "r"(m), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1ll << 26)) __trap();
  }
}

// Bytes of a slot for `count` values of T staged from any address: the
// values start at the slot's byte (address mod 16).
template <typename T>
__host__ __device__ inline size_t span_slot(long long count) {
  return ((size_t)count * sizeof(T) + 15) / 16 * 16 + 16;
}

// where the value staged from src lives in a slot
template <typename T>
__device__ __forceinline__ T* in_slot(unsigned char* slot, const T* src) {
  return reinterpret_cast<T*>(slot + (reinterpret_cast<uintptr_t>(src) & 15));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// arrive on bar, first raising the bytes its phase waits for by tx
__device__ __forceinline__ void bar_arrive(unsigned long long* bar, unsigned tx = 0) {
  if (tx)
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
                 "r"(tx)
                 : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}
// The span src[0, n) as it is staged: the 16-byte aligned interior [lo, hi)
// (empty where the span holds no whole 16-byte word) and the values before
// and after it, [0, head) and [tail, n).
struct SpanCut {
  uintptr_t lo, hi;
  long long head, tail;
};
template <typename T>
__device__ __forceinline__ SpanCut span_cut(const T* src, long long n) {
  constexpr long long V = 16 / sizeof(T);
  const uintptr_t p = reinterpret_cast<uintptr_t>(src), e = p + (uintptr_t)n * sizeof(T);
  SpanCut c{(p + 15) & ~(uintptr_t)15, e & ~(uintptr_t)15, 0, 0};
  if (c.hi > c.lo) {
    c.head = (long long)(c.lo - p) / (long long)sizeof(T);
    c.tail = (long long)(c.hi - p) / (long long)sizeof(T);
  } else {  // under 32 bytes: all by plain loads, at most 2 V - 1 values
    c.head = n < V ? n : V;
    c.tail = c.head;
  }
  return c;
}

// One lane's part of a stage: its spans' ragged values by plain loads (each
// span's issued together), then one arrive on full expecting its bulk
// bytes, then the interiors by bulk copies.  Every lane of the producer
// warp arrives once (full counts 32).  span(i, slot, src, n) names span i.
template <typename T, typename Span>
__device__ void stage_spans(int nspans, Span span, unsigned long long* full, int lane) {
  constexpr int V = 16 / sizeof(T);
  unsigned tx = 0;
  for (int i = lane; i < nspans; i += 32) {
    unsigned char* slot;
    const T* src;
    long long n;
    span(i, slot, src, n);
    const SpanCut c = span_cut(src, n);
    T* dst = in_slot(slot, src);
    T h[V], t[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      h[j] = j < c.head ? __ldg(src + j) : T(0);
      t[j] = c.tail + j < n ? __ldg(src + c.tail + j) : T(0);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (j < c.head) dst[j] = h[j];
      if (c.tail + j < n) dst[c.tail + j] = t[j];
    }
    if (c.hi > c.lo) tx += (unsigned)(c.hi - c.lo);
  }
  bar_arrive(full, tx);
  for (int i = lane; i < nspans; i += 32) {
    unsigned char* slot;
    const T* src;
    long long n;
    span(i, slot, src, n);
    const SpanCut c = span_cut(src, n);
    if (c.hi > c.lo)
      bulk_copy(slot + (c.lo - (reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15)),
                reinterpret_cast<const void*>(c.lo), (unsigned)(c.hi - c.lo), full);
  }
}

// ---------------------------------------------------------------------------
// Register-tiled routines
//
// An R x R matrix lives in shared memory padded to 4 nb rows of stride ld
// floats, nb = ceil(R / 4) and ld = padded_ld(R); the pad is zeroed by the
// kernel before the first routine runs and every store below writes 0 to
// it, so it stays zero (2I - M X puts its 2 only on the R real diagonal
// entries).  Row sums, residuals and every copy to device memory read only
// the R x R corner, and no product reads a pad entry into a real one (the
// k loops stop at R).
//
// The block has nb^2 threads rounded up to a warp (blockDim.x); thread t <
// nb^2 owns the 4 x 4 tile of rows 4 ti.., columns 4 tj.. of a product,
// with (ti, tj) = (t % nb, t / nb), or (t / nb, t % nb) where consecutive
// threads should write consecutive columns; threads past nb^2 own no tile
// and only join the barriers and reductions.
//
// A product C = P Q reads P transposed (Pt, whose row k is P's column k)
// and Q by rows: per k one 16-byte load from each and 16 FMAs, with no
// index division in the loop.  Each entry sums over k in increasing order.
// ---------------------------------------------------------------------------

__host__ __device__ inline int tiles_per_side(int R) { return (R + 3) / 4; }

// Row stride of a padded matrix: 4 nb rounded up to an odd number of
// 16-byte words (R = 40: 44, R = 50: 52, R = 128: 132).  Rows are 16-byte
// aligned for the float4 loads, and the first rows of two consecutive tiles
// (4 rows apart) start in opposite halves of the 32 banks, which halves the
// conflicts of a tile stored by rows when ti runs fastest.
__host__ __device__ inline int padded_ld(int R) { return 4 * (tiles_per_side(R) | 1); }

// Threads of a tiled block: nb^2 rounded up to a warp (1024 at R = 128).
__host__ __device__ inline int tiled_threads(int R) {
  const int nb = tiles_per_side(R);
  return (nb * nb + 31) / 32 * 32;
}

// Block-wide NaN-propagating max over nwarp warps; every thread receives
// the result.  `red` holds nwarp floats of shared memory.
__device__ __forceinline__ float block_max_n(float x, float* red, int nwarp) {
  for (int o = 16; o > 0; o >>= 1) x = nanmax(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) red[wid] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < nwarp; ++i) r = nanmax(r, red[i]);
  return r;
}

// This thread's tile; false for a thread past the nb^2 tiles.
__device__ __forceinline__ bool my_tile(int nb, bool tj_fast, int& ti, int& tj) {
  const int t = threadIdx.x, a = t % nb, b = t / nb;
  ti = tj_fast ? b : a;
  tj = tj_fast ? a : b;
  return t < nb * nb;
}

// acc = tile (ti, tj) of P Q, k < K, with row strides ldp of Pt and ldq of Q.
__device__ __forceinline__ void mm_tile(const float* Pt, int ldp, const float* Q, int ldq,
                                        int K, int ti, int tj, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* pp = Pt + 4 * ti;
  const float* qq = Q + 4 * tj;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(pp + k * ldp);
    const float4 b = *reinterpret_cast<const float4*>(qq + k * ldq);
    const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Store tile (ti, tj) to C by rows (C[r][q] = v[i][j]), 0 outside R x R.
__device__ __forceinline__ void store_rows(float* C, int R, int ld, int ti, int tj,
                                           const float (&v)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ti + i;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = (r < R && 4 * tj + j < R) ? v[i][j] : 0.f;
    *reinterpret_cast<float4*>(C + r * ld + 4 * tj) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Store tile (ti, tj) to Ct transposed (Ct[q][r] = v[i][j]), 0 outside R x R.
__device__ __forceinline__ void store_cols(float* Ct, int R, int ld, int ti, int tj,
                                           const float (&v)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = 4 * tj + j;
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = (q < R && 4 * ti + i < R) ? v[i][j] : 0.f;
    *reinterpret_cast<float4*>(Ct + q * ld + 4 * ti) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Cold start X = c I (X and Xt) with c = 2 / (1 + max row-sum of |M|), M
// given transposed; X and Xt must be zero.  The caller synchronises after.
__device__ inline void ns_cold_start_tiled(const float* Mt, float* X, float* Xt, int R, int ld,
                                    float* red) {
  float m = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < R; ++k) s += fabsf(Mt[k * ld + r]);
    m = nanmax(m, s);
  }
  const float c = 2.f / (1.f + block_max_n(m, red, blockDim.x / 32));
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    X[r * ld + r] = c;
    Xt[r * ld + r] = c;
  }
}

// `iters` Newton-Schulz rounds X <- X (2I - M X), with X kept both by rows
// (X) and transposed (Xt).  The first product's T = 2I - M X overwrites X
// (the second product reads only Xt and T), then X (2I - M X) is stored to
// both.  X and Xt must be complete on entry; they are complete on exit.
__device__ inline void ns_iterate_tiled(const float* Mt, float* X, float* Xt, int R, int ld,
                                 int iters) {
  const int nb = tiles_per_side(R);
  float acc[4][4];
  int ti, tj;
  for (int it = 0; it < iters; ++it) {
    // M X, with consecutive threads on consecutive columns of T
    bool own = my_tile(nb, true, ti, tj);
    if (own) mm_tile(Mt, ld, X, ld, R, ti, tj, acc);
    __syncthreads();  // every read of X is done
    if (own) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = (4 * ti + i == 4 * tj + j ? 2.f : 0.f) - acc[i][j];
      store_rows(X, R, ld, ti, tj, acc);
    }
    __syncthreads();
    // X (2I - M X), with consecutive threads on consecutive rows (Xt's columns)
    own = my_tile(nb, false, ti, tj);
    if (own) mm_tile(Xt, ld, X, ld, R, ti, tj, acc);
    __syncthreads();  // every read of Xt and T is done
    if (own) {
      store_rows(X, R, ld, ti, tj, acc);
      store_cols(Xt, R, ld, ti, tj, acc);
    }
    __syncthreads();
  }
}

// Block-wide max|M X - I| (NaN-propagating) over the R x R corner; every
// thread receives it.
__device__ inline float ns_residual_tiled(const float* Mt, const float* X, int R, int ld,
                                   float* red) {
  int ti, tj;
  float m = 0.f;
  if (my_tile(tiles_per_side(R), false, ti, tj)) {
    float acc[4][4];
    mm_tile(Mt, ld, X, ld, R, ti, tj, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * ti + i, q = 4 * tj + j;
        if (r < R && q < R) m = nanmax(m, fabsf(acc[i][j] - (r == q ? 1.f : 0.f)));
      }
  }
  return block_max_n(m, red, blockDim.x / 32);
}

// Mt = (I + Gz' diag(w) Gz) transposed, rows of Gz (T x R) and w (T)
// streamed through the chunks Gc (TC rows of stride 4 nb, zero past R) and
// wc (TC): per row t one 16-byte load each of G[t, 4 ti..] and G[t, 4 tj..]
// and one of w[t] per 16 FMAs.  Mt is complete (synchronised) on exit.
__device__ inline void gram_build_tiled(const float* Gz, const float* w, int T, int R, int ld,
                                 float* Mt, float* Gc, float* wc) {
  const int nb = tiles_per_side(R), rp = 4 * nb;
  const int tid = threadIdx.x, nt = blockDim.x;
  int ti, tj;
  const bool own = my_tile(nb, false, ti, tj);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < tc * rp; i += nt) {
      const int t = i / rp, c = i - t * rp;
      Gc[i] = c < R ? Gz[(size_t)(t0 + t) * R + c] : 0.f;
    }
    for (int i = tid; i < tc; i += nt) wc[i] = w[t0 + i];
    __syncthreads();
    if (own) {
      for (int t = 0; t < tc; ++t) {
        const float4 a = *reinterpret_cast<const float4*>(Gc + t * rp + 4 * ti);
        const float4 b = *reinterpret_cast<const float4*>(Gc + t * rp + 4 * tj);
        const float wt = wc[t];
        const float aw[4] = {a.x * wt, a.y * wt, a.z * wt, a.w * wt};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(aw[i], bv[j], acc[i][j]);
      }
    }
  }
  if (own) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += (4 * ti + i == 4 * tj + j ? 1.f : 0.f);
    store_cols(Mt, R, ld, ti, tj, acc);
  }
  __syncthreads();
}

// v_t = G_t X G_t' for t < T from X by rows (stride ld).  Per chunk of TC
// rows, G goes to Gct transposed (4 nb rows of TC, zero past R and past the
// chunk's tc rows); each thread takes tiles (ti, tj) of Y = G_chunk X as in
// mm_tile, sums Y[t, q] G[t, q] over the tile's four columns for its four
// rows into part[tj][t] (nb x TC), and each row t then adds its nb partial
// sums in order of tj: a fixed order, so repeated runs give the same bits.
__device__ inline void marginal_v_tiled(const float* Gz, const float* X, int T, int R,
                                        int ld, float* Gct, float* part, float* v) {
  const int nb = tiles_per_side(R), rp = 4 * nb;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();  // the previous chunk's Gct and part are consumed
    for (int i = tid; i < rp * TC; i += nt) {
      const int r = i / TC, t = i - r * TC;
      Gct[i] = (r < R && t < tc) ? Gz[(size_t)(t0 + t) * R + r] : 0.f;
    }
    __syncthreads();
    const int ntile = (tc + 3) / 4 * nb;
    for (int tile = tid; tile < ntile; tile += nt) {
      const int ti = tile / nb, tj = tile - ti * nb;
      float acc[4][4];
      mm_tile(Gct, TC, X, ld, R, ti, tj, acc);
      float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 g = *reinterpret_cast<const float4*>(Gct + (4 * tj + j) * TC + 4 * ti);
        const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = fmaf(acc[i][j], gv[i], p[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) part[tj * TC + 4 * ti + i] = p[i];
    }
    __syncthreads();
    for (int t = tid; t < tc; t += nt) {
      float s = 0.f;
      for (int j = 0; j < nb; ++j) s += part[j * TC + t];
      v[t0 + t] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// Warp routines (ns_gram's streaming path, ns_inverse.cu)
//
// One warp solves one matrix, with no barrier but __syncwarp: lane t <
// nw^2, nw = ceil(R / 8), owns the 8 x 8 tile (ti, tj) = (t / nw, t % nw)
// of every product in 64 registers and reads four 16-byte words per 64
// FMAs (a 4 x 4 tile reads two per 16).  A matrix is padded to np = 8 nw
// rows and columns, its pad zero (stores write 0 outside R x R); column c
// of a row lives at scol(c) = c + 4 (c / 32), so that the 8-column groups
// of a row (lanes' tiles) fall in distinct banks, and a row's stride is
// ld = scol(np - 1) + 1 (R = 40: 40 rows of 44).  Every entry of the Gram, of a product, of the
// residual and of v sums over k in the block routines' order, so a matrix
// comes out with the same bits whichever routine set ran it.  G stays in
// shared memory for the block's life, by rows (Gr: T rows of np, zero past
// R) for the Gram and transposed (Gt: np rows of tp >= T, zero past R and
// past T) for v, which keeps the 4 x 4 tiles of marginal_v_tiled.
// ---------------------------------------------------------------------------

__host__ __device__ inline int warp_tiles(int R) { return (R + 7) / 8; }
__host__ __device__ inline int scol(int c) { return c + 4 * (c >> 5); }
__host__ __device__ inline int warp_ld(int R) { return scol(8 * warp_tiles(R) - 1) + 1; }

// NaN-propagating max over the warp; every lane receives it
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// the 8 floats at p (16-byte aligned)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z,
  v[7] = b.w;
}

// acc += av bv' (8 x 8), one FMA each
__device__ __forceinline__ void outer8(const float (&av)[8], const float (&bv)[8],
                                       float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// acc = tile (ti, tj) of P Q (8 x 8), k < K (K >= 1), strides ldp of Pt and
// ldq of Q.  Two rows a step in two sets of registers, each row's words
// loaded a row ahead of its 64 FMAs.
__device__ __forceinline__ void mm8(const float* Pt, int ldp, const float* Q, int ldq, int K,
                                    int ti, int tj, float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* pp = Pt + scol(8 * ti);
  const float* qq = Q + scol(8 * tj);
  float a0[8], b0[8], a1[8], b1[8];
  load8(pp, a0);
  load8(qq, b0);
  int k = 0;
  for (; k + 1 < K; k += 2) {
    load8(pp + (k + 1) * ldp, a1);
    load8(qq + (k + 1) * ldq, b1);
    outer8(a0, b0, acc);
    const int k2 = k + 2 < K ? k + 2 : k + 1;
    load8(pp + k2 * ldp, a0);
    load8(qq + k2 * ldq, b0);
    outer8(a1, b1, acc);
  }
  if (k < K) outer8(a0, b0, acc);
}

// tile (ti, tj) to C by rows, or (cols) to Ct transposed; 0 outside R x R
__device__ __forceinline__ void store8(float* C, int R, int ld, int ti, int tj,
                                       const float (&v)[8][8], bool cols) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float o[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int r = 8 * ti + (cols ? b : a), q = 8 * tj + (cols ? a : b);
      o[b] = (r < R && q < R) ? (cols ? v[b][a] : v[a][b]) : 0.f;
    }
    float* row = C + (8 * (cols ? tj : ti) + a) * ld + scol(8 * (cols ? ti : tj));
    *reinterpret_cast<float4*>(row) = make_float4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<float4*>(row + 4) = make_float4(o[4], o[5], o[6], o[7]);
  }
}

// Mt = (I + G' diag(w) G) transposed from the resident Gr (rows of stride
// ld, columns at scol) and w (T values), gram_build_tiled's sums over t in
// its order.  The caller synchronises after.
__device__ inline void gram_warp(const float* Gr, const float* w, int T, int R, int ld,
                                 float* Mt, int lane) {
  const int nw = warp_tiles(R), ti = lane / nw, tj = lane - ti * nw;
  if (lane >= nw * nw) return;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float* ga = Gr + scol(8 * ti);
  const float* gb = Gr + scol(8 * tj);
  // rows t and t + 1 in two sets of registers, as mm8; a row's products
  // G[t, i] w[t] rounded before their FMAs, as gram_build_tiled forms them
  float a0[8], b0[8], a1[8], b1[8], aw[8];
  load8(ga, a0);
  load8(gb, b0);
  float w0 = w[0], w1;
  int t = 0;
  for (; t + 1 < T; t += 2) {
    load8(ga + (t + 1) * ld, a1);
    load8(gb + (t + 1) * ld, b1);
    w1 = w[t + 1];
#pragma unroll
    for (int i = 0; i < 8; ++i) aw[i] = a0[i] * w0;
    outer8(aw, b0, acc);
    const int t2 = t + 2 < T ? t + 2 : t + 1;
    load8(ga + t2 * ld, a0);
    load8(gb + t2 * ld, b0);
    w0 = w[t2];
#pragma unroll
    for (int i = 0; i < 8; ++i) aw[i] = a1[i] * w1;
    outer8(aw, b1, acc);
  }
  if (t < T) {
#pragma unroll
    for (int i = 0; i < 8; ++i) aw[i] = a0[i] * w0;
    outer8(aw, b0, acc);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] += (8 * ti + i == 8 * tj + j ? 1.f : 0.f);
  store8(Mt, R, ld, ti, tj, acc, true);
}

// X from the R x R matrix src by rows (any address; by 16-byte words where
// R % 4 == 0 and src is aligned), zero in its pad columns below 4 ceil(R /
// 4).  The caller synchronises after.
__device__ inline void load_x_warp(const float* src, float* X, int R, int ld, int lane) {
  const int nb = tiles_per_side(R);
  const bool vec = (R & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  for (int e = lane; e < R * nb; e += 32) {
    const int r = e / nb, c = e - r * nb;
    float x[4];
    if (vec) {
      const float4 q = *reinterpret_cast<const float4*>(src + r * R + 4 * c);
      x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = 4 * c + j < R ? src[r * R + 4 * c + j] : 0.f;
    }
    *reinterpret_cast<float4*>(X + r * ld + scol(4 * c)) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// The R x R corner of X to dst by rows (16-byte stores where R % 4 == 0 and
// dst is aligned), consecutive lanes on consecutive words of a row.
__device__ inline void store_x_warp(const float* X, float* dst, int R, int ld, int lane) {
  const int nb = tiles_per_side(R);
  const bool vec = (R & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0;
  for (int e = lane; e < R * nb; e += 32) {
    const int r = e / nb, c = e - r * nb;
    const float4 q = *reinterpret_cast<const float4*>(X + r * ld + scol(4 * c));
    if (vec) {
      *reinterpret_cast<float4*>(dst + r * R + 4 * c) = q;
    } else {
      const float x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * c + j < R) dst[r * R + 4 * c + j] = x[j];
    }
  }
}

// Xt from X (R x R, columns at scol): lanes on columns, a row at a time.
// The caller synchronises after.
__device__ inline void transpose_warp(const float* X, float* Xt, int R, int ld, int lane) {
  for (int r = 0; r < R; ++r)
    for (int q = lane; q < R; q += 32) Xt[q * ld + scol(r)] = X[r * ld + scol(q)];
}

// ns_cold_start_tiled for the warp: X = Xt = c I written whole (each lane
// its own tile, zero off the diagonal), so neither need be zero on entry.
// The caller synchronises after.
__device__ inline void cold_start_warp(const float* Mt, float* X, float* Xt, int R, int ld,
                                       int lane) {
  float m = 0.f;
  for (int r = lane; r < R; r += 32) {
    float s = 0.f;
    for (int k = 0; k < R; ++k) s += fabsf(Mt[k * ld + scol(r)]);
    m = nanmax(m, s);
  }
  const float c = 2.f / (1.f + warp_max(m));
  const int nw = warp_tiles(R), ti = lane / nw, tj = lane - ti * nw;
  if (lane < nw * nw) {
    float d[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) d[i][j] = 8 * ti + i == 8 * tj + j ? c : 0.f;
    store8(X, R, ld, ti, tj, d, false);
    store8(Xt, R, ld, ti, tj, d, true);
  }
}

// ns_iterate_tiled's rounds by the warp: T = 2I - M X over X, then X (2I -
// M X) to X and Xt.  X, Xt complete on entry and on exit.
__device__ inline void iterate_warp(const float* Mt, float* X, float* Xt, int R, int ld,
                                    int iters, int lane) {
  const int nw = warp_tiles(R), ti = lane / nw, tj = lane - ti * nw;
  const bool own = lane < nw * nw;
  float acc[8][8];
  for (int it = 0; it < iters; ++it) {
    if (own) {
      mm8(Mt, ld, X, ld, R, ti, tj, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = (8 * ti + i == 8 * tj + j ? 2.f : 0.f) - acc[i][j];
    }
    __syncwarp();  // every read of X is done
    if (own) store8(X, R, ld, ti, tj, acc, false);
    __syncwarp();
    if (own) mm8(Xt, ld, X, ld, R, ti, tj, acc);
    __syncwarp();  // every read of Xt and T is done
    if (own) {
      store8(X, R, ld, ti, tj, acc, false);
      store8(Xt, R, ld, ti, tj, acc, true);
    }
    __syncwarp();
  }
}

// ns_residual_tiled for the warp; every lane receives it.
__device__ inline float residual_warp(const float* Mt, const float* X, int R, int ld, int lane) {
  const int nw = warp_tiles(R), ti = lane / nw, tj = lane - ti * nw;
  float m = 0.f;
  if (lane < nw * nw) {
    float acc[8][8];
    mm8(Mt, ld, X, ld, R, ti, tj, acc);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 8 * ti + i, q = 8 * tj + j;
        if (r < R && q < R) m = nanmax(m, fabsf(acc[i][j] - (r == q ? 1.f : 0.f)));
      }
  }
  return warp_max(m);
}

// marginal_v_tiled from the resident Gt (row stride tp) and X (columns at
// scol), every row of t at once: the 4 x 4 tiles (ti, tj) of Y = G X over
// ceil(T / 4) x ceil(R / 4), their partial sums to part[tj][t] (stride
// tp), then each row t adds its partial sums in order of tj.
__device__ inline void v_warp(const float* Gt, int tp, const float* X, int T, int R, int ld,
                              float* part, float* v, int lane) {
  const int nb = tiles_per_side(R);
  const int ntile = (T + 3) / 4 * nb;
  for (int tile = lane; tile < ntile; tile += 32) {
    const int ti = tile / nb, tj = tile - ti * nb;
    float acc[4][4];
    mm_tile(Gt, tp, X + scol(4 * tj) - 4 * tj, ld, R, ti, tj, acc);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 g = *reinterpret_cast<const float4*>(Gt + (4 * tj + j) * tp + 4 * ti);
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = fmaf(acc[i][j], gv[i], p[i]);
    }
    *reinterpret_cast<float4*>(part + tj * tp + 4 * ti) = make_float4(p[0], p[1], p[2], p[3]);
  }
  __syncwarp();
  for (int t = lane; t < T; t += 32) {
    float s = 0.f;
    for (int j = 0; j < nb; ++j) s += part[j * tp + t];
    v[t] = s;
  }
}

// ---------------------------------------------------------------------------
// Pair-form GEMM routines (ns_gram's long-T design, ns_inverse.cu)
//
// A symmetric R x R matrix is held by its P = R (R + 1) / 2 upper-triangle
// pairs p = (i <= j), row-major: row i holds (i, i), (i, i + 1), ...,
// (i, R - 1), the order of torch.triu_indices.  With K[t, p] =
// G[t, i] G[t, j], the Gram is A[s, p] = sum_t w[s, t] K[t, p] and
// v[s, t] = sum_p Xp[s, p] K[t, p] with Xp = X_ii on the diagonal and
// X_ij + X_ji off it: two products with the small K as the B operand.
//
// The GEMM tile: GEMM_THREADS threads as a 16 x 16 grid (ty, tx) compute a
// BM x BN tile of C = A B, BM, BN in {64, 128}; thread (ty, tx) owns rows
// g 64 + 4 ty + i and columns h 64 + 4 tx + j (g < BM / 64, h < BN / 64,
// i, j < 4), (BM / 16) x (BN / 16) sums in registers.  Per step of GEMM_BK
// k, A's tile sits transposed in As (BK rows of stride BM + 4: the pad
// makes the transposing store conflict-free) and B's in Bs (BK rows of
// BN); per k a thread reads one 16-byte word of As per 4 rows and of Bs per
// 4 columns.  Each sum runs over k in increasing order from 0 in one FMA
// chain, and k past K adds 0 * 0: an output's bits depend only on K and its
// inputs, not on the tile shape or where its row falls in a tile.
// ---------------------------------------------------------------------------

constexpr int GEMM_THREADS = 256;
constexpr int GEMM_BK = 8;

__host__ __device__ inline int num_pairs(int R) { return R * (R + 1) / 2; }

// p of the pair (i, j), i <= j
__host__ __device__ inline int pair_index(int i, int j, int R) {
  return i * R - i * (i - 1) / 2 + (j - i);
}

// (i, j) of every pair p < P into pi[p], pj[p] (R <= 128 fits a byte); the
// caller synchronises after.
__device__ inline void pair_table(int R, unsigned char* pi, unsigned char* pj) {
  for (int i = 0; i < R; ++i) {
    const int base = pair_index(i, i, R) - i;
    for (int j = i + threadIdx.x; j < R; j += blockDim.x) {
      pi[base + j] = (unsigned char)i;
      pj[base + j] = (unsigned char)j;
    }
  }
}

// This thread's share of a BM x GEMM_BK tile of a row-major M x K matrix
// (rows m0.., columns k0..) copied into As transposed, 0 outside: element
// e = tid + q GEMM_THREADS is (e / BK, e % BK), so eight threads read 32
// contiguous bytes of a row.  The copies are cp.async (4 bytes each, a
// source size of 0 zero-fills), so the tile bypasses the registers;
// atile_wait() makes this thread's copies complete, and the barrier after
// it makes them visible to the block.
template <int BM>
__device__ __forceinline__ void atile_copy(float* As, const float* __restrict__ A, int M, int K,
                                           int m0, int k0) {
#pragma unroll
  for (int q = 0; q < BM * GEMM_BK / GEMM_THREADS; ++q) {
    const int e = threadIdx.x + q * GEMM_THREADS;
    const int m = m0 + e / GEMM_BK, k = k0 + e % GEMM_BK;
    const bool ok = m < M && k < K;
    const float* src = ok ? A + (size_t)m * K + k : A;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(As + (e % GEMM_BK) * (BM + 4) + e / GEMM_BK);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
                 "r"(ok ? 4 : 0));
  }
  asm volatile("cp.async.commit_group;" ::);
}

__device__ __forceinline__ void atile_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// acc += As' Bs over the GEMM_BK rows of one step, thread (ty, tx).
template <int BM, int BN>
__device__ __forceinline__ void gemm_tile_step(const float* As, const float* Bs, int ty, int tx,
                                               float (&acc)[BM / 16][BN / 16]) {
#pragma unroll
  for (int k = 0; k < GEMM_BK; ++k) {
    float a[BM / 16], b[BN / 16];
#pragma unroll
    for (int g = 0; g < BM / 64; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(As + k * (BM + 4) + g * 64 + 4 * ty);
      a[4 * g] = x.x; a[4 * g + 1] = x.y; a[4 * g + 2] = x.z; a[4 * g + 3] = x.w;
    }
#pragma unroll
    for (int h = 0; h < BN / 64; ++h) {
      const float4 x = *reinterpret_cast<const float4*>(Bs + k * BN + h * 64 + 4 * tx);
      b[4 * h] = x.x; b[4 * h + 1] = x.y; b[4 * h + 2] = x.z; b[4 * h + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < BM / 16; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// C[m0 + row, n0 + col] = acc for the rows < M and columns < N of the tile
// (C row-major M x N).
template <int BM, int BN>
__device__ __forceinline__ void gemm_tile_store(float* C, int M, int N, int m0, int n0, int ty,
                                                int tx, const float (&acc)[BM / 16][BN / 16]) {
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int m = m0 + (i / 4) * 64 + 4 * ty + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int n = n0 + (j / 4) * 64 + 4 * tx + j % 4;
      if (n < N) C[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace vlgp

extern "C" const char* ns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
