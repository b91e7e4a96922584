// Device routines shared by the port's kernels (ns_inverse.cu, sweep.cu,
// spd_inverse.cu; the bulk copy and its wait, mstep.cu and estep.cu): a
// NaN-propagating max, warp and block reductions, a bulk copy to shared
// memory completing on an mbarrier and the wait on one, and
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
