// Device routines shared by the port's kernels (ns_inverse.cu, sweep.cu,
// spd_inverse.cu): a NaN-propagating max, warp and block reductions, and
// the register-tiled Newton-Schulz pieces X <- X (2I - M X), the Gram build
// M = I + G' diag(w) G streamed over T and v = diag(G X G'): a thread owns
// a 4 x 4 tile of a padded product in 16 registers and reads two 16-byte
// words per 16 FMAs (see "Register-tiled routines" below).
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

}  // namespace vlgp

extern "C" const char* ns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
