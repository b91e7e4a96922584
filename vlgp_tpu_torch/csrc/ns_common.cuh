// Device routines shared by the port's kernels (ns_inverse.cu, sweep.cu,
// spd_inverse.cu): NaN-propagating block reductions, the register-tiled
// shared-memory product, the Newton-Schulz pieces X <- X (2I - M X), the
// Gram build M = I + G' diag(w) G streamed over T, and v = diag(G X G').
//
// NT is the block's thread count; E the number of product entries a thread
// owns (E * NT >= R * R).  Every routine is called by all NT threads of the
// block with block-uniform arguments, so each __syncthreads is reached by
// all of them.  Every multiply is a full float32 FMA: no TF32 and no bf16.
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

// Block-wide NaN-propagating max; every thread receives the result.
// `red` holds NT / 32 floats of shared memory.
template <int NT>
__device__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = nanmax(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) red[wid] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NT / 32; ++i) r = nanmax(r, red[i]);
  return r;
}

// Block-wide sum in a fixed order (no atomics: repeated runs give the same
// bits); every thread receives the result.
template <int NT>
__device__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[wid] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NT / 32; ++i) r += red[i];
  return r;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[e] = (P Q)[idx] for this thread's entries idx = tid + e * NT.
template <int NT, int E>
__device__ __forceinline__ void mm_regs(const float* P, const float* Q, int R,
                                        float (&acc)[E]) {
  const int RR = R * R;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + e * NT;
    float s = 0.f;
    if (idx < RR) {
      const int r = idx / R, q = idx - r * R;
      const float* p = P + r * R;
      const float* qc = Q + q;
      for (int k = 0; k < R; ++k) s = fmaf(p[k], qc[k * R], s);
    }
    acc[e] = s;
  }
}

// Cold start X = c I with c = 2 / (1 + max row-sum of |M|): the per-matrix
// scaled identity of vlgp_tpu/ops/spd.py.  The caller synchronises after.
template <int NT>
__device__ void ns_cold_start(const float* M, float* X, int R, float* red) {
  float m = 0.f;
  for (int r = threadIdx.x; r < R; r += NT) {
    float s = 0.f;
    for (int k = 0; k < R; ++k) s += fabsf(M[r * R + k]);
    m = nanmax(m, s);
  }
  const float c = 2.f / (1.f + block_max<NT>(m, red));
  for (int i = threadIdx.x; i < R * R; i += NT) X[i] = (i / R == i % R) ? c : 0.f;
}

// `iters` Newton-Schulz rounds X <- X (2I - M X) in shared memory; Tm is an
// R x R scratch.  X must be complete on entry (synchronised); it is
// complete again on exit.
template <int NT, int E>
__device__ void ns_iterate(const float* M, float* X, float* Tm, int R, int iters) {
  const int RR = R * R;
  const int tid = threadIdx.x;
  float acc[E];
  for (int it = 0; it < iters; ++it) {
    mm_regs<NT, E>(M, X, R, acc);  // M X
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + e * NT;
      if (idx < RR) Tm[idx] = (idx / R == idx % R ? 2.f : 0.f) - acc[e];
    }
    __syncthreads();
    mm_regs<NT, E>(X, Tm, R, acc);  // X (2I - M X)
    __syncthreads();                // every read of X is done
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + e * NT;
      if (idx < RR) X[idx] = acc[e];
    }
    __syncthreads();
  }
}

// Block-wide max|M X - I| (NaN-propagating); every thread receives it.
template <int NT, int E>
__device__ float ns_residual(const float* M, const float* X, int R, float* red) {
  const int RR = R * R;
  float acc[E];
  mm_regs<NT, E>(M, X, R, acc);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + e * NT;
    if (idx < RR) m = nanmax(m, fabsf(acc[e] - (idx / R == idx % R ? 1.f : 0.f)));
  }
  return block_max<NT>(m, red);
}

// M = I + Gz' diag(w) Gz, with rows of Gz (T x R) and w (T) streamed
// through the shared chunks Gc (TC x R) and wc (TC), so no size assumes a
// short T.  M is complete (synchronised) on exit.
template <int NT, int E>
__device__ void gram_build(const float* Gz, const float* w, int T, int R, float* M,
                           float* Gc, float* wc) {
  const int RR = R * R;
  const int tid = threadIdx.x;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < tc * R; i += NT) Gc[i] = Gz[(size_t)t0 * R + i];
    for (int i = tid; i < tc; i += NT) wc[i] = w[t0 + i];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + e * NT;
      if (idx < RR) {
        const int r = idx / R, q = idx - r * R;
        float s = acc[e];
        for (int t = 0; t < tc; ++t) s = fmaf(Gc[t * R + r] * wc[t], Gc[t * R + q], s);
        acc[e] = s;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = tid + e * NT;
    if (idx < RR) M[idx] = acc[e] + (idx / R == idx % R ? 1.f : 0.f);
  }
  __syncthreads();
}

// v_t = G_t X G_t' for t < T from the X in shared memory, one warp per row,
// G streamed through Gc; times mask[t] when `mask` is given.
template <int NT>
__device__ void marginal_v(const float* Gz, const float* X, int T, int R, float* Gc,
                           float* v, const float* mask) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();
    for (int i = tid; i < tc * R; i += NT) Gc[i] = Gz[(size_t)t0 * R + i];
    __syncthreads();
    for (int t = wid; t < tc; t += NT / 32) {
      const float* g = Gc + t * R;
      float a = 0.f;
      for (int q = lane; q < R; q += 32) {
        float s = 0.f;  // (G X)[t, q]
        for (int r = 0; r < R; ++r) s = fmaf(g[r], X[r * R + q], s);
        a = fmaf(s, g[q], a);
      }
      for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
      if (lane == 0) v[t0 + t] = mask ? a * mask[t0 + t] : a;
    }
  }
}

}  // namespace vlgp

extern "C" const char* ns_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
