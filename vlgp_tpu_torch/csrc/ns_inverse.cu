// Newton-Schulz inverses X = (I + A)^{-1} of small SPD systems, for Hopper.
//
// Two entry points share one __device__ Newton-Schulz routine:
//
//   ns_gram    replaces vlgp_tpu/ops/spd.py:_ns_gram_pallas (kernel body
//              _make_ns_gram_kernel).  Per (latent z, segment s) it builds
//              A = G_z' diag(w_zs) G_z in shared memory, streaming rows of
//              G_z and w_zs over T in chunks of TC rows (T reaches 1000 in
//              the final full-length inference), runs Newton-Schulz
//              X <- X (2I - (I+A) X), writes X, one residual
//              max|(I+A)X - I| per matrix and, when asked, v = diag(G X G')
//              computed from the X the block still holds.
//   ns_packed  replaces vlgp_tpu/ops/spd.py:_ns_packed_pallas (kernel body
//              _make_ns_packed_kernel): the same iteration on a given
//              A (B, R, R).
//
// Modes (both): cold start at c I with c = 2 / (1 + max row-sum of |I+A|);
// warm start at x0 (iters = 0 is legal); probe (resid_only): one product
// measures x0's residual, no X is written, and ns_gram emits v from x0.
//
// Design.  One thread block of NT threads per matrix.  The block keeps
// M = I + A, X and one R x R scratch in dynamic shared memory (R <= 128:
// 3 * 64 KB plus the streamed G chunk, 213 KB of the 227 KB a block may
// use on an H100).  Each thread owns ceil(R^2 / NT) entries of every
// product and accumulates them in registers, so a product needs no fourth
// buffer.  Every multiply is a full float32 FMA: no TF32 and no bf16 (the
// TPU's bf16 products made the iteration miss its 1e-2 tolerance,
// vlgp_tpu/ops/spd.py:54-65).  The TPU kernels' block-diagonal packing of
// 128 // R matrices into one 128 x 128 tile is a trick for the TPU's matrix
// unit and is dropped.
//
// What bounds it on this card: at the main-path shapes (R = 40, 10,000
// matrices) each Newton-Schulz step is 2 R^3 FMAs per matrix whose operands
// come from shared memory, two loads per FMA: the kernel is bound by
// shared-memory bandwidth, not by device memory (X is read and written
// once per call).  Register tiling or wgmma would lift that bound; both
// are later work.
//
// The residual reduction propagates NaN (fmaxf would drop it), so a NaN X
// can never pass the caller's `isfinite(resid) && resid < tol` check.
// Each entry point returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;
constexpr int TC = 32;          // rows of G per streamed chunk
constexpr int RMAX = 128;       // largest R the kernels take

// max that returns NaN when either operand is NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Block-wide NaN-propagating max; every thread receives the result.
// `red` holds NWARP floats of shared memory.
__device__ float block_max(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x = nanmax(x, __shfl_down_sync(0xffffffffu, x, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  __syncthreads();  // earlier readers of `red` are done
  if (lane == 0) red[wid] = x;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NWARP; ++i) r = nanmax(r, red[i]);
  return r;
}

// acc[e] = (P Q)[idx] for this thread's entries idx = tid + e * NT.
template <int E>
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

// Solve in shared memory: M = I + A is complete on entry.  Initializes X
// (cold or from x0b), iterates unless `resid_only`, writes the residual of
// the final X to *resid_out and X to Xout (when not null).
template <int E>
__device__ void ns_solve(const float* M, float* X, float* Tm, float* red,
                         const float* x0b, float* Xout, float* resid_out,
                         int R, int iters, int resid_only) {
  const int RR = R * R;
  const int tid = threadIdx.x;
  if (x0b != nullptr) {
    for (int i = tid; i < RR; i += NT) X[i] = x0b[i];
  } else {
    float m = 0.f;
    for (int r = tid; r < R; r += NT) {
      float s = 0.f;
      for (int k = 0; k < R; ++k) s += fabsf(M[r * R + k]);
      m = nanmax(m, s);
    }
    const float c = 2.f / (1.f + block_max(m, red));
    for (int i = tid; i < RR; i += NT) X[i] = (i / R == i % R) ? c : 0.f;
  }
  __syncthreads();

  float acc[E];
  if (!resid_only) {
    for (int it = 0; it < iters; ++it) {
      mm_regs<E>(M, X, R, acc);  // M X
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = tid + e * NT;
        if (idx < RR) Tm[idx] = (idx / R == idx % R ? 2.f : 0.f) - acc[e];
      }
      __syncthreads();
      mm_regs<E>(X, Tm, R, acc);  // X (2I - M X)
      __syncthreads();            // every read of X is done
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int idx = tid + e * NT;
        if (idx < RR) X[idx] = acc[e];
      }
      __syncthreads();
    }
  }

  mm_regs<E>(M, X, R, acc);
  float m = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = tid + e * NT;
    if (idx < RR) m = nanmax(m, fabsf(acc[e] - (idx / R == idx % R ? 1.f : 0.f)));
  }
  const float res = block_max(m, red);
  if (tid == 0) *resid_out = res;
  if (Xout != nullptr && !resid_only) {
    for (int i = tid; i < RR; i += NT) Xout[i] = X[i];
  }
}

template <int E>
__global__ void __launch_bounds__(NT)
ns_gram_kernel(const float* __restrict__ G, const float* __restrict__ w,
               const float* __restrict__ x0, float* __restrict__ Xo,
               float* __restrict__ resid, float* __restrict__ v,
               int S, int T, int R, int iters, int resid_only, int want_v) {
  extern __shared__ float sm[];
  const int RR = R * R;
  float* M = sm;
  float* X = M + RR;
  float* Tm = X + RR;
  float* Gc = Tm + RR;   // TC x R chunk of G_z
  float* wc = Gc + TC * R;  // TC weights
  float* red = wc + TC;     // NWARP floats
  const int tid = threadIdx.x;
  const int b = blockIdx.x;  // b = z * S + s
  const int z = b / S;
  const float* Gz = G + (size_t)z * T * R;
  const float* wb = w + (size_t)b * T;

  // ---- A = G' diag(w) G, streamed over T ----
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < tc * R; i += NT) Gc[i] = Gz[(size_t)t0 * R + i];
    for (int i = tid; i < tc; i += NT) wc[i] = wb[t0 + i];
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

  ns_solve<E>(M, X, Tm, red, x0 ? x0 + (size_t)b * RR : nullptr,
              Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, iters, resid_only);

  if (!want_v) return;
  // ---- v_t = G_t X G_t' from the X this block holds (x0 in probe mode) ----
  const int lane = tid & 31, wid = tid >> 5;
  for (int t0 = 0; t0 < T; t0 += TC) {
    const int tc = min(TC, T - t0);
    __syncthreads();
    for (int i = tid; i < tc * R; i += NT) Gc[i] = Gz[(size_t)t0 * R + i];
    __syncthreads();
    for (int t = wid; t < tc; t += NWARP) {
      const float* g = Gc + t * R;
      float a = 0.f;
      for (int q = lane; q < R; q += 32) {
        float s = 0.f;  // (G X)[t, q]
        for (int r = 0; r < R; ++r) s = fmaf(g[r], X[r * R + q], s);
        a = fmaf(s, g[q], a);
      }
      for (int o = 16; o > 0; o >>= 1) a += __shfl_down_sync(0xffffffffu, a, o);
      if (lane == 0) v[(size_t)b * T + t0 + t] = a;
    }
  }
}

template <int E>
__global__ void __launch_bounds__(NT)
ns_packed_kernel(const float* __restrict__ A, const float* __restrict__ x0,
                 float* __restrict__ Xo, float* __restrict__ resid,
                 int R, int iters, int resid_only) {
  extern __shared__ float sm[];
  const int RR = R * R;
  float* M = sm;
  float* X = M + RR;
  float* Tm = X + RR;
  float* red = Tm + RR;
  const int b = blockIdx.x;
  const float* Ab = A + (size_t)b * RR;
  for (int i = threadIdx.x; i < RR; i += NT) M[i] = Ab[i] + (i / R == i % R ? 1.f : 0.f);
  __syncthreads();
  ns_solve<E>(M, X, Tm, red, x0 ? x0 + (size_t)b * RR : nullptr,
              Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, iters, resid_only);
}

template <int E>
cudaError_t launch_gram(const float* G, const float* w, const float* x0, float* X,
                        float* resid, float* v, int Z, int S, int T, int R,
                        int iters, int resid_only, int want_v, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * R * R + TC * R + TC + NWARP);
  cudaError_t err = cudaFuncSetAttribute(
      ns_gram_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ns_gram_kernel<E><<<Z * S, NT, smem, st>>>(G, w, x0, X, resid, v, S, T, R, iters,
                                             resid_only, want_v);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_packed(const float* A, const float* x0, float* X, float* resid,
                          int B, int R, int iters, int resid_only, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * R * R + NWARP);
  cudaError_t err = cudaFuncSetAttribute(
      ns_packed_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ns_packed_kernel<E><<<B, NT, smem, st>>>(A, x0, X, resid, R, iters, resid_only);
  return cudaGetLastError();
}

// entries per thread, rounded up to a compiled register-array size
int entries(int R) {
  const int e = (R * R + NT - 1) / NT;
  return e <= 8 ? 8 : e <= 16 ? 16 : e <= 32 ? 32 : 64;
}

}  // namespace

extern "C" {

// G (Z,T,R), w (Z,S,T), x0 (Z,S,R,R) or null; X (Z,S,R,R) or null in probe
// mode; resid (Z*S,); v (Z,S,T) or null.  All float32, contiguous.
int ns_gram(const float* G, const float* w, const float* x0, float* X, float* resid,
            float* v, int Z, int S, int T, int R, int iters, int use_x0,
            int resid_only, int want_v, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || Z < 1 || S < 1 || iters < 0 ||
      (resid_only && !use_x0) || (!resid_only && X == nullptr) ||
      (want_v && v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (entries(R)) {
    case 8:  return (int)launch_gram<8>(G, w, x0, X, resid, v, Z, S, T, R, iters, resid_only, want_v, st);
    case 16: return (int)launch_gram<16>(G, w, x0, X, resid, v, Z, S, T, R, iters, resid_only, want_v, st);
    case 32: return (int)launch_gram<32>(G, w, x0, X, resid, v, Z, S, T, R, iters, resid_only, want_v, st);
    default: return (int)launch_gram<64>(G, w, x0, X, resid, v, Z, S, T, R, iters, resid_only, want_v, st);
  }
}

// A (B,R,R), x0 (B,R,R) or null; X (B,R,R) or null in probe mode; resid (B,).
int ns_packed(const float* A, const float* x0, float* X, float* resid, int B, int R,
              int iters, int use_x0, int resid_only, void* stream) {
  if (R < 1 || R > RMAX || B < 1 || iters < 0 || (resid_only && !use_x0) ||
      (!resid_only && X == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (entries(R)) {
    case 8:  return (int)launch_packed<8>(A, x0, X, resid, B, R, iters, resid_only, st);
    case 16: return (int)launch_packed<16>(A, x0, X, resid, B, R, iters, resid_only, st);
    case 32: return (int)launch_packed<32>(A, x0, X, resid, B, R, iters, resid_only, st);
    default: return (int)launch_packed<64>(A, x0, X, resid, B, R, iters, resid_only, st);
  }
}

const char* ns_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
