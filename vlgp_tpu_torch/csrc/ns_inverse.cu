// Newton-Schulz inverses X = (I + A)^{-1} of small SPD systems, for Hopper.
//
// Three entry points share the Newton-Schulz routines of ns_common.cuh:
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
//   ns_packed_probe_skip  replaces the probe_skip mode of the same Pallas
//              kernel (vlgp_tpu/ops/spd.py:492-519): one block per group of
//              `per_block` matrices (the TPU kernel's grid block,
//              _packed_geometry(tiles=12)) measures the carried x0 of every
//              matrix of the group; a group whose worst residual is below
//              1e-2 returns x0 bit for bit, any other group (NaN included)
//              is refined from x0.
//
// Modes (ns_gram, ns_packed): cold start at c I with c = 2 / (1 + max
// row-sum of |I+A|); warm start at x0 (iters = 0 is legal); probe
// (resid_only): one product measures x0's residual, no X is written, and
// ns_gram emits v from x0.
//
// Design.  One thread block of NT threads per matrix (per group for
// probe_skip).  The block keeps M = I + A, X and one R x R scratch in
// dynamic shared memory (R <= 128: 3 * 64 KB plus the streamed G chunk,
// 213 KB of the 227 KB a block may use on an H100).  Each thread owns
// ceil(R^2 / NT) entries of every product and accumulates them in
// registers, so a product needs no fourth buffer.  Every multiply is a full
// float32 FMA: no TF32 and no bf16 (the TPU's bf16 products made the
// iteration miss its 1e-2 tolerance, vlgp_tpu/ops/spd.py:54-65).  The TPU
// kernels' block-diagonal packing of 128 // R matrices into one 128 x 128
// tile is a trick for the TPU's matrix unit and is dropped.
//
// What bounds it on this card: at the main-path shapes (R = 40, 10,000
// matrices) each Newton-Schulz step is 2 R^3 FMAs per matrix whose operands
// come from shared memory, two loads per FMA: the kernel is bound by
// shared-memory bandwidth, not by device memory (X is read and written
// once per call).  Register tiling or wgmma would lift that bound; both
// are later work.  probe_skip runs one block per group (21 blocks at
// B = 500, R = 50), so it fills a sixth of the card; it keeps the TPU
// kernel's grouping because the skip decision is made per group.
//
// The residual reduction propagates NaN (fmaxf would drop it), so a NaN X
// can never pass the caller's `isfinite(resid) && resid < tol` check.
// Each entry point returns cudaGetLastError() of its launch.

#include "ns_common.cuh"

namespace {

using namespace vlgp;

constexpr int NT = 256;         // threads per block
constexpr int NWARP = NT / 32;

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
    ns_cold_start<NT>(M, X, R, red);
  }
  __syncthreads();
  if (!resid_only) ns_iterate<NT, E>(M, X, Tm, R, iters);
  const float res = ns_residual<NT, E>(M, X, R, red);
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
  const int b = blockIdx.x;  // b = z * S + s
  const int z = b / S;
  const float* Gz = G + (size_t)z * T * R;

  gram_build<NT, E>(Gz, w + (size_t)b * T, T, R, M, Gc, wc);
  ns_solve<E>(M, X, Tm, red, x0 ? x0 + (size_t)b * RR : nullptr,
              Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, iters, resid_only);
  // v_t = G_t X G_t' from the X this block holds (x0 in probe mode)
  if (want_v) marginal_v<NT>(Gz, X, T, R, Gc, v + (size_t)b * T, nullptr);
}

__device__ void load_packed(const float* Ab, float* M, int R) {
  for (int i = threadIdx.x; i < R * R; i += NT) M[i] = Ab[i] + (i / R == i % R ? 1.f : 0.f);
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
  load_packed(A + (size_t)b * RR, M, R);
  __syncthreads();
  ns_solve<E>(M, X, Tm, red, x0 ? x0 + (size_t)b * RR : nullptr,
              Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, iters, resid_only);
}

// One block per group of `per_block` matrices.  Pass 1 measures every
// x0's residual (resid[m] = that residual).  A converged group copies x0
// to X; a drifted one runs max(iters, 1) rounds from x0 per matrix: the
// TPU kernel's probe product reused as the first half-step, X1 =
// x0 (2I - M x0), then iters - 1 rounds, is the same arithmetic.  The
// probe products are recomputed instead of kept: 24 R x R products do not
// fit in shared memory at R = 50.
template <int E>
__global__ void __launch_bounds__(NT)
ns_packed_probe_skip_kernel(const float* __restrict__ A, const float* __restrict__ x0,
                            float* __restrict__ Xo, float* __restrict__ resid,
                            int B, int R, int per_block, int iters) {
  extern __shared__ float sm[];
  const int RR = R * R;
  float* M = sm;
  float* X = M + RR;
  float* Tm = X + RR;
  float* red = Tm + RR;
  const int m0 = blockIdx.x * per_block;
  const int m1 = min(B, m0 + per_block);
  float worst = 0.f;
  for (int m = m0; m < m1; ++m) {
    __syncthreads();  // the previous matrix is consumed
    load_packed(A + (size_t)m * RR, M, R);
    for (int i = threadIdx.x; i < RR; i += NT) X[i] = x0[(size_t)m * RR + i];
    __syncthreads();
    const float r = ns_residual<NT, E>(M, X, R, red);
    worst = nanmax(worst, r);
    if (threadIdx.x == 0) resid[m] = r;
  }
  if (worst < RESID_TOL) {  // block-uniform; a NaN residual refines
    for (size_t i = threadIdx.x + (size_t)m0 * RR; i < (size_t)m1 * RR; i += NT) Xo[i] = x0[i];
    return;
  }
  for (int m = m0; m < m1; ++m) {
    __syncthreads();
    load_packed(A + (size_t)m * RR, M, R);
    __syncthreads();
    ns_solve<E>(M, X, Tm, red, x0 + (size_t)m * RR, Xo + (size_t)m * RR, resid + m,
                R, iters > 1 ? iters : 1, 0);
  }
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

template <int E>
cudaError_t launch_probe_skip(const float* A, const float* x0, float* X, float* resid,
                              int B, int R, int per_block, int iters, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * R * R + NWARP);
  cudaError_t err = cudaFuncSetAttribute(
      ns_packed_probe_skip_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (B + per_block - 1) / per_block;
  ns_packed_probe_skip_kernel<E><<<groups, NT, smem, st>>>(A, x0, X, resid, B, R,
                                                           per_block, iters);
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

// A, x0, X (B,R,R); resid (B,): per matrix, x0's residual in a converged
// group and the refined residual in a drifted one.
int ns_packed_probe_skip(const float* A, const float* x0, float* X, float* resid, int B,
                         int R, int per_block, int iters, void* stream) {
  if (R < 1 || R > RMAX || B < 1 || per_block < 1 || iters < 0 || x0 == nullptr ||
      X == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (entries(R)) {
    case 8:  return (int)launch_probe_skip<8>(A, x0, X, resid, B, R, per_block, iters, st);
    case 16: return (int)launch_probe_skip<16>(A, x0, X, resid, B, R, per_block, iters, st);
    case 32: return (int)launch_probe_skip<32>(A, x0, X, resid, B, R, per_block, iters, st);
    default: return (int)launch_probe_skip<64>(A, x0, X, resid, B, R, per_block, iters, st);
  }
}

}  // extern "C"
