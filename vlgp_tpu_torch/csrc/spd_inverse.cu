// Batched SPD inverse A^{-1} for Hopper: replaces
// vlgp_tpu/ops/spd.py:_spd_inverse_pallas (kernel body _spd_inverse_kernel).
//
// The TPU kernel's algorithm, step by step, per matrix:
//   Cholesky by right-looking rank-1 updates: for each column j the pivot
//   d = L[j, j] is clamped to 1e-30 (NaN propagates) and scaled by
//   p = 1 / sqrt(d); c = L[i > j, j] * p; the trailing block loses c c';
//   column j becomes (0 above, d p at j, c below);
//   forward substitution, row by row, for L^-1;
//   A^-1 = L^-T L^-1.
//
// Design.  One block of NT threads per matrix, with L, L^-1 and the column
// c in dynamic shared memory (2 R^2 + R floats: 13 KB at R = 40, 129 KB at
// the R = 128 limit).  The factorization and the substitution are R
// sequential steps each, one __syncthreads apart; the final product reads
// L^-1 from shared memory and writes A^-1 once.  Every multiply is a full
// float32 FMA.
//
// What bounds it on this card: 2 R sequential steps of R^2 / NT work
// each, separated by block barriers: barrier latency, not the FMA or the
// byte bound.  Small blocks (13 KB at R = 40) let many matrices share an SM
// to hide it.

#include "ns_common.cuh"

namespace {

using namespace vlgp;

constexpr int NT = 128;  // threads per block

__global__ void __launch_bounds__(NT)
spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out, int R) {
  extern __shared__ float sm[];
  const int RR = R * R;
  float* L = sm;
  float* Li = L + RR;
  float* c = Li + RR;
  const int tid = threadIdx.x;
  const float* Ab = A + (size_t)blockIdx.x * RR;
  for (int i = tid; i < RR; i += NT) {
    L[i] = Ab[i];
    Li[i] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < R; ++j) {
    const float d = L[j * R + j];
    const float piv = 1.f / sqrtf((d > 1e-30f || d != d) ? d : 1e-30f);
    for (int i = tid; i < R; i += NT) c[i] = i > j ? L[i * R + j] * piv : 0.f;
    __syncthreads();  // every thread has read d and column j
    for (int idx = tid; idx < RR; idx += NT) {
      const int i = idx / R, k = idx - i * R;
      if (i > j && k > j) L[idx] -= c[i] * c[k];
      else if (k == j) L[idx] = i > j ? c[i] : (i == j ? d * piv : 0.f);
    }
    __syncthreads();
  }

  // L^-1 row by row: row j = (e_j - sum_{k<j} L[j,k] L^-1[k,:]) / L[j,j]
  for (int j = 0; j < R; ++j) {
    const float djj = L[j * R + j];
    for (int q = tid; q < R; q += NT) {
      float acc = 0.f;
      for (int k = 0; k < j; ++k) acc = fmaf(L[j * R + k], Li[k * R + q], acc);
      Li[j * R + q] = ((q == j ? 1.f : 0.f) - acc) / djj;
    }
    __syncthreads();
  }

  float* ob = out + (size_t)blockIdx.x * RR;
  for (int idx = tid; idx < RR; idx += NT) {
    const int r = idx / R, q = idx - r * R;
    float acc = 0.f;
    for (int k = 0; k < R; ++k) acc = fmaf(Li[k * R + r], Li[k * R + q], acc);
    ob[idx] = acc;
  }
}

}  // namespace

extern "C" {

// A, out (B, R, R) float32, contiguous; R <= 128.
int spd_inverse(const float* A, float* out, int B, int R, void* stream) {
  if (R < 1 || R > RMAX || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * R * R + R);
  cudaError_t err = cudaFuncSetAttribute(
      spd_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  spd_inverse_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(A, out, R);
  return (int)cudaGetLastError();
}

}  // extern "C"
