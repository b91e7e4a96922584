// csrc/ns_inverse.cu's per-matrix ns_gram kernel alone (a block per
// matrix, the block path), as it stood before the streaming path, with clock
// stamps, for tools/torch_variant_ab.py: thread 0 of each block writes
// %globaltimer at the block's start and after each phase, and the SM it ran
// on, into a device table that ns_gram_stamps() copies out; ns_gram_attrs()
// gives the kernel's registers, local (spill) bytes and resident blocks an
// SM at R40 T50.  Each phase ends at a block barrier (the stamped build adds
// the barriers the kernel lacks after the zeroing, the X store and v), so a
// stamp marks the block's end of the phase.  The arithmetic is the block
// path's, so X, the residual and v keep its bits.  It exports only ns_gram,
// with the package's prototype:
//
//   python3 tools/torch_variant_ab.py OUT.json --source ns_gram \
//       --variant "pkg=-Xptxas -v" --variant stamped@tools/variants/ns_gram_stamped.cu
//
// Slots of a block's row: 0 the SM, 1 the start, 2 the three matrices
// zeroed, 3 the Gram built, 4 x0 loaded (or the cold start), 5 the rounds,
// 6 the residual, 7 X stored, 8 v (the end).

#include "../../vlgp_tpu_torch/csrc/ns_common.cuh"

namespace {

using namespace vlgp;

constexpr int NT_MAX = 1024;
constexpr int STAMP_BLOCKS = 10240;
constexpr int NSTAMP = 10;
__device__ unsigned long long g_stamps[STAMP_BLOCKS][NSTAMP];

__device__ __forceinline__ void stamp(int slot) {
  if (threadIdx.x != 0 || blockIdx.x >= STAMP_BLOCKS) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (slot == 1) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[blockIdx.x][0] = sm;
  }
  g_stamps[blockIdx.x][slot] = t;
}

struct Layout {
  int nb, ld, n;
  __host__ __device__ explicit Layout(int R)
      : nb(tiles_per_side(R)), ld(padded_ld(R)), n(4 * tiles_per_side(R) * padded_ld(R)) {}
};

__device__ void zero_shared(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// ns_inverse.cu's ns_solve with a stamp after each phase
__device__ void ns_solve_stamped(const float* Mt, float* X, float* Xt, float* red,
                                 const float* x0b, float* Xout, float* resid_out, int R, int ld,
                                 int iters, int resid_only) {
  const int RR = R * R;
  const int tid = threadIdx.x;
  if (x0b != nullptr) {
    for (int i = tid; i < RR; i += blockDim.x) {
      const int r = i / R, q = i - r * R;
      X[r * ld + q] = x0b[i];
      if (!resid_only) Xt[q * ld + r] = x0b[i];
    }
  } else {
    ns_cold_start_tiled(Mt, X, Xt, R, ld, red);
  }
  __syncthreads();
  stamp(4);
  if (!resid_only) ns_iterate_tiled(Mt, X, Xt, R, ld, iters);
  stamp(5);
  const float res = ns_residual_tiled(Mt, X, R, ld, red);
  if (tid == 0) *resid_out = res;
  stamp(6);
  if (Xout != nullptr && !resid_only) {
    for (int i = tid; i < RR; i += blockDim.x) {
      const int r = i / R;
      Xout[i] = X[r * ld + i - r * R];
    }
  }
  __syncthreads();
  stamp(7);
}

__global__ void __launch_bounds__(NT_MAX)
ns_gram_kernel(const float* __restrict__ G, const float* __restrict__ w,
               const float* __restrict__ x0, float* __restrict__ Xo,
               float* __restrict__ resid, float* __restrict__ v,
               int S, int T, int R, int iters, int resid_only, int want_v) {
  extern __shared__ float4 sm4[];
  stamp(1);
  const Layout L(R);
  float* Mt = reinterpret_cast<float*>(sm4);
  float* X = Mt + L.n;
  float* Xt = X + L.n;
  float* Gc = Xt + L.n;
  float* wc = Gc + TC * 4 * L.nb;
  float* part = wc + TC;
  float* red = part + TC * L.nb;
  const int RR = R * R;
  const int b = blockIdx.x;
  const int z = b / S;
  const float* Gz = G + (size_t)z * T * R;

  zero_shared(Mt, 3 * L.n);
  __syncthreads();
  stamp(2);
  gram_build_tiled(Gz, w + (size_t)b * T, T, R, L.ld, Mt, Gc, wc);
  stamp(3);
  ns_solve_stamped(Mt, X, Xt, red, x0 ? x0 + (size_t)b * RR : nullptr,
                   Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, L.ld, iters, resid_only);
  if (want_v) marginal_v_tiled(Gz, X, T, R, L.ld, Gc, part, v + (size_t)b * T);
  __syncthreads();
  stamp(8);
}

size_t gram_smem(int R) {
  const Layout L(R);
  return sizeof(float) * (3 * L.n + TC * 5 * L.nb + TC + tiled_threads(R) / 32);
}

}  // namespace

extern "C" {

int ns_gram(const float* G, const float* w, const float* x0, float* X, float* resid,
            float* v, int Z, int S, int T, int R, int iters, int use_x0,
            int resid_only, int want_v, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || Z < 1 || S < 1 || iters < 0 ||
      (resid_only && !use_x0) || (!resid_only && X == nullptr) ||
      (want_v && v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  const size_t smem = gram_smem(R);
  cudaError_t err = cudaFuncSetAttribute(
      ns_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_gram_kernel<<<Z * S, tiled_threads(R), smem, (cudaStream_t)stream>>>(
      G, w, x0, X, resid, v, S, T, R, iters, resid_only, want_v);
  return (int)cudaGetLastError();
}

// The stamp table (STAMP_BLOCKS x NSTAMP 64-bit values) into the host
// buffer out; reset = 1 zeroes it.
int ns_gram_stamps(void* out, int reset) {
  const size_t bytes = sizeof(unsigned long long) * STAMP_BLOCKS * NSTAMP;
  if (reset) {
    static unsigned long long zero[STAMP_BLOCKS * NSTAMP];
    return (int)cudaMemcpyToSymbol(g_stamps, zero, bytes);
  }
  return (int)cudaMemcpyFromSymbol(out, g_stamps, bytes);
}

// Registers, local bytes and resident blocks an SM of the kernel at R40
// (128 threads, its T50 shared memory): out[0..2].
int ns_gram_attrs(int* out) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, (const void*)ns_gram_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = gram_smem(40);
  err = cudaFuncSetAttribute(ns_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)ns_gram_kernel,
                                                      tiled_threads(40), smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = at.numRegs;
  out[1] = (int)at.localSizeBytes;
  out[2] = blocks;
  return 0;
}

}  // extern "C"
