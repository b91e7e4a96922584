// The Euler-integrated Lorenz trajectory in one launch, for Hopper: the
// counterpart of vlgp_tpu/simulation.py:lorenz (one lax.scan, :107-126),
// which has no Pallas kernel.  The port's plain version
// (vlgp_tpu_torch/simulation.py:_lorenz_plain) runs the step loop on the
// host, ~13 tiny launches per step.
//
// One thread integrates the n - 1 steps in registers from xs[0] (written
// by the wrapper) and stores each state into xs (n, 3), float64 or float32.
// The operations and their order are the plain loop's, each rounded on its
// own: the _rn intrinsics are never contracted into an FMA, and s, r, b
// and dt are rounded to the dtype first, as torch rounds a Python scalar
// beside a float32 tensor.  The system is chaotic (an ulp grows ~e^{0.9 t},
// and the trajectory runs 1,010 time units), so the kernel must equal the
// plain version bit for bit, and does:
//
//   dx = s (y - x),  dy = (r x - y) - x z,  dz = x y - b z,  new = x + dt d.
//
// What bounds it on this card: the chain of dependent floating-point
// operations of a step (five: r x, - y, - x z, dt *, x +), times n.  The
// bytes (24 n in float64) take under a microsecond at 3.35 TB/s; the
// stores never wait.  One thread is all the chain allows.

#include "ns_common.cuh"

namespace {

template <typename T>
struct Rn;

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
};

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
};

template <typename T>
__global__ void lorenz_kernel(T* __restrict__ xs, int n, double dt_, double s_, double r_,
                              double b_) {
  using R = Rn<T>;
  const T dt = (T)dt_, s = (T)s_, r = (T)r_, b = (T)b_;
  T x = xs[0], y = xs[1], z = xs[2];
  for (int i = 1; i < n; ++i) {
    const T dx = R::mul(s, R::sub(y, x));
    const T dy = R::sub(R::sub(R::mul(r, x), y), R::mul(x, z));
    const T dz = R::sub(R::mul(x, y), R::mul(b, z));
    x = R::add(x, R::mul(dt, dx));
    y = R::add(y, R::mul(dt, dy));
    z = R::add(z, R::mul(dt, dz));
    T* out = xs + 3 * (size_t)i;
    out[0] = x;
    out[1] = y;
    out[2] = z;
  }
}

}  // namespace

extern "C" {

// xs (n, 3), contiguous, float64 when is_double else float32, xs[0] the
// start; n >= 1.
int lorenz(void* xs, int n, int is_double, double dt, double s, double r, double b,
           void* stream) {
  if (n < 1 || xs == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    lorenz_kernel<double><<<1, 1, 0, st>>>((double*)xs, n, dt, s, r, b);
  else
    lorenz_kernel<float><<<1, 1, 0, st>>>((float*)xs, n, dt, s, r, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
