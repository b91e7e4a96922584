// A variant of csrc/hstep_stat.cu for tools/torch_variant_ab.py: the T <= 64
// route on the FP64 tensor cores (mma.sync m16n8k16 .f64, full FP64 FMAs),
// timed in turns against the kernel in the package:
//
//   python3 tools/torch_variant_ab.py OUT.json --source hstep_stat \
//       --variant cur --variant "tc@tools/variants/hstep_stat_tc.cu"
//
// A block of 8 warps per (latent, chunk of segments), the package's chunk
// map.  Per segment all threads widen P_s = w~_s G (rounded once in T) and
// X_s to float64 in shared memory and add valid_s X_s into registers; warp
// (m, h) forms Q's row tile m of 16 over half h of its column tiles of 8
// (K = R padded to 16), adds valid (P - Q) into sum_QA in shared memory
// (float64) and stores valid Q; then adds valid Q P' into its sum_QP tiles
// (float64 fragments, rounded once at the chunk's end).  Three block
// barriers a segment; the next segment's X and w~ arrive by cp.async
// meanwhile.  The package's source is included with its two C entry points
// renamed, so the plan, the wide route and the reduction are the package's.

#define hstep_stat hstep_stat_package
#define hstep_stat_plan hstep_stat_plan_package
#include "../../vlgp_tpu_torch/csrc/hstep_stat.cu"
#undef hstep_stat
#undef hstep_stat_plan

namespace {

constexpr int TCW = 8;                 // warps a block
constexpr int TCT = 32 * TCW;          // threads a block
constexpr int TC_SX = BT * BT / TCT;   // sum_X entries a thread holds
constexpr int TC_NT = 4;               // n-tiles of 8 a warp holds at most

__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }
__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline size_t al16(size_t n) { return (n + 15) & ~(size_t)15; }

template <typename T>
struct Tc;
template <>
struct Tc<float> {
  static constexpr bool GS = true;   // G in shared memory
};
template <>
struct Tc<double> {
  static constexpr bool GS = false;  // it would not fit at T = R = 64
};

struct TcPlan {
  int tm16, tn8, rn8, rk16, ldp, ldx;
  size_t o_qd, o_xd, o_qa, o_xs, o_ws, o_gs, bytes;
};

template <typename T>
__host__ __device__ inline TcPlan tc_plan(int Tn, int R) {
  TcPlan p;
  p.tm16 = pad16(Tn);
  p.tn8 = pad8(Tn);
  p.rn8 = pad8(R);
  p.rk16 = pad16(R);
  p.ldp = p.rk16 + 4;                             // = 4 mod 8 doubles
  p.ldx = p.rn8 % 16 == 8 ? p.rn8 : p.rn8 + 8;    // = 8 mod 16 doubles
  const size_t pd = (size_t)p.tm16 * p.ldp * sizeof(double);
  p.o_qd = pd;
  p.o_xd = p.o_qd + pd;
  p.o_qa = p.o_xd + (size_t)p.rk16 * p.ldx * sizeof(double);
  p.o_xs = al16(p.o_qa + (size_t)Tn * R * sizeof(double));
  p.o_ws = al16(p.o_xs + 2 * (size_t)R * R * sizeof(T));
  p.o_gs = al16(p.o_ws + 2 * (size_t)Tn * sizeof(T));
  p.bytes = al16(p.o_gs + (Tc<T>::GS ? (size_t)Tn * R * sizeof(T) : 0));
  return p;
}

// d += a b, m16n8k16 in float64 (the fragments of mma.sync's .f64 layout)
__device__ __forceinline__ void mma16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <typename T>
__global__ void __launch_bounds__(TCT, 2) hstep_stat_tc_kernel(
    const T* __restrict__ G, const T* __restrict__ w, const T* __restrict__ X,
    const T* __restrict__ valid, T* __restrict__ part, int S, int Tn, int R, int spc, int chunks,
    long long ne, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const TcPlan L = tc_plan<T>(Tn, R);
  double* Pd = reinterpret_cast<double*>(smem_raw);           // [tm16][ldp]: P_s
  double* Qd = reinterpret_cast<double*>(smem_raw + L.o_qd);  // [tm16][ldp]: valid_s Q_s
  double* Xd = reinterpret_cast<double*>(smem_raw + L.o_xd);  // [rk16][ldx]: X_s
  double* Qa = reinterpret_cast<double*>(smem_raw + L.o_qa);  // [T][R]: sum_QA
  T* Xs = reinterpret_cast<T*>(smem_raw + L.o_xs);            // 2 x [R][R]: X as stored
  T* Ws = reinterpret_cast<T*>(smem_raw + L.o_ws);            // 2 x [T]: w~
  T* Gs = reinterpret_cast<T*>(smem_raw + L.o_gs);            // [T][R]: G (float)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int c = blockIdx.x, z = blockIdx.z;
  const int s0 = c * spc, n = min(S, s0 + spc) - s0;
  const int RR = R * R;
  const T* Gz = G + (size_t)z * Tn * R;
  const T* wz = w + ((size_t)z * S + s0) * Tn;
  const T* Xz = X + ((size_t)z * S + s0) * RR;
  const T* vz = valid + s0;
  T* pz = part + ((size_t)z * chunks + c) * ne;
  // warp (m, h): row tile m of Q and sum_QP, half h of their column tiles
  const int m = warp & 3, h = warp >> 2;
  const bool mw = 16 * m < L.tm16;
  const int nr = L.rn8 / 8, nu = L.tn8 / 8, nk = L.rk16 / 16;
  const int qj0 = h ? (nr + 1) / 2 : 0, qjn = (h ? nr : (nr + 1) / 2) - qj0;
  const int uj0 = h ? (nu + 1) / 2 : 0, ujn = (h ? nu : (nu + 1) / 2) - uj0;

  auto copy_stage = [&](int k) {  // X_k and w~_k into stage k & 1, one cp.async group
    if (k < n) {
      T* xd = Xs + (size_t)(k & 1) * RR;
      const T* xsrc = Xz + (size_t)k * RR;
      if (vec) {
        constexpr int VW = 16 / sizeof(T);
        for (int i = tid; i < RR / VW; i += TCT) cp_async16(xd + i * VW, xsrc + i * VW);
      } else {
        for (int i = tid; i < RR; i += TCT) cp_async(xd + i, xsrc + i);
      }
      for (int i = tid; i < Tn; i += TCT) cp_async(Ws + (k & 1) * Tn + i, wz + (size_t)k * Tn + i);
    }
    asm volatile("cp.async.commit_group;" ::);
  };
  copy_stage(0);
  // zero P, Q, X and sum_QA: the pads stay zero, the live parts are rewritten
  for (size_t i = tid; i < L.o_xs / sizeof(double); i += TCT) Pd[i] = 0.0;
  if (Tc<T>::GS)
    for (int i = tid; i < Tn * R; i += TCT) Gs[i] = Gz[i];

  double acc[TC_NT][4];
#pragma unroll
  for (int j = 0; j < TC_NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;
  T sx[TC_SX];
#pragma unroll
  for (int e = 0; e < TC_SX; ++e) sx[e] = (T)0;

  for (int k = 0; k < n; ++k) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();  // stage k is here; the last segment's readers of P, Q and X are done
    copy_stage(k + 1);
    const T* xk = Xs + (size_t)(k & 1) * RR;
    const T* wk = Ws + (k & 1) * Tn;
    const T v = vz[k];
    for (int t = warp; t < Tn; t += TCW) {
      const T wt = wk[t];
      for (int q = lane; q < R; q += 32)
        Pd[t * L.ldp + q] = (double)(wt * (Tc<T>::GS ? Gs[t * R + q] : __ldg(Gz + t * R + q)));
    }
    for (int q = warp; q < R; q += TCW)
      for (int r = lane; r < R; r += 32) Xd[q * L.ldx + r] = (double)xk[q * R + r];
#pragma unroll
    for (int e = 0; e < TC_SX; ++e) {
      const int i = tid + TCT * e;
      if (i < RR) sx[e] = fma(v, xk[i], sx[e]);
    }
    __syncthreads();
    const double vd = (double)v;
    if (mw) {
      // Q's tiles (m, qj0 + j): Q = P X
      double qf[TC_NT][4];
#pragma unroll
      for (int j = 0; j < TC_NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[j][i] = 0.0;
      for (int kk = 0; kk < nk; ++kk) {
        double a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = Pd[(16 * m + g + 8 * (i & 1)) * L.ldp + 16 * kk + t4 + 4 * (i >> 1)];
#pragma unroll
        for (int j = 0; j < TC_NT; ++j)
          if (j < qjn) {
            double b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              b[i] = Xd[(16 * kk + t4 + 4 * i) * L.ldx + 8 * (qj0 + j) + g];
            mma16(qf[j], a, b);
          }
      }
#pragma unroll
      for (int j = 0; j < TC_NT; ++j)
        if (j < qjn) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = 16 * m + g + 8 * (i >> 1), r = 8 * (qj0 + j) + 2 * t4 + (i & 1);
            if (t < Tn && r < R) {
              double& qa = Qa[t * R + r];
              qa = fma(vd, Pd[t * L.ldp + r] - qf[j][i], qa);
            }
            Qd[t * L.ldp + r] = r < R ? vd * qf[j][i] : 0.0;
          }
        }
    }
    __syncthreads();
    if (mw) {
      // sum_QP's tiles (m, uj0 + j) += valid Q P'
      for (int kk = 0; kk < nk; ++kk) {
        double a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = Qd[(16 * m + g + 8 * (i & 1)) * L.ldp + 16 * kk + t4 + 4 * (i >> 1)];
#pragma unroll
        for (int j = 0; j < TC_NT; ++j)
          if (j < ujn) {
            double b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              b[i] = Pd[(8 * (uj0 + j) + g) * L.ldp + 16 * kk + t4 + 4 * i];
            mma16(acc[j], a, b);
          }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();  // every sum_QA is in
  if (mw) {
#pragma unroll
    for (int j = 0; j < TC_NT; ++j)
      if (j < ujn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = 16 * m + g + 8 * (i >> 1), u = 8 * (uj0 + j) + 2 * t4 + (i & 1);
          if (t < Tn && u < Tn) pz[(size_t)t * Tn + u] = (T)acc[j][i];
        }
      }
  }
  for (int i = tid; i < Tn * R; i += TCT) pz[(size_t)Tn * Tn + i] = (T)Qa[i];
  T* sx_out = pz + (size_t)Tn * Tn + (size_t)Tn * R;
#pragma unroll
  for (int e = 0; e < TC_SX; ++e) {
    const int i = tid + TCT * e;
    if (i < RR) sx_out[i] = sx[e];
  }
}

template <typename T>
cudaError_t launch_tc(const T* G, const T* w, const T* X, const T* valid, T* part, T* qp, T* qa,
                      T* xo, int Z, int S, int Tn, int R, cudaStream_t st) {
  if (is_wide(Tn)) return launch(G, w, X, valid, part, qp, qa, xo, Z, S, Tn, R, st);
  const Plan p = make_plan(Z, S, Tn, R, sizeof(T) == sizeof(double));
  const TcPlan L = tc_plan<T>(Tn, R);
  cudaError_t err = cudaFuncSetAttribute(hstep_stat_tc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.bytes);
  if (err != cudaSuccess) return err;
  const int vec = ((size_t)R * R * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(X) % 16 == 0;
  hstep_stat_tc_kernel<T><<<dim3(p.chunks, 1, Z), TCT, L.bytes, st>>>(
      G, w, X, valid, part, S, Tn, R, p.spc, p.chunks, p.ne, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((unsigned)((p.ne + NTR - 1) / NTR), Z);
  hstep_stat_reduce_kernel<T><<<rgrid, NTR, 0, st>>>(part, X, valid, qp, qa, xo, S, Tn, R,
                                                     p.chunks, p.ne, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hstep_stat_plan(int Z, int S, int T, int R, int is_double) {
  return hstep_stat_plan_package(Z, S, T, R, is_double);
}

int hstep_stat(const void* G, const void* w, const void* X, const void* valid, void* part,
               void* sum_qp, void* sum_qa, void* sum_x, int Z, int S, int T, int R, int is_double,
               void* stream) {
  if (!valid_shape(Z, S, T, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch_tc((const double*)G, (const double*)w, (const double*)X,
                          (const double*)valid, (double*)part, (double*)sum_qp, (double*)sum_qa,
                          (double*)sum_x, Z, S, T, R, st);
  return (int)launch_tc((const float*)G, (const float*)w, (const float*)X, (const float*)valid,
                        (float*)part, (float*)sum_qp, (float*)sum_qa, (float*)sum_x, Z, S, T, R,
                        st);
}

}  // extern "C"
