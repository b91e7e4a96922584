// A variant of csrc/hstep_stat.cu for tools/torch_variant_ab.py: the T <= 64
// route as independent segment groups of warps, each on its own named
// barrier (ROADMAP item 30's suggested design), timed in turns against the
// kernel in the package:
//
//   python3 tools/torch_variant_ab.py OUT.json --source hstep_stat \
//       --variant cur --variant "g1@tools/variants/hstep_stat_groups.cu" \
//       --variant "g2@tools/variants/hstep_stat_groups.cu=-DVLGP_NG=2 -DVLGP_NSF=2"
//
// A block holds VLGP_NG groups of GT threads (GT = 32 ceil(ntg^2 / 32), a
// 4 x 4 tile of sum_QP a thread; 6 warps at T50 R40).  Group g sums a
// contiguous share of its chunk's segments; per segment each thread forms
// its Q tile (Q = P X, then valid (P - Q) and valid X into registers),
// stages the next P from device memory and copies a later X, passes the
// group's barrier, then adds its sum_QP tile: one barrier of its group a
// segment, no barrier shared with another group.  Group g's partial sums
// are sub-chunk c NG + g of part, added in that order by the package's
// reduction launch.  VLGP_TARGET sets the blocks a launch aims at (264, as
// the package's), VLGP_NSF the float32 stages of X, VLGP_MINB the blocks an
// SM the 192-thread instance is compiled for.  With VLGP_NG=1 and the
// defaults the chunk map is the package's, so the sums have its bits.
//
// The package's source is included with its two C entry points renamed, so
// every other routine (the plan, the wide route, the reduction, the tile
// products) is the package's own.

#define hstep_stat hstep_stat_package
#define hstep_stat_plan hstep_stat_plan_package
#include "../../vlgp_tpu_torch/csrc/hstep_stat.cu"
#undef hstep_stat
#undef hstep_stat_plan

namespace {

#ifndef VLGP_NG
#define VLGP_NG 1
#endif
#ifndef VLGP_NSF
#define VLGP_NSF 3
#endif
#ifndef VLGP_TARGET
#define VLGP_TARGET 264
#endif
#ifndef VLGP_MINB
#define VLGP_MINB 3
#endif
template <typename T>
struct Grp;
template <>
struct Grp<float> {
  static constexpr int NS = VLGP_NSF;
};
template <>
struct Grp<double> {
  static constexpr int NS = 2;
};
inline int group_threads(int T) {
  const int ntg = pad4(T) / 4;
  return 32 * ((ntg * ntg + 31) / 32);
}
template <typename T>
size_t group_smem(int Tn, int R) {
  return (size_t)(5 * pad4(R) * pad4(Tn) + Grp<T>::NS * R * pad4(R)) * sizeof(T);
}
constexpr int SMEM_CAP = 232448;
inline int groups_of(int Tn, int R, bool dbl) {
  const size_t g = dbl ? group_smem<double>(Tn, R) : group_smem<float>(Tn, R);
  return (size_t)VLGP_NG * g <= (size_t)SMEM_CAP ? VLGP_NG : 1;
}

template <typename T, int NG, int NTMAX, int MINB>
__global__ void __launch_bounds__(NTMAX, MINB) hstep_stat_group_kernel(
    const T* __restrict__ G, const T* __restrict__ w, const T* __restrict__ X,
    const T* __restrict__ valid, T* __restrict__ part, int S, int Tn, int R, int spc, int chunks,
    long long ne, int vec) {
  constexpr int NS = Grp<T>::NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = pad4(Tn), rp = pad4(R);
  const int ntg = tp / 4, nrg = rp / 4;
  const int GT = blockDim.x / NG;
  const int g = threadIdx.x / GT, tid = threadIdx.x - g * GT;
  const size_t pbuf = (size_t)rp * tp;
  T* Pb = reinterpret_cast<T*>(smem_raw) + (size_t)g * (5 * pbuf + (size_t)NS * R * rp);
  T* Qb = Pb + 3 * pbuf;
  T* Xb = Qb + 2 * pbuf;
  const int c = blockIdx.x, z = blockIdx.z;
  const int cs0 = c * spc, cn = min(S, cs0 + spc) - cs0;
  const int per = (cn + NG - 1) / NG;
  const int gb = min(cn, g * per), n = min(cn, gb + per) - gb;
  const int s0 = cs0 + gb;
  const T* Gz = G + (size_t)z * Tn * R;
  const T* wz = w + ((size_t)z * S + s0) * Tn;
  const T* Xz = X + ((size_t)z * S + s0) * R * R;
  const T* vz = valid + s0;
  T* pz = part + (((size_t)z * chunks + c) * NG + g) * ne;
  auto gsync = [&]() {
    if constexpr (NG == 1)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "r"(GT) : "memory");
  };
  const int pstep = GT / tp, pt = tid % tp, pq0 = tid / tp;
  const bool stager = pq0 < pstep;
  auto w_of = [&](int k) { return stager && pt < Tn && k < n ? wz[(size_t)k * Tn + pt] : (T)0; };
  auto stage_p = [&](int b, T wk) {
    T* dst = Pb + b * pbuf;
    if (stager)
      for (int q = pq0; q < R; q += pstep)
        dst[q * tp + pt] = pt < Tn ? wk * __ldg(Gz + (size_t)pt * R + q) : (T)0;
  };
  auto copy_x_stage = [&](int k) {
    if (k < n) {
      T* dst = Xb + (size_t)(k % NS) * R * rp;
      const T* src = Xz + (size_t)k * R * R;
      if (vec) {
        constexpr int VW = 16 / sizeof(T);
        const int rw = R / VW;
        for (int i = tid; i < R * rw; i += GT) {
          const int q = i / rw, r = (i - q * rw) * VW;
          cp_async16(dst + q * rp + r, src + q * R + r);
        }
      } else {
        for (int e = tid; e < R * R; e += GT) {
          const int q = e / R;
          cp_async(dst + q * rp + (e - q * R), src + e);
        }
      }
    }
    asm volatile("cp.async.commit_group;" ::);
  };
  const bool qlive = tid < ntg * nrg, plive = tid < ntg * ntg;
  const int qtg = tid / nrg, qt0 = 4 * qtg, qr0 = 4 * (tid - qtg * nrg);
  const int ptg = tid / ntg, pt0 = 4 * ptg, pu0 = 4 * (tid - ptg * ntg);
  T acc[4][4], qa[4][4], sx[SX_MAX];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = (T)0;
      qa[i][j] = (T)0;
    }
#pragma unroll
  for (int m = 0; m < SX_MAX; ++m) sx[m] = (T)0;
  for (int k = 0; k < NS - 1; ++k) copy_x_stage(k);
  stage_p(0, w_of(0));
  T wnext = w_of(1);
  wait_x<NS>();
  gsync();
  for (int k = 0; k < n; ++k) {
    const T v = vz[k];
    const T* Pk = Pb + (k % 3) * pbuf;
    const T* Xk = Xb + (size_t)(k % NS) * R * rp;
    T* Qk = Qb + (k & 1) * pbuf;
    if (qlive) {
      T q[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) q[i][j] = (T)0;
      tile4(Pk + qt0, tp, Xk + qr0, rp, R, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T p[4], vq[4];
        load4p(Pk + (qr0 + j) * tp + qt0, p);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qa[i][j] = fma(v, p[i] - q[i][j], qa[i][j]);
          vq[i] = v * q[i][j];
        }
        store4(Qk + (qr0 + j) * tp + qt0, vq);
      }
    }
#pragma unroll
    for (int m = 0; m < SX_MAX; ++m) {
      const int e = tid + GT * m;
      if (e < R * rp) sx[m] = fma(v, Xk[e], sx[m]);
    }
    copy_x_stage(k + NS - 1);
    if (k + 1 < n) stage_p((k + 1) % 3, wnext);
    wnext = w_of(k + 2);
    wait_x<NS>();
    gsync();
    if (plive) tile4(Qk + pt0, tp, Pk + pu0, tp, R, acc);
  }
  if (plive) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (pt0 + i < Tn && pu0 + j < Tn) pz[(size_t)(pt0 + i) * Tn + pu0 + j] = acc[i][j];
  }
  T* qa_out = pz + (size_t)Tn * Tn;
  if (qlive) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (qt0 + i < Tn && qr0 + j < R) qa_out[(size_t)(qt0 + i) * R + qr0 + j] = qa[i][j];
  }
  T* sx_out = qa_out + (size_t)Tn * R;
#pragma unroll
  for (int m = 0; m < SX_MAX; ++m) {
    const int e = tid + GT * m, q = e / rp, r = e - q * rp;
    if (e < R * rp && r < R) sx_out[(size_t)q * R + r] = sx[m];
  }
}

template <typename T>
cudaError_t launch_groups(const T* G, const T* w, const T* X, const T* valid, T* part, T* qp,
                          T* qa, T* xo, int Z, int S, int Tn, int R, cudaStream_t st) {
  if (is_wide(Tn)) return launch(G, w, X, valid, part, qp, qa, xo, Z, S, Tn, R, st);
  Plan p = make_plan(Z, S, Tn, R, sizeof(T) == sizeof(double));
  const long long want = VLGP_TARGET / Z < 1 ? 1 : (VLGP_TARGET / Z > S ? S : VLGP_TARGET / Z);
  p.spc = (int)((S + want - 1) / want);
  p.chunks = (S + p.spc - 1) / p.spc;
  const int ng = groups_of(Tn, R, sizeof(T) == sizeof(double));
  const int gt = group_threads(Tn);
  auto kernel = hstep_stat_group_kernel<T, 1, 256, 1>;
  if (ng == 2)
    kernel = 2 * gt <= 384 ? hstep_stat_group_kernel<T, 2, 384, 2>
                           : hstep_stat_group_kernel<T, 2, 512, 1>;
  else if (gt <= 192)
    kernel = hstep_stat_group_kernel<T, 1, 192, VLGP_MINB>;
  const size_t smem = (size_t)ng * group_smem<T>(Tn, R);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = (R * sizeof(T)) % 16 == 0 && reinterpret_cast<size_t>(X) % 16 == 0;
  kernel<<<dim3(p.chunks, 1, Z), ng * gt, smem, st>>>(G, w, X, valid, part, S, Tn, R, p.spc,
                                                     p.chunks, p.ne, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 rgrid((unsigned)((p.ne + NTR - 1) / NTR), Z);
  hstep_stat_reduce_kernel<T><<<rgrid, NTR, 0, st>>>(part, X, valid, qp, qa, xo, S, Tn, R,
                                                     p.chunks * ng, p.ne, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hstep_stat_plan(int Z, int S, int T, int R, int is_double) {
  if (!valid_shape(Z, S, T, R)) return 0;
  if (is_wide(T)) return make_plan(Z, S, T, R, is_double != 0).chunks;
  const int want = VLGP_TARGET / Z < 1 ? 1 : (VLGP_TARGET / Z > S ? S : VLGP_TARGET / Z);
  const int spc = (S + want - 1) / want;
  return (S + spc - 1) / spc * groups_of(T, R, is_double != 0);
}

int hstep_stat(const void* G, const void* w, const void* X, const void* valid, void* part,
               void* sum_qp, void* sum_qa, void* sum_x, int Z, int S, int T, int R, int is_double,
               void* stream) {
  if (!valid_shape(Z, S, T, R)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch_groups((const double*)G, (const double*)w, (const double*)X,
                              (const double*)valid, (double*)part, (double*)sum_qp,
                              (double*)sum_qa, (double*)sum_x, Z, S, T, R, st);
  return (int)launch_groups((const float*)G, (const float*)w, (const float*)X,
                            (const float*)valid, (float*)part, (float*)sum_qp, (float*)sum_qa,
                            (float*)sum_x, Z, S, T, R, st);
}

}  // extern "C"
