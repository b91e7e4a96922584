// csrc/estep.cu's first design alone (a block per tile of 32 rows; a
// block per segment), as it stood before the launch plan and the
// streaming path, with clock stamps, for tools/torch_variant_ab.py: thread
// 0 of each block writes %globaltimer at the block's start, after each
// barrier-separated phase and at its end, and the SM it ran on, into a
// device table that estep_stamps() copies out; estep_attrs() gives each
// kernel's registers, local (spill) bytes and resident blocks an SM at the
// flagship's shared memory.  The arithmetic is the first design's, so the
// outputs keep its bits; the stamps add a store a phase.  It keeps that
// tree's C prototypes (no plan arguments), which the tool recognises:
//
//   python3 tools/torch_variant_ab.py OUT.json --source estep \
//       --variant "first@<that tree>/vlgp_tpu_torch/csrc/estep.cu=-Xptxas -v" \
//       --variant stamped@tools/variants/estep_block_stamped.cu
//
// Slots of a block's row: 0 the SM, 1 the start; estep_project: 2 mu and v
// staged, 3 the rows done, 4 the end; estep_step: 2 the prefetches issued,
// 3-7 the ends of phases A-E (of the last latent group), 8 the end (the
// weight refresh).

#include <cmath>

#include "../../vlgp_tpu_torch/csrc/ns_common.cuh"

namespace {

constexpr int NT = 256;        // threads of a block, both kernels
constexpr int RT = 32;         // rows of a tile of the row pass
constexpr int ZB = 8;          // latents summed at once by the row pass
constexpr int KY = 4;          // channels a lane loads at once
constexpr int NT_FEW = 512;    // threads of a stage b-c block when segments are few
constexpr int TCH = 64;        // rows of t a chunk of the sums over t, at least
constexpr int NCH_MAX = 16;    // chunks of the sums over t, at most
constexpr int SMS = 132;       // streaming multiprocessors of an H100
constexpr int ZMAX = 128;
constexpr int RMAX = 128;

constexpr int STAMP_BLOCKS = 4096;
constexpr int NSTAMP = 10;
__device__ unsigned long long g_stamps[2][STAMP_BLOCKS][NSTAMP];

__device__ __forceinline__ void stamp(int which, int slot) {
  if (threadIdx.x != 0 || blockIdx.x >= STAMP_BLOCKS) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (slot == 1) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[which][blockIdx.x][0] = sm;
  }
  g_stamps[which][blockIdx.x][slot] = t;
}

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// min(x, 10) and max(x, 1e-30) that keep a NaN, as torch.clamp does
template <typename T>
__device__ __forceinline__ T clip_hi(T x) {
  return x > T(10) ? T(10) : x;
}
template <typename T>
__device__ __forceinline__ T safe_noise(T x) {
  return x < T(1e-30) ? T(1e-30) : x;
}
template <typename T>
__device__ __forceinline__ T clip(T x, T b) {
  return x < -b ? -b : (x > b ? b : x);
}

// sum over a quad of lanes (4 k .. 4 k + 3), xor 1 then 2: every lane of
// the quad ends with the same bits
template <typename T>
__device__ __forceinline__ T qsum(T x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Sums over the warp of ZB values a lane: a reduce-scatter by halves (xor
// 16, 8 and 4: each lane keeps half of its values and adds its partner's
// other half), then xor 2 and 1.  9 shuffles in place of 5 ZB; lane 4 q ends
// with the sum of acc[q], in a fixed order.
template <typename T>
__device__ __forceinline__ T warp_sums(const T (&acc)[ZB], int lane) {
  static_assert(ZB == 8, "the reduce-scatter halves 8 values three times");
  T a4[4], a2[2];
  const bool u16 = lane & 16, u8 = lane & 8, u4 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a4[i] = (u16 ? acc[i + 4] : acc[i]) +
            __shfl_xor_sync(0xffffffffu, u16 ? acc[i] : acc[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    a2[i] = (u8 ? a4[i + 2] : a4[i]) + __shfl_xor_sync(0xffffffffu, u8 ? a4[i] : a4[i + 2], 8);
  T x = (u4 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, u4 ? a2[0] : a2[1], 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// chunks of the sums over t in stage b-c's phases A and C, a function of T
// alone: at most NCH_MAX of ceil(T / chunks) rows, at least TCH each
__host__ __device__ inline int t_chunks(int T) {
  const int n = (T + TCH - 1) / TCH;
  return n < NCH_MAX ? n : NCH_MAX;
}

// ask L2 for the 128-byte lines of [p, p + bytes), the block's threads
// taking every blockDim.x-th line
__device__ __forceinline__ void prefetch_span(const void* p, size_t bytes) {
  const size_t first = reinterpret_cast<size_t>(p) & ~size_t(127);
  const size_t end = reinterpret_cast<size_t>(p) + bytes;
  for (size_t a = first + (size_t)threadIdx.x * 128; a < end; a += (size_t)blockDim.x * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(a));
}

template <typename T>
struct RowArgs {
  const T* y;                 // (N, Y); stage a only
  const T* xb;                // (N, Y)
  const T* mask;              // (N,)
  const T* a;                 // (Z, Y)
  const unsigned char* pois;  // (Y,) 1 on a Poisson channel
  const T* noise;             // (Y,)
  long long N;                // S T rows
  int Y, Z;
};

// One tile of rows n0 .. n0 + nr - 1 (nr <= RT) of the row pass, by the
// whole block: out[z, n] = sum_y resid[n, y] a[z, y] (PROJECT) or
// (sum_y U[n, y] a[z, y]^2) mask[n], from mu and v (Z, N).  mu is read
// with plain loads: stage b-c passes the mu it has just written.  Uses 3 Z
// RT values of shared memory at sm.  NTH threads a block.
template <typename T, bool PROJECT, bool SMALL, int NTH>
__device__ void row_tile(const RowArgs<T>& p, const T* mu, const T* v, T* out, long long n0,
                         int nr, T* sm) {
  const int Z = p.Z, Y = p.Y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long N = p.N;
  T* muS = sm;  // Z x RT
  T* vS = muS + Z * RT;
  T* oS = vS + Z * RT;
  for (int i = tid; i < Z * RT; i += NTH) {
    const int z = i / RT, j = i - z * RT;
    if (j < nr) {
      muS[i] = mu[z * N + n0 + j];
      vS[i] = v[z * N + n0 + j];
    }
  }
  __syncthreads();
  if (PROJECT) stamp(0, 2);
  for (int j = warp; j < nr; j += NTH / 32) {
    const long long n = n0 + j;
    const T mk = p.mask[n];
    const T* xr = p.xb + n * Y;
    const T* yr = PROJECT ? p.y + n * Y : nullptr;
    T muR[ZB], vR[ZB];
#pragma unroll
    for (int q = 0; q < ZB; ++q) {
      muR[q] = SMALL && q < Z ? muS[q * RT + j] : T(0);
      vR[q] = SMALL && q < Z ? vS[q * RT + j] : T(0);
    }
    for (int zb = 0; zb < Z; zb += ZB) {
      T acc[ZB];
#pragma unroll
      for (int q = 0; q < ZB; ++q) acc[q] = T(0);
      for (int y0 = lane; y0 < Y; y0 += 32 * KY) {
        T xv[KY], yv[KY];
#pragma unroll
        for (int k = 0; k < KY; ++k) {  // KY loads of each row in flight
          const int c = y0 + 32 * k;
          xv[k] = c < Y ? __ldg(xr + c) : T(0);
          yv[k] = PROJECT && c < Y ? __ldg(yr + c) : T(0);
        }
#pragma unroll
        for (int k = 0; k < KY; ++k) {
          const int c = y0 + 32 * k;
          if (c >= Y) break;
          T ar[ZB];
          T e = T(0), g = T(0);
          if (SMALL) {
#pragma unroll
            for (int q = 0; q < ZB; ++q) {
              ar[q] = q < Z ? __ldg(p.a + (size_t)q * Y + c) : T(0);
              if (q < Z) {
                e = fma_t(muR[q], ar[q], e);
                g = fma_t(vR[q], T(0.5) * ar[q] * ar[q], g);
              }
            }
          } else {
            for (int z = 0; z < Z; ++z) {
              const T az = __ldg(p.a + (size_t)z * Y + c);
              e = fma_t(muS[z * RT + j], az, e);
              g = fma_t(vS[z * RT + j], T(0.5) * az * az, g);
            }
#pragma unroll
            for (int q = 0; q < ZB; ++q)
              ar[q] = zb + q < Z ? __ldg(p.a + (size_t)(zb + q) * Y + c) : T(0);
          }
          e = e + xv[k];
          const T r = exp_t(clip_hi(e + g));
          T val;
          if (p.pois[c] != 0) {  // a select per channel: the other side is never formed
            val = PROJECT ? yv[k] - r : r;
          } else {
            const T sn = safe_noise(__ldg(p.noise + c));
            val = PROJECT ? (yv[k] - e) / sn : T(1) / sn;
          }
          if (PROJECT) val *= mk;
#pragma unroll
          for (int q = 0; q < ZB; ++q)
            if (zb + q < Z) acc[q] = fma_t(val, PROJECT ? ar[q] : ar[q] * ar[q], acc[q]);
        }
      }
      const T sum = warp_sums(acc, lane);
      const int q = lane >> 2;
      if ((lane & 3) == 0 && zb + q < Z) oS[(zb + q) * RT + j] = PROJECT ? sum : sum * mk;
    }
  }
  __syncthreads();
  if (PROJECT) stamp(0, 3);
  for (int i = tid; i < Z * RT; i += NTH) {
    const int z = i / RT, j = i - z * RT;
    if (j < nr) out[z * N + n0 + j] = oS[i];
  }
  __syncthreads();  // the tile's shared memory is free for the next user
}

template <typename T, bool SMALL>
__global__ void __launch_bounds__(NT)
    estep_project_kernel(RowArgs<T> p, const T* mu, const T* v, T* s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  stamp(0, 1);
  const long long n0 = (long long)blockIdx.x * RT;
  const long long left = p.N - n0;
  row_tile<T, true, SMALL, NT>(p, mu, v, s, n0, left < RT ? (int)left : RT,
                           reinterpret_cast<T*>(smem_raw));
  stamp(0, 4);
}

template <typename T>
struct StepArgs {
  RowArgs<T> rows;  // y unused
  const T* G;       // (Z, T, R)
  const T* s;       // (Z, S, T)
  const T* mu;      // (Z, S, T)
  const T* w;       // (Z, S, T), the carried weights
  const T* X;       // (Z, S, R, R)
  const T* v;       // (Z, S, T)
  T* mu_out;        // (Z, S, T)
  T* dmu;           // (Z, S, T): u between phases B and E, then delta
  T* w_out;         // (Z, S, T): w u between phases B and C, then the new weights
  int S, Tn, R, zg;
  T bound;
};

template <typename T, bool SMALL, int NTH>
__global__ void __launch_bounds__(NTH) estep_step_kernel(StepArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int seg = blockIdx.x, tid = threadIdx.x, quad = tid >> 2, k = tid & 3;
  const int Tn = p.Tn, R = p.R, Z = p.rows.Z, Y = p.rows.Y;
  const long long L = p.rows.N;  // S T: the stride of a latent in (Z, S, T)
  stamp(1, 1);
  const long long base = (long long)seg * Tn;
  const T* mk = p.rows.mask + base;
  // the segment's inputs on their way to L2 before the phases read them
  const T* zrows[4] = {p.s, p.mu, p.w, p.v};
  for (int z = 0; z < Z; ++z) {
    prefetch_span(p.X + ((size_t)z * p.S + seg) * R * R, (size_t)R * R * sizeof(T));
    for (int j = 0; j < 4; ++j) prefetch_span(zrows[j] + z * L + base, Tn * sizeof(T));
  }
  prefetch_span(p.rows.xb + base * Y, (size_t)Tn * Y * sizeof(T));
  prefetch_span(mk, Tn * sizeof(T));
  stamp(1, 2);
  const int nch = t_chunks(Tn), tch = (Tn + nch - 1) / nch;
  for (int z0 = 0; z0 < Z; z0 += p.zg) {
    const int zc = min(p.zg, Z - z0), nzr = zc * R;
    T* gs = sm;  // zc x R each
    T* gwu = gs + nzr;
    T* mv = gwu + nzr;
    T* part = mv + nzr;  // nch x zc x R: the chunks' sums of A and C
    // A. G's: a thread per (z, r) and chunk of t, t in increasing order, then
    // the chunks added in order
    for (int o = tid; o < nzr * nch; o += NTH) {
      const int c = o / nzr, zr = o - c * nzr, zl = zr / R, r = zr - zl * R;
      const T* Gz = p.G + (size_t)(z0 + zl) * Tn * R + r;
      const T* sz = p.s + (z0 + zl) * L + base;
      const int t1 = min(Tn, (c + 1) * tch);
      T acc = T(0);
#pragma unroll 4
      for (int t = c * tch; t < t1; ++t) acc = fma_t(__ldg(Gz + (size_t)t * R), __ldg(sz + t), acc);
      part[o] = acc;
    }
    __syncthreads();
    for (int o = tid; o < nzr; o += NTH) {
      T acc = part[o];
      for (int c = 1; c < nch; ++c) acc += part[c * nzr + o];
      gs[o] = acc;
    }
    __syncthreads();
    stamp(1, 3);
    // B. u = G G's - mu and w u, a quad per (z, t)
    for (int o0 = 0; o0 < zc * Tn; o0 += NTH / 4) {
      const int o = o0 + quad;
      const bool live = o < zc * Tn;
      const int zl = live ? o / Tn : 0, t = live ? o - zl * Tn : 0;
      const long long i = (z0 + zl) * L + base + t;
      T acc = T(0), m = T(0), wm = T(0);
      if (live) {
        if (k == 0) {
          m = __ldg(p.mu + i);
          wm = __ldg(p.w + i) * __ldg(mk + t);
        }
        const T* Gt = p.G + ((size_t)(z0 + zl) * Tn + t) * R;
        const T* g = gs + zl * R;
#pragma unroll 4
        for (int r = k; r < R; r += 4) acc = fma_t(__ldg(Gt + r), g[r], acc);
      }
      acc = qsum(acc);
      if (live && k == 0) {
        const T u = acc - m;
        p.dmu[i] = u;
        p.w_out[i] = wm * u;
      }
    }
    __syncthreads();
    stamp(1, 4);
    // C. G'(w u), as A
    for (int o = tid; o < nzr * nch; o += NTH) {
      const int c = o / nzr, zr = o - c * nzr, zl = zr / R, r = zr - zl * R;
      const T* Gz = p.G + (size_t)(z0 + zl) * Tn * R + r;
      const T* wu = p.w_out + (z0 + zl) * L + base;
      const int t1 = min(Tn, (c + 1) * tch);
      T acc = T(0);
#pragma unroll 4
      for (int t = c * tch; t < t1; ++t) acc = fma_t(__ldg(Gz + (size_t)t * R), wu[t], acc);
      part[o] = acc;
    }
    __syncthreads();
    for (int o = tid; o < nzr; o += NTH) {
      T acc = part[o];
      for (int c = 1; c < nch; ++c) acc += part[c * nzr + o];
      gwu[o] = acc;
    }
    __syncthreads();
    stamp(1, 5);
    // D. X G'(w u), a quad per row of X
    for (int o0 = 0; o0 < zc * R; o0 += NTH / 4) {
      const int o = o0 + quad;
      const bool live = o < zc * R;
      T acc = T(0);
      if (live) {
        const int zl = o / R, r = o - zl * R;
        const T* Xr = p.X + (((size_t)(z0 + zl) * p.S + seg) * R + r) * R;
        const T* g = gwu + zl * R;
#pragma unroll 4
        for (int q = k; q < R; q += 4) acc = fma_t(__ldg(Xr + q), g[q], acc);
      }
      acc = qsum(acc);
      if (live && k == 0) mv[o] = acc;
    }
    __syncthreads();
    stamp(1, 6);
    // E. delta = u - G X G'(w u), clipped and masked; mu + delta, a quad per (z, t)
    for (int o0 = 0; o0 < zc * Tn; o0 += NTH / 4) {
      const int o = o0 + quad;
      const bool live = o < zc * Tn;
      const int zl = live ? o / Tn : 0, t = live ? o - zl * Tn : 0;
      const long long i = (z0 + zl) * L + base + t;
      T acc = T(0), u = T(0), m = T(0), mkt = T(0);
      if (live) {
        if (k == 0) {
          u = p.dmu[i];
          m = __ldg(p.mu + i);
          mkt = __ldg(mk + t);
        }
        const T* Gt = p.G + ((size_t)(z0 + zl) * Tn + t) * R;
        const T* g = mv + zl * R;
#pragma unroll 4
        for (int r = k; r < R; r += 4) acc = fma_t(__ldg(Gt + r), g[r], acc);
      }
      acc = qsum(acc);
      if (live && k == 0) {
        const T d = clip(u - acc, p.bound) * mkt;
        p.dmu[i] = d;
        p.mu_out[i] = m + d;
      }
    }
    __syncthreads();
    stamp(1, 7);
  }
  // the weights from the new mu and the old v
  for (int t0 = 0; t0 < Tn; t0 += RT)
    row_tile<T, false, SMALL, NTH>(p.rows, p.mu_out, p.v, p.w_out, base + t0, min(RT, Tn - t0),
                                   sm);
  stamp(1, 8);
}

// latents a group of stage b-c: all of them, but where the group's (3 +
// chunks) zg R values would pass the row pass's 3 ZMAX RT
int latent_group(int Z, int R, int T) {
  const int zg = 3 * ZMAX * RT / ((3 + t_chunks(T)) * R);
  return zg < Z ? zg : Z;
}

template <typename T>
size_t row_smem(int Z) {
  return (size_t)3 * Z * RT * sizeof(T);
}

template <typename T>
RowArgs<T> row_args(const void* y, const void* xb, const void* mask, const void* a,
                    const void* pois, const void* noise, long long N, int Y, int Z) {
  return RowArgs<T>{(const T*)y, (const T*)xb, (const T*)mask, (const T*)a,
                    (const unsigned char*)pois, (const T*)noise, N, Y, Z};
}

template <typename T>
cudaError_t launch_project(const RowArgs<T>& p, const void* mu, const void* v, void* s,
                           cudaStream_t st) {
  const size_t smem = row_smem<T>(p.Z);
  const unsigned blocks = (unsigned)((p.N + RT - 1) / RT);
  auto kernel = p.Z <= ZB ? &estep_project_kernel<T, true> : &estep_project_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NT, smem, st>>>(p, (const T*)mu, (const T*)v, (T*)s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step(const StepArgs<T>& p, cudaStream_t st) {
  const size_t wood = (size_t)(3 + t_chunks(p.Tn)) * p.zg * p.R * sizeof(T);
  const size_t rows = row_smem<T>(p.rows.Z);
  const size_t smem = wood > rows ? wood : rows;
  // fewer segments than two blocks an SM: wider blocks, for more rows in
  // flight (the sums do not depend on the block's width)
  const bool few = p.S < 2 * SMS;
  const int nth = few ? NT_FEW : NT;
  auto kernel = p.rows.Z <= ZB ? (few ? &estep_step_kernel<T, true, NT_FEW>
                                      : &estep_step_kernel<T, true, NT>)
                               : (few ? &estep_step_kernel<T, false, NT_FEW>
                                      : &estep_step_kernel<T, false, NT>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.S, nth, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Stage a: y and xb (N, Y), mask (N,), a (Z, Y), mu and v (Z, N), pois (Y)
// bytes, noise (Y,), s (Z, N) out; N = S T rows, all contiguous, float64
// when is_double else float32.
int estep_project(const void* y, const void* xb, const void* mask, const void* a, const void* mu,
                  const void* v, const void* pois, const void* noise, void* s, int N, int Y,
                  int Z, int is_double, void* stream) {
  if (N < 1 || Y < 1 || Z < 1 || Z > ZMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch_project(row_args<double>(y, xb, mask, a, pois, noise, N, Y, Z), mu, v, s,
                               st);
  return (int)launch_project(row_args<float>(y, xb, mask, a, pois, noise, N, Y, Z), mu, v, s, st);
}

// Stages b and c: G (Z, T, R), s, mu, w and v (Z, S, T), X (Z, S, R, R),
// mask (S, T), a (Z, Y), xb (S, T, Y), pois (Y) bytes, noise (Y,);
// mu_out, dmu and w_out (Z, S, T) out, all contiguous, float64 when
// is_double else float32.
int estep_step(const void* G, const void* s, const void* mu, const void* w, const void* X,
               const void* mask, const void* a, const void* xb, const void* v, const void* pois,
               const void* noise, void* mu_out, void* dmu, void* w_out, int S, int T, int Y,
               int Z, int R, double dmu_bound, int is_double, void* stream) {
  if (S < 1 || T < 1 || Y < 1 || Z < 1 || Z > ZMAX || R < 1 || R > RMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long N = (long long)S * T;
  const int zg = latent_group(Z, R, T);
  if (is_double) {
    StepArgs<double> p{row_args<double>(nullptr, xb, mask, a, pois, noise, N, Y, Z),
                       (const double*)G, (const double*)s, (const double*)mu, (const double*)w,
                       (const double*)X, (const double*)v, (double*)mu_out, (double*)dmu,
                       (double*)w_out, S, T, R, zg, dmu_bound};
    return (int)launch_step(p, st);
  }
  StepArgs<float> p{row_args<float>(nullptr, xb, mask, a, pois, noise, N, Y, Z),
                    (const float*)G, (const float*)s, (const float*)mu, (const float*)w,
                    (const float*)X, (const float*)v, (float*)mu_out, (float*)dmu,
                    (float*)w_out, S, T, R, zg, (float)dmu_bound};
  return (int)launch_step(p, st);
}

// The stamp table of `which` (0 estep_project, 1 estep_step) into the host
// buffer out (STAMP_BLOCKS x NSTAMP 64-bit values); reset = 1 zeroes it.
int estep_stamps(int which, void* out, int reset) {
  const size_t bytes = sizeof(unsigned long long) * STAMP_BLOCKS * NSTAMP;
  if (reset) {
    static unsigned long long zero[STAMP_BLOCKS * NSTAMP];
    return (int)cudaMemcpyToSymbol(g_stamps, zero, bytes, which * bytes);
  }
  return (int)cudaMemcpyFromSymbol(out, g_stamps, bytes, which * bytes);
}

// Registers, local bytes and resident blocks an SM of the float32 SMALL
// kernels at Z5 T50 R40 (the flagship): out[0..2] estep_project, out[3..5]
// estep_step with 256 threads, out[6..8] with 512.
int estep_attrs(int* out) {
  const void* ks[3] = {(const void*)&estep_project_kernel<float, true>,
                       (const void*)&estep_step_kernel<float, true, NT>,
                       (const void*)&estep_step_kernel<float, true, NT_FEW>};
  const int nth[3] = {NT, NT, NT_FEW};
  const size_t smem[3] = {row_smem<float>(5), (size_t)(3 + t_chunks(50)) * 5 * 40 * 4,
                          (size_t)(3 + t_chunks(50)) * 5 * 40 * 4};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes at;
    cudaError_t err = cudaFuncGetAttributes(&at, ks[i]);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    const size_t sm = smem[i] > row_smem<float>(5) ? smem[i] : row_smem<float>(5);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ks[i], nth[i], sm);
    if (err != cudaSuccess) return (int)err;
    out[3 * i] = at.numRegs;
    out[3 * i + 1] = (int)at.localSizeBytes;
    out[3 * i + 2] = blocks;
  }
  return 0;
}

}  // extern "C"
