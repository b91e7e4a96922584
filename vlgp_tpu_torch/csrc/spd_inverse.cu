// Batched SPD inverse A^{-1} for Hopper: replaces
// vlgp_tpu/ops/spd.py:_spd_inverse_pallas (kernel body _spd_inverse_kernel).
//
// The TPU kernel's algorithm, per matrix: Cholesky by right-looking rank-1
// updates, where the pivot d = L[j, j] is clamped to 1e-30 (NaN propagates)
// and scaled by p = 1 / sqrt(d), column j becomes (0 above, d p at j,
// L[i > j, j] p below) and the trailing block loses c c'; L^-1 by forward
// substitution; A^-1 = L^-T L^-1.
//
// What bounds it on this card.  The work is small and sequential: at
// R = 40 about 25k FMAs per matrix against 12.8 KB of traffic, so the byte
// bound (B10000 R40: 0.038 ms) is far below the cost of the factor's R
// dependent column steps.  Measured on an H100 (700 W) one column a step:
// 528 matrices, one per warp scheduler, took 0.035 ms, and each further
// wave of 32 teams per SM ~0.075 ms, so the 32 warps an SM holds hide only
// part of a matrix's latency.  That latency binds, with the instruction
// rate; shared-memory bandwidth and bytes do not.  The design cuts the steps,
// and the instructions in each:
//
//   * A team per matrix: one warp for R <= 64, four warps (a named barrier,
//     bar.sync id, 128) for 64 < R <= 128; a block holds several teams, and
//     a team past the batch's end returns.  Teams sync only among
//     themselves, with __syncwarp or their named barrier, twice a step.
//   * The matrix sits in shared memory with the stride ld = padded_ld(R),
//     4 times an odd number (44 at R = 40): 16-byte reads of four columns
//     of a row, each lane its own row, and scalar reads across a row are
//     free of bank conflicts.  A loads with 16-byte accesses when R is
//     even; the pads are zeroed.
//   * Left-looking Cholesky fused with the substitution, two columns a
//     step.  Step j: each lane forms, for its live rows i, s_i = A[i, j] -
//     sum_{k<j} L[i, k] L[j, k] and u_i (the same for column j + 1), and
//     for its columns q the sums x_q and y_q of L[j, k] L^-1[k, q] and
//     L[j + 1, k] L^-1[k, q], off two broadcasts, four k at a time, with no
//     store in the loop.  Warp 0 shuffles the pivot of column j, c_{j+1} =
//     L[j + 1, j] and the pivot of column j + 1; each lane applies the
//     k = j term u_i -= c_i c_{j+1} in registers (the same FMAs in the same
//     order as the TPU kernel's rank-1 updates) and writes columns j and
//     j + 1 of L and rows j and j + 1 of L^-1, over rows j and j + 1 of L,
//     which no later step reads.  Only live rows are read: lane t takes row
//     j + t, and a warp skips the row or column half it has no live entry
//     in.
//   * A^-1 = L^-T L^-1 on the lower triangle only: a lane owns a 4 x 4 tile
//     and sums k from R - 1 down to its first row, since L^-1[k, r] = 0 for
//     k < r; off-diagonal tiles are stored twice.  16-byte loads, and
//     16-byte stores when R % 4 == 0.
//
// The pivot scale is rsqrtf and 1 / L[j, j] is __frcp_rn: they round
// apart from the plain version by a few ulp, well inside its 1e-4
// agreement.
// Every multiply is a full float32 FMA; there are no atomics, so repeated
// calls give the same bits.

#include <cstdint>

#include "ns_common.cuh"

namespace {

using namespace vlgp;

constexpr int NT = 256;  // threads per block: 8 warp teams or 2 four-warp teams

template <int TEAM>
__device__ __forceinline__ void team_sync(int bar) {
  if constexpr (TEAM == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(TEAM) : "memory");
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// s -= sum over the four k of row[k] l[k], in increasing k
__device__ __forceinline__ float dot4_sub(float s, float4 row, float4 l) {
  s = fmaf(-row.x, l.x, s);
  s = fmaf(-row.y, l.y, s);
  s = fmaf(-row.z, l.z, s);
  return fmaf(-row.w, l.w, s);
}

// x += sum over the four k of l[k] v[k], in increasing k
__device__ __forceinline__ float dot4_add(float x, float4 l, float4 v) {
  x = fmaf(l.x, v.x, x);
  x = fmaf(l.y, v.y, x);
  x = fmaf(l.z, v.z, x);
  return fmaf(l.w, v.w, x);
}

// four consecutive rows of one column
__device__ __forceinline__ float4 col4(const float* c, int ld) {
  return make_float4(c[0], c[ld], c[2 * ld], c[3 * ld]);
}

// The dot products of a column pair (j, j + 1) over k < j, off the
// broadcasts l = L[j, k] and m = L[j + 1, k], four k at a time; in the
// last chunk both are zero past k = j - 1 (the tile's pads are zero, so
// every term is finite).  For NR owned rows i (r0, r1): s = A[i, j] -
// sum L[i, k] l and u = A[i, j + 1] - sum L[i, k] m; for NC owned columns
// q (c0, c1 point into row 0): x = sum l L^-1[k, q] and y = sum m
// L^-1[k, q].
template <int NR, int NC>
__device__ __forceinline__ void dots(const float* Lj, const float* Lj1, const float* r0,
                                     const float* r1, const float* c0, const float* c1,
                                     int ld, int j, float (&s)[2], float (&u)[2],
                                     float (&x)[2], float (&y)[2]) {
  for (int k = 0; k < j; k += 4) {
    float4 l = ld4(Lj + k), m = ld4(Lj1 + k);
    if (k + 4 > j) {  // the last chunk: nothing past k = j - 1
      l.w = m.w = 0.f;
      if (k + 3 > j) l.z = m.z = 0.f;
      if (k + 2 > j) l.y = m.y = 0.f;
    }
    if (NR > 0) {
      const float4 a = ld4(r0 + k);
      s[0] = dot4_sub(s[0], a, l);
      u[0] = dot4_sub(u[0], a, m);
    }
    if (NR > 1) {
      const float4 a = ld4(r1 + k);
      s[1] = dot4_sub(s[1], a, l);
      u[1] = dot4_sub(u[1], a, m);
    }
    if (NC > 0) {
      const float4 v = col4(c0 + k * ld, ld);
      x[0] = dot4_add(x[0], l, v);
      y[0] = dot4_add(y[0], m, v);
    }
    if (NC > 1) {
      const float4 v = col4(c1 + k * ld, ld);
      x[1] = dot4_add(x[1], l, v);
      y[1] = dot4_add(y[1], m, v);
    }
  }
}

__device__ __forceinline__ float pivot_scale(float d) {  // 1 / sqrt(d), d clamped
  return rsqrtf((d > 1e-30f || d != d) ? d : 1e-30f);
}

// Cholesky and L^-1 in place, two columns a step: on return the tile holds
// L^-1 (zero above the diagonal).  At step j lane t owns the live row j + t
// (rows above j are done, and a left-looking step carries nothing over)
// and column t; with one warp at R > 32 also row j + t + 32 and column
// t + 32.  Column j + 1 takes the k = j term after column j is known:
// u_i -= c_i c_{j+1}, the same FMAs in the same order as one column a step.
template <int TEAM>
__device__ __forceinline__ void factor_invert(float* L, float* dsh, int R, int ld, int t,
                                              int bar) {
  const bool hasB = TEAM == 32 && R > 32;
  const int wbase = t & ~31;
  const int q[2] = {t, t + 32};
  const float* c0 = L + min(q[0], R - 1);
  const float* c1 = L + min(q[1], R - 1);
  for (int j = 0; j < R; j += 2) {
    const bool two = j + 1 < R;
    const float* Lj = L + j * ld;
    const float* Lj1 = two ? Lj + ld : Lj;
    const int i[2] = {j + t, j + t + 32};
    const float* r0 = L + min(i[0], R - 1) * ld;
    const float* r1 = L + min(i[1], R - 1) * ld;
    float s[2] = {r0[j], r1[j]}, u[2] = {r0[j + 1], r1[j + 1]};
    float x[2] = {0.f, 0.f}, y[2] = {0.f, 0.f};
    // warp-uniform: which halves have a live row (i < R) or column (q < j)
    const bool ra = j + wbase < R;
    const bool rb = hasB && j + 32 < R;
    const bool ca = j > wbase;
    const bool cb = hasB && j > 32;
    if (rb) {
      dots<2, 1>(Lj, Lj1, r0, r1, c0, c1, ld, j, s, u, x, y);
    } else if (ra) {
      if (cb) dots<1, 2>(Lj, Lj1, r0, r1, c0, c1, ld, j, s, u, x, y);
      else if (ca) dots<1, 1>(Lj, Lj1, r0, r1, c0, c1, ld, j, s, u, x, y);
      else dots<1, 0>(Lj, Lj1, r0, r1, c0, c1, ld, j, s, u, x, y);
    } else if (ca) {
      dots<0, 1>(Lj, Lj1, r0, r1, c0, c1, ld, j, s, u, x, y);
    }
    // warp 0 holds rows j and j + 1 (lanes 0 and 1): the pivot d0 of column
    // j, c_{j+1} = L[j + 1, j] and the pivot d1 of column j + 1 by shuffles,
    // then to the other warps of a team through shared memory
    float d0 = 0.f, cj1 = 0.f, d1 = 0.f;
    if (t < 32) {
      const unsigned all = 0xffffffffu;
      d0 = __shfl_sync(all, s[0], 0);
      const float c = s[0] * pivot_scale(d0);
      cj1 = __shfl_sync(all, c, 1);
      d1 = __shfl_sync(all, fmaf(-c, cj1, u[0]), 1);
    }
    if constexpr (TEAM == 32) {
      __syncwarp();  // every lane has read rows j and j + 1
    } else {
      if (t == 0) dsh[0] = d0, dsh[1] = cj1, dsh[2] = d1;
      team_sync<TEAM>(bar);
      d0 = dsh[0], cj1 = dsh[1], d1 = dsh[2];
    }
    const float p0 = pivot_scale(d0), rl0 = __frcp_rn(d0 * p0);
    const float p1 = pivot_scale(d1), rl1 = __frcp_rn(d1 * p1);
    // columns j and j + 1 of L below row j + 1; rows j and j + 1 are done
    for (int h = 0; h < (hasB ? 2 : 1); ++h) {
      if (i[h] > j + 1 && i[h] < R) {
        const float c = s[h] * p0;
        L[i[h] * ld + j] = c;
        L[i[h] * ld + j + 1] = fmaf(-c, cj1, u[h]) * p1;
      }
    }
    // rows j and j + 1 of L^-1 over rows j and j + 1 of L
    for (int h = 0; h < (hasB ? 2 : 1); ++h) {
      if (q[h] >= R) continue;
      const float xj = q[h] < j ? -x[h] * rl0 : (q[h] == j ? rl0 : 0.f);
      L[j * ld + q[h]] = xj;
      if (two)
        L[(j + 1) * ld + q[h]] = q[h] <= j ? -fmaf(cj1, xj, y[h]) * rl1
                                           : (q[h] == j + 1 ? rl1 : 0.f);
    }
    team_sync<TEAM>(bar);
  }
}

// out = X' X for lower-triangular X (the tile), lower 4 x 4 tiles only
template <int TEAM>
__device__ __forceinline__ void product_store(const float* X, float* __restrict__ ob, int R,
                                              int ld, int t, bool vec_out) {
  const int nt = (R + 3) / 4, ntiles = nt * (nt + 1) / 2;
  for (int tile = t; tile < ntiles; tile += TEAM) {
    int ti = (int)((sqrtf(8.f * tile + 1.f) - 1.f) * 0.5f);
    while ((ti + 1) * (ti + 2) / 2 <= tile) ++ti;
    while (ti * (ti + 1) / 2 > tile) --ti;
    const int tq = tile - ti * (ti + 1) / 2;
    const int r0 = 4 * ti, q0 = 4 * tq;
    float acc[4][4] = {};
    // columns past R read the row's pad: those sums are never stored
    const float* pa = X + (R - 1) * ld + r0;
    const float* pb = X + (R - 1) * ld + q0;
    for (int k = R - 1; k >= r0; --k, pa -= ld, pb -= ld) {
      const float4 a4 = ld4(pa), b4 = ld4(pb);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    if (vec_out) {  // R % 4 == 0: whole tiles, 16-byte aligned rows
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(ob + (r0 + u) * R + q0) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      if (ti != tq) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          *reinterpret_cast<float4*>(ob + (q0 + v) * R + r0) =
              make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = r0 + u, q = q0 + v;
          if (r < R && q < R) {
            ob[r * R + q] = acc[u][v];
            if (ti != tq) ob[q * R + r] = acc[u][v];
          }
        }
    }
  }
}

template <int TEAM>
__global__ void __launch_bounds__(NT)
spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out, int B, int R,
                   int vec_in, int vec_out) {
  extern __shared__ __align__(16) float sm[];
  const int tpb = blockDim.x / TEAM;
  const int team = threadIdx.x / TEAM, t = threadIdx.x % TEAM;
  const long long b = (long long)blockIdx.x * tpb + team;
  if (b >= B) return;  // the whole team: it syncs with no one else
  const int ld = padded_ld(R), RP = 4 * tiles_per_side(R);
  float* L = sm + (size_t)team * (RP * ld + 4);
  float* dsh = L + RP * ld;
  const int bar = 1 + team;
  const size_t RR = (size_t)R * R;
  const float* Ab = A + b * RR;

  const float4* A4 = reinterpret_cast<const float4*>(Ab);
  if (vec_in == 2) {  // R % 4 == 0, 16-byte aligned: rows of R / 4 float4 words
    const int nq = R / 4;
    for (int f = t; f < R * nq; f += TEAM) {
      const int r = f / nq;
      *reinterpret_cast<float4*>(L + r * ld + 4 * (f - r * nq)) = A4[f];
    }
  } else if (vec_in) {  // even R, 16-byte aligned: R^2 / 4 float4 words
    for (int f = t; f < R * R / 4; f += TEAM) {
      const float4 v = A4[f];
      int r = 4 * f / R, c = 4 * f - r * R;
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        L[r * ld + c] = w[u];
        if (++c == R) c = 0, ++r;
      }
    }
  } else {
    for (int r = 0; r < R; ++r)
      for (int c = t; c < R; c += TEAM) L[r * ld + c] = Ab[(size_t)r * R + c];
  }
  // zero pads: columns R..ld-1 and rows R..RP-1
  for (int r = t; r < RP; r += TEAM)
    for (int c = r < R ? R : 0; c < ld; ++c) L[r * ld + c] = 0.f;
  team_sync<TEAM>(bar);

  factor_invert<TEAM>(L, dsh, R, ld, t, bar);
  product_store<TEAM>(L, out + b * RR, R, ld, t, vec_out != 0);
}

// Teams per block with the most teams resident on an SM, from NT / TEAM
// down to 1 (ties go to the larger block); cached per R.
template <int TEAM>
int teams_per_block(int R, size_t per_team, cudaError_t* err) {
  static int cache[RMAX + 1];
  if (cache[R]) return cache[R];
  int best = 1, best_resident = -1;
  for (int tpb = NT / TEAM; tpb >= 1; tpb /= 2) {
    int blocks = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, spd_inverse_kernel<TEAM>, tpb * TEAM, tpb * per_team);
    if (*err != cudaSuccess) return 0;
    if (blocks * tpb > best_resident) best = tpb, best_resident = blocks * tpb;
  }
  cache[R] = best;
  return best;
}

template <int TEAM>
cudaError_t launch(const float* A, float* out, int B, int R, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(spd_inverse_kernel<TEAM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  const size_t per_team = sizeof(float) * ((size_t)4 * tiles_per_side(R) * padded_ld(R) + 4);
  const int tpb = teams_per_block<TEAM>(R, per_team, &err);
  if (err != cudaSuccess) return err;
  const bool a16 = reinterpret_cast<uintptr_t>(A) % 16 == 0;
  const int vec_in = a16 ? (R % 4 == 0 ? 2 : R % 2 == 0) : 0;
  const int vec_out = R % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned blocks = (unsigned)((B + tpb - 1) / tpb);
  spd_inverse_kernel<TEAM><<<blocks, tpb * TEAM, tpb * per_team, stream>>>(A, out, B, R,
                                                                          vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A, out (B, R, R) float32, contiguous; R <= 128.
int spd_inverse(const float* A, float* out, int B, int R, void* stream) {
  if (R < 1 || R > RMAX || B < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(R <= 64 ? launch<32>(A, out, B, R, s) : launch<128>(A, out, B, R, s));
}

}  // extern "C"
