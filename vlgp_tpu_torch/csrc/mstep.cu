// One Newton iteration of the M-step's Poisson update, for Hopper, in two
// launches: the counterpart of the Poisson branch of `iteration` in
// vlgp_tpu/models/vlgp.py:mstep (:374-497), which has no Pallas kernel (XLA
// fuses its einsums and reductions inside one lax.while_loop).  The port's
// plain version (vlgp_tpu_torch/ops/mstep.py) runs it as ~80-100 torch
// launches, 15-20 of them full passes over (S, T, Y) tensors.
//
// mstep_stats_kernel: one pass over the data.  For each row n = (s, t) and
// channel c it forms
//
//   eta = sum_z mu[n, z] a[z, c] + sum_q x[n, q, c] b[q, c],
//   r   = exp(min(eta + sum_z v[n, z] (0.5 a[z, c]) a[z, c], 10)),
//
// and adds, per channel, the noise sums s1 = sum m (y - eta), s2 = sum m
// (y - eta)^2, C1[z] = sum mu m (y - r), C2[z] = sum v m r, grad_b[q] = sum
// x (y m - r m) and, with the Hessian, E1[z, k] = sum r m mu_z mu_k, E2[z,
// k] = sum r m v_z mu_k, E3[z, k] = sum r m v_z v_k and nhess_b[q, p] =
// sum x_q r m x_p, with today's masking (a NaN in y stays in its channel;
// a NaN at a masked bin still poisons the sums that multiply y by the
// mask, as the einsums do).  E1, E3 and nhess_b are symmetric and summed
// on their upper triangles.  The entries of a channel are packed:
//
//   s1, s2 | C1 (Z) | C2 (Z) | grad_b (X) | E1 (Z(Z+1)/2) | E2 (Z^2) |
//   E3 (Z(Z+1)/2) | nhess_b (X(X+1)/2)          (the last four with hessian)
//
// For Z <= 8 (5 in float64) and X <= 2 (mstep_stats_reg_kernel) a block
// owns a chunk of rows and up to 256 channels: `lanes` channel lanes times
// `groups` row groups, each thread one channel's entries in registers (the
// loops over the latents and regressors unrolled), one FMA per entry and
// row; the rows come through shared memory in tiles, the next tile copied
// (cp.async) while this one is summed, and at the chunk's end the groups
// are added in group order in shared memory.  Otherwise
// (mstep_stats_kernel) a block of NT lanes keeps its accumulators in
// shared memory, acc[e][lane], each updated once per batch of RB rows with
// RB FMAs in two chains (even and odd rows), the per-row factors (mu, v,
// mu m, v m) read as broadcasts; where a channel's entries do not fit in
// shared memory (large Z in float64) they are split in slabs over
// gridDim.z.  Either writes its partial sums to part (Y, C, NE), a
// channel's partials contiguous: no atomics, so every run gives the same
// bits.
//
// The partials are reduced over the C chunks in a fixed order by one
// device routine (reduce_channel: chunk c goes to group c mod G, each group
// summed in chunk order, the groups added in order), run either as
// mstep_update's prologue (one device, no all-reduce) or by
// mstep_reduce_kernel, which writes the tensors in today's layouts for the
// all-reduce of a data-sharded fit.  Both give the same bits, so a world of
// one repeats the unsharded fit bit for bit.
//
// The update: a block per channel reduces (or gathers) its entries, forms
// noise = s2/n - (s1/n)^2, grad_a = C1 - a C2, the Hessian E1 + a_z E2 +
// a_k E2' + a_z a_k E3 + diag(C2) + eps I (nhess_b + eps I for b), solves
// both by Gaussian elimination with partial pivoting (a zero or NaN pivot
// gives NaN, as torch.linalg.solve_ex and jnp.linalg.solve do) or takes
// learning_rate * grad in gradient mode, clamps to da_bound / db_bound, and
// writes a + da, b + db, noise, da and db.  An inert channel (active[c] ==
// 0) keeps its a, b and noise with da = db = 0 exactly.  It also writes the
// exit test's four squared norms (sum da^2, sum a_new^2, sum db^2, sum
// b_new^2 over the channels; vlgp_tpu/models/vlgp.py:483-490 sums them in
// its while_loop): each block its channel's, and the last block to finish
// the sums over the channels in a fixed order (finish_norms), so the
// M-step's exit test needs no reduction launch of its own.  The last block
// is found by a ticket counter that must be 0 at launch and that the last
// block sets back to 0, so launches that share a counter must run one
// after another: the wrapper keeps one per (device, stream)
// (ops/mstep.py:_ticket).  For Z <= 8 and
// X <= 2 (mstep_update_reg_kernel) the channel's partial sums, contiguous
// in part, come to shared memory by bulk copies (the tensor memory
// accelerator) and are summed from there, and each system is solved in one
// thread's registers (no barrier); above (mstep_update_kernel) the
// prologue loads from device memory eight loads at a time and the block
// solves in shared memory, four barriers a column.  Both add in
// reduce_channel's order and solve with the same operations, so they give
// the same bits.
//
// What bounds it on this card.  At the flagship (Z5 X1 S2000 T50 Y100) the
// pass reads y and x (40 MB each), mu, v and the mask (4.4 MB): ~25 us at
// 3.35 TB/s; its ~70 FMAs per (row, channel) take ~21 us at the FP32 rate.
// Accumulators in shared memory cost a load and a store per entry and
// batch of RB rows, and the factors one broadcast load per 4 (float32) or 2
// (float64) rows: the latency of that shared-memory traffic, not DRAM,
// limited that design (0.26 ms on an H100, ~10x the byte bound, with the
// loops over the latents unrolled for Z <= 8; 0.52 ms with one FMA chain
// per entry and 256 chunks).  With the accumulators in registers and one
// row's loads in flight per thread, the loads' latency bound the pass
// (0.14 ms); the tiles in shared memory keep ~27 KB of rows in flight per
// block without registers (0.093 ms with 16-byte copies, ~3.7x the byte
// bound; a third stage, 512 threads a block or more chunks did not help,
// tools/torch_variant_ab.py).  Its row loop is 133 instructions, 85 of
// them FFMA: ~40 us at the flagship at 4 instructions a clock.  The update
// is ~Z^3 + X^3 operations per channel; its time is the partial sums' trip
// from L2 (7.3 MB at the flagship: 264 chunks x 100 channels x 69
// entries) and the latency of each step's chain.  With eight loads in
// flight per thread, the block solving with four barriers a column and the
// back-substitution on one thread it took ~12.3 us of device time on an
// H100 (33 us with 128 threads); mstep_update_reg_kernel takes ~7.3 us
// (tools/torch_variant_ab.py, in turns), against a bound of ~2.2 us for
// reading the partials once.  A clock-stamped draft build (not in the
// repo) put the largest share in the wait for the copy, then the sums, the
// solve and writes, and the norms' ticket, in that order.  Tried in draft
// builds and not kept, both slower: each system solved by a warp, a row a
// lane, with shuffles; four pieces of the copy, each on its own mbarrier,
// the sums of each starting as it lands.

#include <cmath>

#include "ns_common.cuh"

namespace {

constexpr int NT = 128;              // threads per block of the pass over the data
constexpr int NTU = 512;             // threads per block of the reduction and the update
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a Hopper block may use
constexpr int GMAX = 16;             // chunk groups of the fixed-order reduction
constexpr int SG = 2048;             // values of the groups' partial sums in shared memory
constexpr int ZMAX = 128;
constexpr int XMAX = 128;

template <typename T>
struct RowBatch;
template <>
struct RowBatch<float> {
  static constexpr int RB = 8;
};
template <>
struct RowBatch<double> {
  static constexpr int RB = 4;
};

__host__ __device__ inline int tri(int n) { return n * (n + 1) / 2; }

struct Layout {
  int Z, X, hess;
  int c1, c2, gb, e1, e2, e3, nh, ne;
  __host__ __device__ Layout(int Z_, int X_, int hess_) : Z(Z_), X(X_), hess(hess_) {
    c1 = 2;
    c2 = c1 + Z;
    gb = c2 + Z;
    e1 = gb + X;
    e2 = e1 + (hess ? tri(Z) : 0);
    e3 = e2 + (hess ? Z * Z : 0);
    nh = e3 + (hess ? tri(Z) : 0);
    ne = nh + (hess ? tri(X) : 0);
  }
};

// (i, j), i <= j, of index p of the packed upper triangle of an n x n
// matrix stored by rows
__device__ inline void untri(int p, int n, int& i, int& j) {
  i = 0;
  while (p >= n - i) {
    p -= n - i;
    ++i;
  }
  j = i + p;
}

__host__ __device__ constexpr int tri_index(int i, int j, int n) {
  return i * n - i * (i - 1) / 2 + (j - i);
}

// offset in today's layouts (the flat buffer of s1 (Y), s2 (Y), C1 (Z, Y),
// C2 (Z, Y), grad_b (X, Y), E1, E2, E3 (Y, Z, Z), nhess_b (Y, X, X)) of
// entry e of channel c; *mirror gets the offset of the symmetric twin of a
// packed entry off the diagonal, else -1
__device__ inline long long flat_offset(const Layout& L, int e, int c, int Y, long long* mirror) {
  const long long Yl = Y, Z = L.Z, X = L.X;
  *mirror = -1;
  if (e < L.c1) return e * Yl + c;
  if (e < L.c2) return 2 * Yl + (e - L.c1) * Yl + c;
  if (e < L.gb) return 2 * Yl + Z * Yl + (e - L.c2) * Yl + c;
  if (e < L.e1) return 2 * Yl + 2 * Z * Yl + (e - L.gb) * Yl + c;
  const long long base1 = 2 * Yl + 2 * Z * Yl + X * Yl;
  int i, j;
  if (e < L.e2) {
    untri(e - L.e1, L.Z, i, j);
    if (i != j) *mirror = base1 + (c * Z + j) * Z + i;
    return base1 + (c * Z + i) * Z + j;
  }
  const long long base2 = base1 + Yl * Z * Z;
  if (e < L.e3) return base2 + c * Z * Z + (e - L.e2);
  const long long base3 = base2 + Yl * Z * Z;
  if (e < L.nh) {
    untri(e - L.e3, L.Z, i, j);
    if (i != j) *mirror = base3 + (c * Z + j) * Z + i;
    return base3 + (c * Z + i) * Z + j;
  }
  const long long base4 = base3 + Yl * Z * Z;
  untri(e - L.nh, L.X, i, j);
  if (i != j) *mirror = base4 + (c * X + j) * X + i;
  return base4 + (c * X + i) * X + j;
}

// ---------------------------------------------------------------------------
// The pass over the data
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T trunc_exp(T x) {
  return exp(x > (T)10 ? (T)10 : x);  // NaN passes the test and stays NaN
}

template <typename T>
__global__ void __launch_bounds__(NT) mstep_stats_kernel(
    const T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ mask,
    const T* __restrict__ mu, const T* __restrict__ v, const T* __restrict__ a,
    const T* __restrict__ b, T* __restrict__ part, int N, int Y, int Z, int X, int hess,
    int rows_per_chunk, int ecap) {
  constexpr int RB = RowBatch<T>::RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(Z, X, hess);
  const int Zk = Z;
  const int tid = threadIdx.x;
  const int YS = NT + 1;  // row stride of acc: the final copy reads it down columns
  T* acc = reinterpret_cast<T*>(smem_raw);          // ecap x YS
  T* rowf = acc + (size_t)ecap * YS;                // 4Zk x RB: mu, v, mu m, v m
  T* rowm = rowf + (size_t)4 * Zk * RB;              // RB: the mask
  const int ch = blockIdx.x;
  const int c = blockIdx.y * NT + tid;
  const bool live = c < Y;
  const int e0 = blockIdx.z * ecap;
  const int e1 = min(L.ne, e0 + ecap);
  for (int i = tid; i < (e1 - e0) * YS; i += NT) acc[i] = (T)0;
  const int n_begin = ch * rows_per_chunk;
  const int n_end = min(N, n_begin + rows_per_chunk);

  for (int n0 = n_begin; n0 < n_end; n0 += RB) {
    __syncthreads();  // the last batch's factors are read; acc is zeroed
    for (int i = tid; i < 4 * Zk * RB; i += NT) {
      const int f = i / RB, rb = i - f * RB, n = n0 + rb;
      const int z = f % Zk, kind = f / Zk;
      T val = (T)0;
      if (n < n_end) {
        const T src = kind == 0 || kind == 2 ? mu[(size_t)n * Zk + z] : v[(size_t)n * Zk + z];
        val = kind < 2 ? src : src * mask[n];
      }
      rowf[i] = val;
    }
    if (tid < RB) rowm[tid] = n0 + tid < n_end ? mask[n0 + tid] : (T)0;
    __syncthreads();
    if (!live) continue;

    // per-row scalars of this channel
    T sres[RB], sres2[RB], ymr[RB], rr[RB], g[RB], rm[RB];
    T eta[RB], ve[RB], yv[RB];
#pragma unroll
    for (int rb = 0; rb < RB; ++rb) {
      const int n = n0 + rb;
      yv[rb] = n < n_end ? y[(size_t)n * Y + c] : (T)0;
      eta[rb] = (T)0;
      ve[rb] = (T)0;
    }
    for (int z = 0; z < Zk; ++z) {
      const T az = a[(size_t)z * Y + c];
      const T haz = ((T)0.5 * az) * az;
      const T* fm = rowf + (size_t)z * RB;
      const T* fv = rowf + (size_t)(Zk + z) * RB;
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        eta[rb] = fma(fm[rb], az, eta[rb]);
        ve[rb] = fma(fv[rb], haz, ve[rb]);
      }
    }
    {
      T xb[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) xb[rb] = (T)0;
      for (int q = 0; q < X; ++q) {
        const T bq = b[(size_t)q * Y + c];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const int n = n0 + rb;
          const T xq = n < n_end ? x[((size_t)n * X + q) * Y + c] : (T)0;
          xb[rb] = fma(xq, bq, xb[rb]);
        }
      }
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const bool in = n0 + rb < n_end;
        const T m = rowm[rb];
        const T e = eta[rb] + xb[rb];
        const T res = yv[rb] - e;
        const T r = trunc_exp(e + ve[rb]);
        sres[rb] = in ? res * m : (T)0;
        sres2[rb] = in ? (res * res) * m : (T)0;
        ymr[rb] = in ? yv[rb] - r : (T)0;
        rr[rb] = in ? r : (T)0;
        g[rb] = in ? yv[rb] * m - r * m : (T)0;
        rm[rb] = in ? r * m : (T)0;
      }
    }

    T* my = acc + tid;
    // acc[e] += sum over the batch of s[rb] f[rb], in row order
    // acc[e] += the batch's sum of s[rb] f[rb]: even and odd rows in two
    // chains (twice the FMAs in flight), added to acc in that order
    auto upd = [&](int e, const T* s, const T* f) {
      if (e < e0 || e >= e1) return;
      T t0 = s[0] * f[0], t1 = s[1] * f[1];
#pragma unroll
      for (int rb = 2; rb < RB; rb += 2) {
        t0 = fma(s[rb], f[rb], t0);
        t1 = fma(s[rb + 1], f[rb + 1], t1);
      }
      my[(size_t)(e - e0) * YS] += t0 + t1;
    };
    auto add = [&](int e, const T* s) {
      if (e < e0 || e >= e1) return;
      T t0 = s[0], t1 = s[1];
#pragma unroll
      for (int rb = 2; rb < RB; rb += 2) {
        t0 += s[rb];
        t1 += s[rb + 1];
      }
      my[(size_t)(e - e0) * YS] += t0 + t1;
    };
    add(0, sres);
    add(1, sres2);
    for (int z = 0; z < Zk; ++z) {
      T f[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) f[rb] = rowf[(size_t)(2 * Zk + z) * RB + rb];
      upd(L.c1 + z, ymr, f);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) f[rb] = rowf[(size_t)(3 * Zk + z) * RB + rb];
      upd(L.c2 + z, rr, f);
    }
    for (int q = 0; q < X; ++q) {
      T f[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int n = n0 + rb;
        f[rb] = n < n_end ? x[((size_t)n * X + q) * Y + c] : (T)0;
      }
      upd(L.gb + q, g, f);
    }
    if (!hess) continue;
    int e_1 = L.e1, e_2 = L.e2, e_3 = L.e3;
    for (int z = 0; z < Zk; ++z) {
      T pm[RB], pv[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        pm[rb] = rm[rb] * rowf[(size_t)z * RB + rb];
        pv[rb] = rm[rb] * rowf[(size_t)(Zk + z) * RB + rb];
      }
      for (int k = 0; k < Zk; ++k) {
        T fmu[RB], fv[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          fmu[rb] = rowf[(size_t)k * RB + rb];
          fv[rb] = rowf[(size_t)(Zk + k) * RB + rb];
        }
        if (k >= z) upd(e_1++, pm, fmu);
        upd(e_2++, pv, fmu);
        if (k >= z) upd(e_3++, pv, fv);
      }
    }
    int e_4 = L.nh;
    for (int q = 0; q < X; ++q) {
      T pq[RB];
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int n = n0 + rb;
        pq[rb] = rm[rb] * (n < n_end ? x[((size_t)n * X + q) * Y + c] : (T)0);
      }
      for (int p = q; p < X; ++p) {
        T f[RB];
#pragma unroll
        for (int rb = 0; rb < RB; ++rb) {
          const int n = n0 + rb;
          f[rb] = n < n_end ? x[((size_t)n * X + p) * Y + c] : (T)0;
        }
        upd(e_4++, pq, f);
      }
    }
  }
  __syncthreads();
  // partials of this block: part[c][ch][e], a channel's chunks contiguous
  const int nc = min(NT, Y - (int)blockIdx.y * NT);
  const int ecnt = e1 - e0;
  for (int i = tid; i < nc * ecnt; i += NT) {
    const int yl = i / ecnt, el = i - yl * ecnt;
    part[(((size_t)blockIdx.y * NT + yl) * gridDim.x + ch) * L.ne + e0 + el] =
        acc[(size_t)el * YS + yl];
  }
}

// ---------------------------------------------------------------------------
// The pass over the data with the accumulators in registers (Z <= 8, X <= 2)
// ---------------------------------------------------------------------------

constexpr int NTG = 256;     // threads per block of the register path, at most
constexpr int ZR_MAX = 8;    // largest Z of the register path
constexpr int ZR_MAX_DOUBLE = 5;  // in float64 (above it the accumulators spill)
constexpr int XR_MAX = 2;    // largest X of the register path
constexpr int ES = 16;       // entries per slab of the combine at the chunk's end

__host__ __device__ constexpr int entries(int Z, int X, int hess) {
  return 2 + 2 * Z + X + (hess ? Z * (Z + 1) + Z * Z + X * (X + 1) / 2 : 0);
}

// values of one stage of the register path's tiles: the rows' factors
// (mu, v, the mask, padded to 4 values), y and x, rounded up to 4 values
// so that both stages start on 16 bytes
__host__ __device__ constexpr int factor_stride(int Z) { return (2 * Z + 1 + 3) / 4 * 4; }
__host__ __device__ inline int stage_size(int rt, int lanes, int Z, int X) {
  return (rt * (factor_stride(Z) + lanes * (1 + X)) + 3) / 4 * 4;
}

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// One row of one channel: its mask, count and factors.
template <typename T, int ZC, int XC>
struct Row {
  T m, y, fm[ZC], fv[ZC], xv[XC];
};

// cp.async of one value (4 or 8 bytes), or of 16 bytes, from device to
// shared memory: the copy bypasses the registers, so a block keeps a whole
// tile of rows in flight
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// the row's terms added to the NE entries of acc (the packed layout of
// Layout, the Hessian's entries only with hess)
template <typename T, int ZC, int XC, int NE>
__device__ __forceinline__ void add_row(const Row<T, ZC, XC>& w, const T (&az)[ZC],
                                        const T (&haz)[ZC], const T (&bq)[XC], int hess,
                                        T (&acc)[NE]) {
  constexpr int C1 = 2, C2 = C1 + ZC, GB = C2 + ZC, E1 = GB + XC;
  constexpr int E2 = E1 + ZC * (ZC + 1) / 2, E3 = E2 + ZC * ZC, NH = E3 + ZC * (ZC + 1) / 2;
  const T m = w.m, yv = w.y;
  T eta = (T)0, ve = (T)0, xb = (T)0;
#pragma unroll
  for (int z = 0; z < ZC; ++z) {
    eta = fma(w.fm[z], az[z], eta);
    ve = fma(w.fv[z], haz[z], ve);
  }
#pragma unroll
  for (int q = 0; q < XC; ++q) xb = fma(w.xv[q], bq[q], xb);
  const T e = eta + xb;
  const T res = yv - e;
  const T r = trunc_exp(e + ve);
  acc[0] += res * m;
  acc[1] += (res * res) * m;
  const T ymr = yv - r, gr = yv * m - r * m, rm = r * m;
#pragma unroll
  for (int z = 0; z < ZC; ++z) {
    acc[C1 + z] = fma(ymr, w.fm[z] * m, acc[C1 + z]);
    acc[C2 + z] = fma(r, w.fv[z] * m, acc[C2 + z]);
  }
#pragma unroll
  for (int q = 0; q < XC; ++q) acc[GB + q] = fma(gr, w.xv[q], acc[GB + q]);
  if (!hess) return;
#pragma unroll
  for (int z = 0; z < ZC; ++z) {
    const T pm = rm * w.fm[z], pv = rm * w.fv[z];
#pragma unroll
    for (int k = 0; k < ZC; ++k) {
      if (k >= z) {
        acc[E1 + tri_index(z, k, ZC)] = fma(pm, w.fm[k], acc[E1 + tri_index(z, k, ZC)]);
        acc[E3 + tri_index(z, k, ZC)] = fma(pv, w.fv[k], acc[E3 + tri_index(z, k, ZC)]);
      }
      acc[E2 + z * ZC + k] = fma(pv, w.fm[k], acc[E2 + z * ZC + k]);
    }
  }
#pragma unroll
  for (int q = 0; q < XC; ++q) {
    const T pq = rm * w.xv[q];
#pragma unroll
    for (int p = q; p < XC; ++p)
      acc[NH + tri_index(q, p, XC)] = fma(pq, w.xv[p], acc[NH + tri_index(q, p, XC)]);
  }
}

// A block of `lanes` channel lanes times `groups` row groups (lanes x
// groups <= NTG threads) walks its chunk in tiles of rt rows.  Tile k + 1
// is copied to shared memory (cp.async: y and x of the block's channels,
// 16 bytes a copy where aligned, mu, v and the mask) while tile k is
// summed: group g takes the tile's rows
// g, g + groups, ..., each thread its channel's ZC and XC loops unrolled,
// so the NE entries sit in registers and each row costs one FMA per entry.
// At the chunk's end the groups are added in group order in shared memory,
// ES entries at a time, and the block writes its partial sums.
template <typename T, int ZC, int XC>
__global__ void __launch_bounds__(NTG) mstep_stats_reg_kernel(
    const T* __restrict__ y, const T* __restrict__ x, const T* __restrict__ mask,
    const T* __restrict__ mu, const T* __restrict__ v, const T* __restrict__ a,
    const T* __restrict__ b, T* __restrict__ part, int N, int Y, int hess, int lanes,
    int rows_per_chunk, int rt) {
  constexpr int NE = entries(ZC, XC, 1);
  constexpr int NF = 2 * ZC + 1;  // per-row factors: mu, v, the mask
  constexpr int NFP = factor_stride(ZC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sacc[ES * NTG];
  const int groups = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int c0 = blockIdx.y * lanes, c = c0 + lane;
  const int nc = min(lanes, Y - c0);
  const bool live = lane < nc;
  const int ne = entries(ZC, XC, hess);
  const int n_begin = blockIdx.x * rows_per_chunk;
  const int n_end = min(N, n_begin + rows_per_chunk);
  // two stages of a tile: factors [rt][NFP], y [rt][lanes], x [rt][XC][lanes]
  const int stage = stage_size(rt, lanes, ZC, XC);
  // y's and x's rows copied 16 bytes at a time where every row of the
  // block's channels starts on 16 bytes
  constexpr int VW = 16 / sizeof(T);
  const bool vec = Y % VW == 0 && lanes % VW == 0 && reinterpret_cast<size_t>(y) % 16 == 0 &&
                   reinterpret_cast<size_t>(x) % 16 == 0;
  T* buf = reinterpret_cast<T*>(smem_raw);

  // every thread's share of tile n0's copies, committed as one group: y
  // and x of its channel at the rows (and regressors) of its group, then
  // the rows' factors
  auto copy_tile = [&](int n0, T* st) {
    const int rows = min(rt, n_end - n0);
    T* fs = st;
    T* ys = fs + rt * NFP;
    T* xs = ys + rt * lanes;
    if (vec) {  // 16 bytes a copy: lane l < nc / VW takes values VW l ..
      if (lane < nc / VW) {
        for (int r = g; r < rows; r += groups)
          copy_async16(ys + r * lanes + VW * lane, y + (size_t)(n0 + r) * Y + c0 + VW * lane);
        for (int rq = g; rq < rows * XC; rq += groups)
          copy_async16(xs + rq * lanes + VW * lane,
                       x + ((size_t)n0 * XC + rq) * Y + c0 + VW * lane);
      }
    } else if (live) {
      for (int r = g; r < rows; r += groups)
        copy_async(ys + r * lanes + lane, y + (size_t)(n0 + r) * Y + c);
      for (int rq = g; rq < rows * XC; rq += groups)
        copy_async(xs + rq * lanes + lane, x + ((size_t)n0 * XC + rq) * Y + c);
    }
    for (int i = threadIdx.x; i < rows * NF; i += blockDim.x) {
      const int r = i / NF, f = i - r * NF;
      const T* src = f < ZC ? mu + (size_t)(n0 + r) * ZC + f
                            : f < 2 * ZC ? v + (size_t)(n0 + r) * ZC + f - ZC : mask + n0 + r;
      copy_async(fs + r * NFP + f, src);
    }
    asm volatile("cp.async.commit_group;" ::);
  };

  T acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = (T)0;
  T az[ZC], haz[ZC], bq[XC];
#pragma unroll
  for (int z = 0; z < ZC; ++z) {
    az[z] = live ? a[(size_t)z * Y + c] : (T)0;
    haz[z] = ((T)0.5 * az[z]) * az[z];
  }
#pragma unroll
  for (int q = 0; q < XC; ++q) bq[q] = live ? b[(size_t)q * Y + c] : (T)0;
  if (n_begin < n_end) copy_tile(n_begin, buf);
  for (int n0 = n_begin, k = 0; n0 < n_end; n0 += rt, ++k) {
    T* st = buf + (size_t)(k & 1) * stage;
    if (n0 + rt < n_end) {
      copy_tile(n0 + rt, buf + (size_t)((k + 1) & 1) * stage);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // tile k is in shared memory
    if (live) {
      const T* fs = st;
      const T* ys = fs + rt * NFP;
      const T* xs = ys + rt * lanes;
      const int rows = min(rt, n_end - n0);
      for (int r = g; r < rows; r += groups) {
        T f[NFP];
#pragma unroll
        for (int j = 0; j < NFP; j += 4) load4(fs + r * NFP + j, f + j);
        Row<T, ZC, XC> w;
        w.m = f[2 * ZC];
#pragma unroll
        for (int z = 0; z < ZC; ++z) {
          w.fm[z] = f[z];
          w.fv[z] = f[ZC + z];
        }
        w.y = ys[r * lanes + lane];
#pragma unroll
        for (int q = 0; q < XC; ++q) w.xv[q] = xs[(r * XC + q) * lanes + lane];
        add_row(w, az, haz, bq, hess, acc);
      }
    }
    __syncthreads();  // tile k is read: its stage takes tile k + 2
  }
  // the groups' sums added in group order, ES entries at a time, and
  // written as this chunk's partial sums part[c][chunk][e]
#pragma unroll
  for (int e0 = 0; e0 < NE; e0 += ES) {
    for (int gg = 0; gg < groups; ++gg) {
      if (g == gg) {
#pragma unroll
        for (int el = 0; el < ES; ++el)
          if (e0 + el < NE)
            sacc[el * lanes + lane] = gg == 0 ? acc[e0 + el] : sacc[el * lanes + lane] + acc[e0 + el];
      }
      __syncthreads();
    }
    const int ecnt = min(ES, ne - e0);
    for (int i = threadIdx.x; i < nc * ecnt; i += blockDim.x) {
      const int yl = i / ecnt, el = i - yl * ecnt;
      part[(((size_t)blockIdx.y * lanes + yl) * gridDim.x + blockIdx.x) * ne + e0 + el] =
          sacc[el * lanes + yl];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The fixed-order reduction over chunks
// ---------------------------------------------------------------------------

__host__ __device__ inline int groups(int ne, int C) {
  int G = SG / (ne > 0 ? ne : 1);
  G = G < 1 ? 1 : (G > GMAX ? GMAX : G);
  return G < C ? G : C;
}

// The reduced entries of channel c, into red[0 .. ne): chunk k goes to
// group k mod G, each group summed in chunk order from its first chunk,
// the groups added in order.  sg holds G * ne <= SG values when G > 1.
// Called by all NTU threads of the block; ends with a barrier.
template <typename T>
__device__ void reduce_channel(const T* __restrict__ part, int C, int Y, int ne, int c, T* sg,
                               T* red) {
  const int G = groups(ne, C);
  for (int i = threadIdx.x; i < G * ne; i += NTU) {
    const int gi = i / ne, e = i - gi * ne;
    const T* p = part + (size_t)c * C * ne + e;
    const size_t stride = ne;
    T s = p[(size_t)gi * stride];
    int k = gi + G;
    // eight loads in flight, added in chunk order
    for (; k + 7 * G < C; k += 8 * G) {
      T v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = p[(size_t)(k + u * G) * stride];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; k < C; k += G) s += p[(size_t)k * stride];
    if (G == 1)
      red[e] = s;
    else
      sg[i] = s;
  }
  __syncthreads();
  if (G > 1) {
    for (int e = threadIdx.x; e < ne; e += NTU) {
      T s = sg[e];
      for (int gi = 1; gi < G; ++gi) s += sg[(size_t)gi * ne + e];
      red[e] = s;
    }
    __syncthreads();
  }
}

// the reduced entries written in today's layouts (the flat buffer of
// flat_offset), symmetric entries on both sides of the diagonal
template <typename T>
__global__ void __launch_bounds__(NTU) mstep_reduce_kernel(const T* __restrict__ part, int C,
                                                           T* __restrict__ flat, T* __restrict__ red,
                                                           int Y, int Z, int X, int hess) {
  __shared__ T sg[SG];
  const Layout L(Z, X, hess);
  const int c = blockIdx.x;
  T* rc = red + (size_t)c * L.ne;
  reduce_channel(part, C, Y, L.ne, c, sg, rc);
  for (int e = threadIdx.x; e < L.ne; e += NTU) {
    long long mirror;
    const long long off = flat_offset(L, e, c, Y, &mirror);
    flat[off] = rc[e];
    if (mirror >= 0) flat[mirror] = rc[e];
  }
}

// ---------------------------------------------------------------------------
// The update
// ---------------------------------------------------------------------------

// clamp to [-bound, bound]; NaN stays NaN
template <typename T>
__device__ __forceinline__ T clampb(T d, T bound) {
  return d < -bound ? -bound : (d > bound ? bound : d);
}

// Solve the n x n system in M (n rows of stride n + 1, the right-hand side
// in column n) by Gaussian elimination with partial pivoting (the first
// row of largest magnitude), the solution into sol; a zero or NaN pivot
// gives NaN.  All threads of the block; ends with a barrier.
template <typename T>
__device__ void solve_block(T* M, int n, T* lcol, int* piv, T* sol) {
  const int ld = n + 1;
  for (int k = 0; k < n; ++k) {
    if (threadIdx.x == 0) {
      int p = k;
      T best = fabs(M[(size_t)k * ld + k]);
      for (int i = k + 1; i < n; ++i) {
        const T m = fabs(M[(size_t)i * ld + k]);
        if (m > best) {
          best = m;
          p = i;
        }
      }
      piv[0] = p;
      if (!(best > (T)0)) piv[1] = 1;  // zero or NaN pivot: singular
    }
    __syncthreads();
    const int p = piv[0];
    if (p != k)
      for (int j = k + threadIdx.x; j <= n; j += NTU) {
        const T t = M[(size_t)k * ld + j];
        M[(size_t)k * ld + j] = M[(size_t)p * ld + j];
        M[(size_t)p * ld + j] = t;
      }
    __syncthreads();
    const T d = M[(size_t)k * ld + k];
    for (int i = k + 1 + threadIdx.x; i < n; i += NTU) lcol[i] = M[(size_t)i * ld + k] / d;
    __syncthreads();
    const int w = n - k;  // columns k+1 .. n
    for (int idx = threadIdx.x; idx < (n - k - 1) * w; idx += NTU) {
      const int i = k + 1 + idx / w, j = k + 1 + idx % w;
      M[(size_t)i * ld + j] -= lcol[i] * M[(size_t)k * ld + j];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const bool singular = piv[1] != 0;
    for (int i = n - 1; i >= 0; --i) {
      T s = M[(size_t)i * ld + n];
      for (int j = i + 1; j < n; ++j) s -= M[(size_t)i * ld + j] * sol[j];
      sol[i] = singular ? (T)NAN : s / M[(size_t)i * ld + i];
    }
  }
  __syncthreads();
}

// The exit test's squared norms.  Thread 0 writes its channel's (sum
// da^2, sum a_new^2, sum db^2, sum b_new^2), vals[0 .. 3], to cn (Y, 4)
// and takes a ticket (an atomic add with release and acquire order at the
// device's scope); the block with the last ticket adds cn over the
// channels into norms (4) in a fixed order: thread i the channels i, i +
// NTH, ... in order, then lane l of warp 0 the threads l, l + 32, ... in
// order, then the lanes in a fixed tree.  The ticket decides which block
// adds, never what is added, and the last block resets the counter for the
// next launch (and graph replay): two launches on one counter must not
// overlap, or their tickets interleave.  All NTH threads of the block, vals read
// by thread 0 after the block's barrier.
template <typename T, int NTH>
__device__ void finish_norms(const T* vals, T* cn, T* __restrict__ norms, unsigned* counter,
                             int Y) {
  __shared__ bool last;
  __shared__ T part_s[NTH][4];
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) cn[4 * (size_t)blockIdx.x + j] = vals[j];
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(ticket) : "l"(counter) : "memory");
    last = ticket == (unsigned)Y - 1;
  }
  __syncthreads();
  if (!last) return;
  T s[4] = {(T)0, (T)0, (T)0, (T)0};
  for (int c = threadIdx.x; c < Y; c += NTH)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += __ldcg(cn + 4 * (size_t)c + j);
#pragma unroll
  for (int j = 0; j < 4; ++j) part_s[threadIdx.x][j] = s[j];
  __syncthreads();
  if (threadIdx.x >= 32) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = (T)0;
  for (int i = threadIdx.x; i < NTH && i < Y; i += 32)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += part_s[i][j];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += __shfl_down_sync(0xffffffffu, s[j], off);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) norms[j] = s[j];
    *counter = 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTU) mstep_update_kernel(
    const T* __restrict__ part, int C, const T* __restrict__ flat, T* __restrict__ red,
    const T* __restrict__ n_ptr, const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ noise_prev, const unsigned char* __restrict__ active,
    T* __restrict__ a_new, T* __restrict__ b_new, T* __restrict__ noise, T* __restrict__ da,
    T* __restrict__ db, T* __restrict__ cn, T* __restrict__ norms, unsigned* counter, int Y,
    int Z, int X, int hess, double eps_, double lr_, double da_bound_, double db_bound_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L(Z, X, hess);
  const int c = blockIdx.x;
  const int n = Z > X ? Z : X;
  T* M = reinterpret_cast<T*>(smem_raw);   // n x (n + 1)
  T* lcol = M + (size_t)n * (n + 1);        // n
  T* sol = lcol + n;                        // n
  T* sg = sol + n;                          // SG
  __shared__ int piv[2];
  const T eps = (T)eps_, lr = (T)lr_, dab = (T)da_bound_, dbb = (T)db_bound_;
  T* st = red + (size_t)c * L.ne;
  if (part != nullptr) {
    reduce_channel(part, C, Y, L.ne, c, sg, st);
  } else {
    for (int e = threadIdx.x; e < L.ne; e += NTU) {
      long long mirror;
      st[e] = flat[flat_offset(L, e, c, Y, &mirror)];
    }
    __syncthreads();
  }
  const bool act = active == nullptr || active[c] != 0;
  if (threadIdx.x == 0) {
    const T nn = n_ptr[0];
    const T mean = st[0] / nn;
    const T var = st[1] / nn - mean * mean;
    noise[c] = act ? var : noise_prev[c];
  }

  // ---- the loading: grad_a = C1 - a C2 ----
  if (hess) {
    if (threadIdx.x == 0) piv[1] = 0;
    for (int idx = threadIdx.x; idx < Z * Z; idx += NTU) {
      const int z = idx / Z, k = idx - z * Z;
      const T az = a[(size_t)z * Y + c], ak = a[(size_t)k * Y + c];
      const int zl = z < k ? z : k, kh = z < k ? k : z;
      T h = st[L.e1 + tri_index(zl, kh, Z)];
      h = h + az * st[L.e2 + z * Z + k];
      h = h + ak * st[L.e2 + k * Z + z];
      h = h + (az * ak) * st[L.e3 + tri_index(zl, kh, Z)];
      h = h + st[L.c2 + z] * (T)(z == k);
      h = h + eps * (T)(z == k);
      M[(size_t)z * (Z + 1) + k] = h;
    }
    for (int z = threadIdx.x; z < Z; z += NTU)
      M[(size_t)z * (Z + 1) + Z] = st[L.c1 + z] - a[(size_t)z * Y + c] * st[L.c2 + z];
    __syncthreads();
    solve_block(M, Z, lcol, piv, sol);
    for (int z = threadIdx.x; z < Z; z += NTU) {
      const T az = a[(size_t)z * Y + c];
      const T d = clampb(sol[z], dab);
      a_new[(size_t)z * Y + c] = act ? az + d : az;
      da[(size_t)z * Y + c] = act ? d : (T)0;
    }
    __syncthreads();
    // ---- the regression: nhess_b + eps I ----
    if (threadIdx.x == 0) piv[1] = 0;
    for (int idx = threadIdx.x; idx < X * X; idx += NTU) {
      const int q = idx / X, p = idx - q * X;
      const int ql = q < p ? q : p, ph = q < p ? p : q;
      M[(size_t)q * (X + 1) + p] = st[L.nh + tri_index(ql, ph, X)] + eps * (T)(q == p);
    }
    for (int q = threadIdx.x; q < X; q += NTU) M[(size_t)q * (X + 1) + X] = st[L.gb + q];
    __syncthreads();
    solve_block(M, X, lcol, piv, sol);
    for (int q = threadIdx.x; q < X; q += NTU) {
      const T bq = b[(size_t)q * Y + c];
      const T d = clampb(sol[q], dbb);
      b_new[(size_t)q * Y + c] = act ? bq + d : bq;
      db[(size_t)q * Y + c] = act ? d : (T)0;
    }
  } else {
    for (int z = threadIdx.x; z < Z; z += NTU) {
      const T az = a[(size_t)z * Y + c];
      const T d = clampb(lr * (st[L.c1 + z] - az * st[L.c2 + z]), dab);
      a_new[(size_t)z * Y + c] = act ? az + d : az;
      da[(size_t)z * Y + c] = act ? d : (T)0;
    }
    for (int q = threadIdx.x; q < X; q += NTU) {
      const T bq = b[(size_t)q * Y + c];
      const T d = clampb(lr * st[L.gb + q], dbb);
      b_new[(size_t)q * Y + c] = act ? bq + d : bq;
      db[(size_t)q * Y + c] = act ? d : (T)0;
    }
  }
  __syncthreads();  // this channel's outputs are written
  __shared__ T sums[4];
  if (threadIdx.x == 0) {
    T s[4] = {(T)0, (T)0, (T)0, (T)0};
    for (int z = 0; z < Z; ++z) {
      const T d = da[(size_t)z * Y + c], an = a_new[(size_t)z * Y + c];
      s[0] = fma(d, d, s[0]);
      s[1] = fma(an, an, s[1]);
    }
    for (int q = 0; q < X; ++q) {
      const T d = db[(size_t)q * Y + c], bn = b_new[(size_t)q * Y + c];
      s[2] = fma(d, d, s[2]);
      s[3] = fma(bn, bn, s[3]);
    }
    for (int j = 0; j < 4; ++j) sums[j] = s[j];
  }
  finish_norms<T, NTU>(sums, cn, norms, counter, Y);
}

// ---------------------------------------------------------------------------
// The update for Z <= 8 and X <= 2: mstep_update_reg_kernel
// ---------------------------------------------------------------------------

constexpr int NTF = 512;                      // threads per block
constexpr int UPDATE_BUF_BYTES = 96 * 1024;   // a batch of chunks' partials in shared memory
constexpr int SLOTS = SG / NTF;               // (group, entry) sums a thread keeps

using vlgp::bar_wait;
using vlgp::bulk_copy;

// The entries of channel c reduced as reduce_channel reduces them (chunk k
// in group k mod G, each group summed in chunk order, the groups added in
// order: the same additions, so the same bits), into st.  The channel's
// partials (contiguous in part) come to shared memory first, kb chunks a
// batch, by bulk copies of the 16-byte aligned span around them (part
// holds VW values past its end, so the last span stays inside it), issued
// by one thread and waited on by all; each (group, entry) sum then reads
// eight values ahead of its additions.  Needs G ne <= SG; all threads of
// the block; ends with a barrier.
template <typename T>
__device__ void reduce_staged(const T* __restrict__ part, int C, int kb, int ne, int c, T* buf,
                              T* sg, T* st) {
  constexpr int VW = 16 / sizeof(T);
  constexpr unsigned PIECE = 32768;  // bytes a bulk copy
  __shared__ unsigned long long bar;
  const int G = groups(ne, C);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     (unsigned)__cvta_generic_to_shared(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // each slot's (group, entry): i = tid + NTF m, gi = i / ne, e = i mod ne
  int gi[SLOTS], ei[SLOTS];
  {
    const int dq = NTF / ne, dr = NTF - dq * ne;
    int g = threadIdx.x / ne, e = threadIdx.x - g * ne;
#pragma unroll
    for (int m = 0; m < SLOTS; ++m) {
      gi[m] = g;
      ei[m] = e;
      g += dq;
      e += dr;
      if (e >= ne) {
        e -= ne;
        ++g;
      }
    }
  }
  T s[SLOTS];
  unsigned parity = 0;
  for (int k0 = 0; k0 < C; k0 += kb) {
    const int k1 = min(C, k0 + kb);
    const size_t o = ((size_t)c * C + k0) * ne, a0 = o - o % VW;
    const int off = (int)(o - a0);
    const unsigned bytes = (unsigned)((off + (k1 - k0) * ne + VW - 1) / VW * 16);
    if (threadIdx.x == 0) {
      const unsigned m = (unsigned)__cvta_generic_to_shared(&bar);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(m), "r"(bytes)
                   : "memory");
      for (unsigned b0 = 0; b0 < bytes; b0 += PIECE)
        bulk_copy(reinterpret_cast<char*>(buf) + b0,
                  reinterpret_cast<const char*>(part + a0) + b0, min(PIECE, bytes - b0), &bar);
    }
    bar_wait(&bar, parity);
    parity ^= 1u;
    const int k0g = k0 % G, stride = G * ne;
#pragma unroll
    for (int m = 0; m < SLOTS; ++m) {
      if (gi[m] >= G) continue;
      int k = k0 + gi[m] - k0g + (gi[m] < k0g ? G : 0);  // the group's first chunk of the batch
      const T* p = buf + off + (k - k0) * ne + ei[m];       // chunk k's entry
      if (k == gi[m] && k < k1) {  // the group's first chunk: its sum starts there
        s[m] = p[0];
        p += stride;
        k += G;
      }
      for (; k + 7 * G < k1; k += 8 * G, p += 8 * stride) {
        T v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = p[u * stride];
#pragma unroll
        for (int u = 0; u < 8; ++u) s[m] += v[u];
      }
      for (; k < k1; k += G, p += stride) s[m] += p[0];
    }
    __syncthreads();  // the batch is read: its buffer takes the next
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
#pragma unroll
  for (int m = 0; m < SLOTS; ++m)
    if (gi[m] < G) (G == 1 ? st : sg)[gi[m] * ne + ei[m]] = s[m];
  __syncthreads();
  if (G > 1) {
    for (int e = threadIdx.x; e < ne; e += NTF) {
      T v[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) v[g] = g < G ? sg[(size_t)g * ne + e] : (T)0;
      T t = v[0];
#pragma unroll
      for (int g = 1; g < GMAX; ++g)
        if (g < G) t += v[g];
      st[e] = t;
    }
    __syncthreads();
  }
}

// Solve [M | rhs] (N x N + 1, in one thread's registers) as solve_block
// solves it: Gaussian elimination, the pivot the first row of largest
// magnitude from the diagonal, a zero or NaN pivot giving NaN; the same
// operations in the same order, with no barrier and no shuffle.
template <typename T, int N>
__device__ __forceinline__ void reg_solve(T (&M)[N][N + 1], T (&x)[N]) {
  bool singular = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    int p = k;
    T best = fabs(M[k][k]);
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T m = fabs(M[i][k]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
    if (!(best > (T)0)) singular = true;
#pragma unroll
    for (int i = k + 1; i < N; ++i)
      if (p == i) {
#pragma unroll
        for (int j = k; j <= N; ++j) {
          const T t = M[k][j];
          M[k][j] = M[i][j];
          M[i][j] = t;
        }
      }
    const T d = M[k][k];
#pragma unroll
    for (int i = k + 1; i < N; ++i) {
      const T l = M[i][k] / d;
#pragma unroll
      for (int j = k + 1; j <= N; ++j) M[i][j] -= l * M[k][j];
    }
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    T s = M[i][N];
#pragma unroll
    for (int j = i + 1; j < N; ++j) s -= M[i][j] * x[j];
    x[i] = singular ? (T)NAN : s / M[i][i];
  }
}

// A block of NTF threads per channel: the reduction (reduce_staged, or the
// all-reduced flat statistics gathered), then warp 0 solves the loading's
// Z x Z system and warp 1 the regression's X x X in registers (reg_solve;
// every lane the whole system, lane z writing z), each adding its channel's
// squared norms; thread 64 the noise.  The same arithmetic as
// mstep_update_kernel.
template <typename T, int ZC, int XC>
__global__ void __launch_bounds__(NTF) mstep_update_reg_kernel(
    const T* __restrict__ part, int C, int kb, const T* __restrict__ flat,
    const T* __restrict__ n_ptr, const T* __restrict__ a, const T* __restrict__ b,
    const T* __restrict__ noise_prev, const unsigned char* __restrict__ active,
    T* __restrict__ a_new, T* __restrict__ b_new, T* __restrict__ noise, T* __restrict__ da,
    T* __restrict__ db, T* __restrict__ cn, T* __restrict__ norms, unsigned* counter, int Y,
    int hess, double eps_, double lr_, double da_bound_, double db_bound_) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sg[SG];
  __shared__ T st[entries(ZC, XC, 1)];
  __shared__ T sums[4];  // this channel's squared norms
  const Layout L(ZC, XC, hess);
  const int c = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T eps = (T)eps_, lr = (T)lr_, dab = (T)da_bound_, dbb = (T)db_bound_;
  // this channel's a (warp 0), b (warp 1), n and the carried noise (thread
  // 64), loaded before the reduction so that their latency hides behind it
  T av[ZC], bv[XC], nn = (T)0, nprev = (T)0;
#pragma unroll
  for (int z = 0; z < ZC; ++z) av[z] = warp == 0 ? a[(size_t)z * Y + c] : (T)0;
#pragma unroll
  for (int q = 0; q < XC; ++q) bv[q] = warp == 1 ? b[(size_t)q * Y + c] : (T)0;
  if (threadIdx.x == 64) {
    nn = n_ptr[0];
    nprev = noise_prev[c];
  }
  const bool act = active == nullptr || active[c] != 0;
  if (part != nullptr) {
    reduce_staged(part, C, kb, L.ne, c, reinterpret_cast<T*>(smem_raw), sg, st);
  } else {
    for (int e = threadIdx.x; e < L.ne; e += NTF) {
      long long mirror;
      st[e] = flat[flat_offset(L, e, c, Y, &mirror)];
    }
    __syncthreads();
  }
  // ---- the loading: grad_a = C1 - a C2; warp 0, every lane the whole
  // system, lane z writes z ----
  if (warp == 0) {
    T M[ZC][ZC + 1], x[ZC];
    if (hess) {
#pragma unroll
      for (int z = 0; z < ZC; ++z) {
#pragma unroll
        for (int k = 0; k < ZC; ++k) {
          const int zl = z < k ? z : k, kh = z < k ? k : z;
          T h = st[L.e1 + tri_index(zl, kh, ZC)];
          h = h + av[z] * st[L.e2 + z * ZC + k];
          h = h + av[k] * st[L.e2 + k * ZC + z];
          h = h + (av[z] * av[k]) * st[L.e3 + tri_index(zl, kh, ZC)];
          h = h + st[L.c2 + z] * (T)(z == k);
          h = h + eps * (T)(z == k);
          M[z][k] = h;
        }
        M[z][ZC] = st[L.c1 + z] - av[z] * st[L.c2 + z];
      }
      reg_solve<T, ZC>(M, x);
    } else {
#pragma unroll
      for (int z = 0; z < ZC; ++z) x[z] = lr * (st[L.c1 + z] - av[z] * st[L.c2 + z]);
    }
    T s_d = (T)0, s_a = (T)0;
#pragma unroll
    for (int z = 0; z < ZC; ++z) {
      const T d = clampb(x[z], dab);
      const T an = act ? av[z] + d : av[z], dd = act ? d : (T)0;
      if (lane == z) {
        a_new[(size_t)z * Y + c] = an;
        da[(size_t)z * Y + c] = dd;
      }
      s_d = fma(dd, dd, s_d);
      s_a = fma(an, an, s_a);
    }
    if (lane == 0) {
      sums[0] = s_d;
      sums[1] = s_a;
    }
  } else if (warp == 1) {
    // ---- the regression: nhess_b + eps I ----
    T M[XC][XC + 1], x[XC];
    if (hess) {
#pragma unroll
      for (int q = 0; q < XC; ++q) {
#pragma unroll
        for (int p = 0; p < XC; ++p) {
          const int ql = q < p ? q : p, ph = q < p ? p : q;
          M[q][p] = st[L.nh + tri_index(ql, ph, XC)] + eps * (T)(q == p);
        }
        M[q][XC] = st[L.gb + q];
      }
      reg_solve<T, XC>(M, x);
    } else {
#pragma unroll
      for (int q = 0; q < XC; ++q) x[q] = lr * st[L.gb + q];
    }
    T s_d = (T)0, s_b = (T)0;
#pragma unroll
    for (int q = 0; q < XC; ++q) {
      const T d = clampb(x[q], dbb);
      const T bn = act ? bv[q] + d : bv[q], dd = act ? d : (T)0;
      if (lane == q) {
        b_new[(size_t)q * Y + c] = bn;
        db[(size_t)q * Y + c] = dd;
      }
      s_d = fma(dd, dd, s_d);
      s_b = fma(bn, bn, s_b);
    }
    if (lane == 0) {
      sums[2] = s_d;
      sums[3] = s_b;
    }
  } else if (threadIdx.x == 64) {
    const T mean = st[0] / nn;
    const T var = st[1] / nn - mean * mean;
    noise[c] = act ? var : nprev;
  }
  finish_norms<T, NTF>(sums, cn, norms, counter, Y);
}


// ---------------------------------------------------------------------------
// Launch plans
// ---------------------------------------------------------------------------

// rows per chunk: about CHUNK_TARGET blocks over the card (four of 128
// threads per SM of an H100), a whole number of row batches; a function of
// the shape alone, so the bits are too
constexpr int CHUNK_TARGET = 512;

template <typename T>
size_t stats_smem(int ecap, int Z) {
  return ((size_t)ecap * (NT + 1) + (size_t)4 * Z * RowBatch<T>::RB + RowBatch<T>::RB) * sizeof(T);
}

template <typename T>
int stats_plan(int N, int Y, int Z, int X, int hess, int* rows_per_chunk, int* chunks, int* ecap,
               int* slabs) {
  constexpr int RB = RowBatch<T>::RB;
  const Layout L(Z, X, hess);
  const int tiles = (Y + NT - 1) / NT;
  int cap = L.ne;
  while (cap > 1 && stats_smem<T>(cap, Z) > (size_t)SMEM_MAX) --cap;
  *ecap = cap;
  *slabs = (L.ne + cap - 1) / cap;
  int want = CHUNK_TARGET / (tiles * *slabs);
  want = want < 1 ? 1 : want;
  int rpc = (N + want - 1) / want;
  rpc = ((rpc + RB - 1) / RB) * RB;
  *rows_per_chunk = rpc < RB ? RB : rpc;
  *chunks = (N + *rows_per_chunk - 1) / *rows_per_chunk;
  return L.ne;
}

// the register path: lanes (channels) and row groups of a block, and rows
// per chunk for about REG_CHUNK_TARGET blocks (two per SM of an H100); a
// function of the shape alone, so the bits are too
constexpr int REG_CHUNK_TARGET = 264;

bool register_path(int Z, int X, int is_double) {
#ifdef VLGP_MSTEP_GENERIC
  (void)Z;
  (void)X;
  (void)is_double;
  return false;  // the shared-memory kernel at every shape (tools/torch_variant_ab.py)
#else
  return Z <= (is_double ? ZR_MAX_DOUBLE : ZR_MAX) && X <= XR_MAX;
#endif
}

// rows per tile of the register path: two stages in ~80 KB, so that two
// blocks fit on an SM beside their combine buffers
constexpr int RT_MAX = 32;
constexpr int STAGES_BYTES = 80 * 1024;

template <typename T>
int reg_tile_rows(int lanes, int Z, int X) {
  const int row_bytes = (lanes * (1 + X) + factor_stride(Z)) * (int)sizeof(T);
  const int rt = STAGES_BYTES / (2 * row_bytes);
  return rt < 1 ? 1 : (rt > RT_MAX ? RT_MAX : rt);
}

void reg_plan(int N, int Y, int* lanes, int* rows_per_chunk, int* chunks) {
  *lanes = Y < NTG ? Y : NTG;
  const int tiles = (Y + *lanes - 1) / *lanes;
  int want = REG_CHUNK_TARGET / tiles;
  want = want < 1 ? 1 : want;
  *rows_per_chunk = (N + want - 1) / want;
  *chunks = (N + *rows_per_chunk - 1) / *rows_per_chunk;
}

// the register kernel of (ZC, XC); float64 has none above ZR_MAX_DOUBLE
// (register_path never asks for one), so none is compiled
template <typename T, int ZC, int XC>
auto reg_kernel() -> decltype(&mstep_stats_reg_kernel<T, 1, 1>) {
  constexpr int Z = sizeof(T) == sizeof(double) && ZC > ZR_MAX_DOUBLE ? ZR_MAX_DOUBLE : ZC;
  return mstep_stats_reg_kernel<T, Z, XC>;
}

template <typename T, int XC>
auto reg_kernel_z(int Z) -> decltype(&mstep_stats_reg_kernel<T, 1, 1>) {
  switch (Z) {
    case 1: return reg_kernel<T, 1, XC>();
    case 2: return reg_kernel<T, 2, XC>();
    case 3: return reg_kernel<T, 3, XC>();
    case 4: return reg_kernel<T, 4, XC>();
    case 5: return reg_kernel<T, 5, XC>();
    case 6: return reg_kernel<T, 6, XC>();
    case 7: return reg_kernel<T, 7, XC>();
    default: return reg_kernel<T, 8, XC>();
  }
}

template <typename T>
cudaError_t launch_stats(const T* y, const T* x, const T* mask, const T* mu, const T* v,
                         const T* a, const T* b, T* part, int N, int Y, int Z, int X, int hess,
                         cudaStream_t st) {
  if (register_path(Z, X, sizeof(T) == sizeof(double))) {
    int lanes, rpc, chunks;
    reg_plan(N, Y, &lanes, &rpc, &chunks);
    const int groups = NTG / lanes;
    const int rt = reg_tile_rows<T>(lanes, Z, X);
    const size_t smem = (size_t)2 * stage_size(rt, lanes, Z, X) * sizeof(T);
    const dim3 grid(chunks, (Y + lanes - 1) / lanes);
    auto kernel = X == 1 ? reg_kernel_z<T, 1>(Z) : reg_kernel_z<T, 2>(Z);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, lanes * groups, smem, st>>>(y, x, mask, mu, v, a, b, part, N, Y, hess, lanes,
                                               rpc, rt);
    return cudaGetLastError();
  }
  int rpc, chunks, ecap, slabs;
  stats_plan<T>(N, Y, Z, X, hess, &rpc, &chunks, &ecap, &slabs);
  const size_t smem = stats_smem<T>(ecap, Z);
  const dim3 grid(chunks, (Y + NT - 1) / NT, slabs);
  cudaError_t err = cudaFuncSetAttribute(mstep_stats_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mstep_stats_kernel<T><<<grid, NT, smem, st>>>(y, x, mask, mu, v, a, b, part, N, Y, Z, X, hess,
                                                rpc, ecap);
  return cudaGetLastError();
}

template <typename T>
size_t update_smem(int Z, int X) {
  const int n = Z > X ? Z : X;
  return ((size_t)n * (n + 1) + 2 * (size_t)n + SG) * sizeof(T);
}

// the update kernel of (ZC, XC) for Z <= 8, X <= 2
template <typename T, int XC>
auto update_reg_kernel_z(int Z) -> decltype(&mstep_update_reg_kernel<T, 1, 1>) {
  switch (Z) {
    case 1: return mstep_update_reg_kernel<T, 1, XC>;
    case 2: return mstep_update_reg_kernel<T, 2, XC>;
    case 3: return mstep_update_reg_kernel<T, 3, XC>;
    case 4: return mstep_update_reg_kernel<T, 4, XC>;
    case 5: return mstep_update_reg_kernel<T, 5, XC>;
    case 6: return mstep_update_reg_kernel<T, 6, XC>;
    case 7: return mstep_update_reg_kernel<T, 7, XC>;
    default: return mstep_update_reg_kernel<T, 8, XC>;
  }
}

template <typename T>
cudaError_t launch_update(const T* part, int C, const T* flat, T* red, const T* n, const T* a,
                          const T* b, const T* noise_prev, const unsigned char* act, T* a_new,
                          T* b_new, T* noise, T* da, T* db, T* cn, T* norms, unsigned* counter,
                          int Y, int Z, int X, int hess, double eps, double lr, double da_bound,
                          double db_bound, cudaStream_t st) {
  cudaError_t err;
  if (Z <= ZR_MAX && X <= XR_MAX) {
    const int ne = Layout(Z, X, hess).ne;
    constexpr int VW = 16 / sizeof(T);  // reduce_staged's batch: kb chunks and an alignment
    int kb = part == nullptr ? 1 : (UPDATE_BUF_BYTES / (int)sizeof(T) - 2 * VW) / ne;
    kb = kb < C ? kb : (C > 0 ? C : 1);
    const size_t smem = ((size_t)kb * ne + 2 * VW) * sizeof(T);
    auto kernel = X == 1 ? update_reg_kernel_z<T, 1>(Z) : update_reg_kernel_z<T, 2>(Z);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<Y, NTF, smem, st>>>(part, C, kb, flat, n, a, b, noise_prev, act, a_new, b_new, noise,
                                 da, db, cn, norms, counter, Y, hess, eps, lr, da_bound,
                                 db_bound);
    return cudaGetLastError();
  }
  const size_t smem = update_smem<T>(Z, X);
  err = cudaFuncSetAttribute(mstep_update_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  mstep_update_kernel<T><<<Y, NTU, smem, st>>>(part, C, flat, red, n, a, b, noise_prev, act,
                                               a_new, b_new, noise, da, db, cn, norms, counter, Y,
                                               Z, X, hess, eps, lr, da_bound, db_bound);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan of a stats call: its chunks (the first dimension of part) and
// the packed entries per channel (the last).
int mstep_stats_plan(int N, int Y, int Z, int X, int hess, int is_double, int* chunks,
                     int* entries) {
  if (N < 1 || Y < 1 || Z < 1 || Z > ZMAX || X < 1 || X > XMAX) return (int)cudaErrorInvalidValue;
  int rpc, ecap, slabs;
  *entries = is_double ? stats_plan<double>(N, Y, Z, X, hess, &rpc, chunks, &ecap, &slabs)
                       : stats_plan<float>(N, Y, Z, X, hess, &rpc, chunks, &ecap, &slabs);
  if (register_path(Z, X, is_double)) {
    int lanes;
    reg_plan(N, Y, &lanes, &rpc, chunks);
  }
  return 0;
}

// y (N, Y), x (N, X, Y), mask (N,), mu and v (N, Z), a (Z, Y), b (X, Y),
// part (Y, chunks, entries), all contiguous, float64 when is_double else
// float32; N = S T rows.
int mstep_stats(const void* y, const void* x, const void* mask, const void* mu, const void* v,
                const void* a, const void* b, void* part, int N, int Y, int Z, int X, int hess,
                int is_double, void* stream) {
  if (N < 1 || Y < 1 || Z < 1 || Z > ZMAX || X < 1 || X > XMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    return (int)launch_stats((const double*)y, (const double*)x, (const double*)mask,
                             (const double*)mu, (const double*)v, (const double*)a,
                             (const double*)b, (double*)part, N, Y, Z, X, hess, st);
  return (int)launch_stats((const float*)y, (const float*)x, (const float*)mask, (const float*)mu,
                           (const float*)v, (const float*)a, (const float*)b, (float*)part, N, Y,
                           Z, X, hess, st);
}

// part (Y, chunks, entries) reduced over the chunks into flat (today's
// layouts) and red (Y, entries).
int mstep_reduce(const void* part, int chunks, void* flat, void* red, int Y, int Z, int X,
                 int hess, int is_double, void* stream) {
  if (chunks < 1 || Y < 1 || Z < 1 || Z > ZMAX || X < 1 || X > XMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    mstep_reduce_kernel<double><<<Y, NTU, 0, st>>>((const double*)part, chunks, (double*)flat,
                                                  (double*)red, Y, Z, X, hess);
  else
    mstep_reduce_kernel<float><<<Y, NTU, 0, st>>>((const float*)part, chunks, (float*)flat,
                                                 (float*)red, Y, Z, X, hess);
  return (int)cudaGetLastError();
}

// One update from part (Y, chunks, entries, and 16 bytes of storage past
// its end), reduced in the prologue, or when part is NULL from flat
// (today's layouts, all-reduced); red (Y,
// entries) and cn (Y, 4) are scratch; n a one-element tensor; active NULL
// or (Y,) bytes; norms (4) gets the exit test's squared norms (sum da^2,
// sum a_new^2, sum db^2, sum b_new^2 over the Y channels); counter one
// unsigned int, 0 before the launch and after it.
int mstep_update(const void* part, int chunks, const void* flat, void* red, const void* n,
                 const void* a, const void* b, const void* noise_prev, const void* active,
                 void* a_new, void* b_new, void* noise, void* da, void* db, void* cn, void* norms,
                 void* counter, int Y, int Z, int X, int hess, double eps, double lr,
                 double da_bound, double db_bound, int is_double, void* stream) {
  if (Y < 1 || Z < 1 || Z > ZMAX || X < 1 || X > XMAX || (part == nullptr) == (flat == nullptr) ||
      (part != nullptr && chunks < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned char* act = (const unsigned char*)active;
  unsigned* ctr = (unsigned*)counter;
  if (is_double)
    return (int)launch_update((const double*)part, chunks, (const double*)flat, (double*)red,
                              (const double*)n, (const double*)a, (const double*)b,
                              (const double*)noise_prev, act, (double*)a_new, (double*)b_new,
                              (double*)noise, (double*)da, (double*)db, (double*)cn,
                              (double*)norms, ctr, Y, Z, X, hess, eps, lr, da_bound, db_bound, st);
  return (int)launch_update((const float*)part, chunks, (const float*)flat, (float*)red,
                            (const float*)n, (const float*)a, (const float*)b,
                            (const float*)noise_prev, act, (float*)a_new, (float*)b_new,
                            (float*)noise, (float*)da, (float*)db, (float*)cn, (float*)norms, ctr,
                            Y, Z, X, hess, eps, lr, da_bound, db_bound, st);
}

}  // extern "C"
