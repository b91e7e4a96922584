// The E-step's per-sweep chain, for Hopper, in two launches: the
// counterpart of the body of `sweep` in vlgp_tpu/models/vlgp.py:estep
// (:196-216, stages :202-214), which has no Pallas kernel (XLA fuses its
// einsums and elementwise steps inside one lax.while_loop).  The port's
// plain version (vlgp_tpu_torch/ops/estep.py) runs it as ~11 torch
// launches a sweep, each elementwise one a full pass over (S, T, Y).
// The split falls at the sweep's two channel sums, so a fit whose channels
// are split over a model group all-reduces s and w between and after the
// launches, as before.
//
// Stage a, estep_project.  For every row n = (segment, t):
//
//   eta = xb + sum_z mu_z a_z,   r = exp(min(eta + sum_z v_z (0.5 a_z) a_z, 10)),
//   resid = (Poisson ? y - r : (y - eta) / max(noise, 1e-30)) * mask,
//   s_z = sum_y resid a_z.
//
// Stages b and c, estep_step.  For every segment, each latent z:
//
//   A. Gs[z, r]  = sum_t G[z, t, r] s[z, t]
//   B. u[z, t]   = sum_r G[z, t, r] Gs[z, r] - mu[z, t],  wu = (w mask) u
//   C. Gwu[z, r] = sum_t G[z, t, r] wu[z, t]
//   D. M[z, r]   = sum_q X[z, r, q] Gwu[z, q]
//   E. delta     = clip(u - sum_r G[z, t, r] M[z, r], dmu_bound) mask,
//      mu_new    = mu + delta
//
// then the weight refresh from the new mu and the old v by stage a's row
// routine: w_z = (sum_y U a_z a_z) mask with U = r on a Poisson channel and
// 1 / max(noise, 1e-30) on a Gaussian one.
//
// The member axis (leave-one-neuron-out's chunks, models/vlgp.py:
// estep_members): B members share y, xb and the mask (S base segments)
// while mu, v, w, s, X and the outputs hold their B S segments
// member-major (segment b S + s is member b's base segment s); cm (B, Y)
// multiplies member b's masked residual (stage a) and its U (the refresh),
// after the select, where the torch chain did.  Every path walks a base
// segment's (or tile's) members side by side, so y and xb come from
// device memory once a launch (the project streaming path holds a tile's
// rows and every member's mu and v in one stage; the others read the
// repeats from L2).  Without cm (B = 1) nothing changes, bits included.
//
// The sums, in every path below: a row's sums over the channels run per
// lane over y = lane + 32 k in increasing y, and the lanes' ZB sums meet in
// warp_sums' fixed tree of shuffles; a sum over t (A, C) runs in increasing
// t within chunks of ceil(T / chunks) rows (chunks = t_chunks(T), a
// function of T alone), the chunks added in order; a sum over r or q (B,
// D, E) runs per lane of a quad over k, k + 4, ..., then xor 1 and 2.  So
// two calls give the same bits, and a segment's outputs depend neither on
// S, B, the grid, the block's width, the latent groups nor the path.  Both
// kernels pick between the two sides of a channel with a select, as
// torch.where does, so a non-finite value on the side not taken (a padded
// zero-noise channel, a rate clipped at e^10) never reaches a sum.  No
// atomics.  Every product is a full FMA in the working type (float32 or
// float64; no TF32, no fast exponential).  No allocation, host sync or
// device query inside a call, so both kernels can be captured in a CUDA
// graph.
//
// What bounds them on this card.  At the flagship (Z5 S2000 T50 Y100 R40,
// float32) stage a must read y and xb (40 MB each), mu, v and the mask
// (4.4 MB) and write s (2 MB): ~0.026 ms at 3.35 TB/s; stages b-c read X
// (Z S R^2, 64 MB), xb (40 MB), s, mu, w, v and the mask (8.4 MB) and
// write mu, delta and w (6 MB): ~0.035 ms.  Both do well under 0.5 GFLOP,
// so both are bound by bytes, and each byte is read once: what a design
// has to do is keep enough bytes in flight an SM (~25 KB a microsecond at
// an SM's share of the bandwidth) while the arithmetic overlaps them.
//
// The streaming path (the launch plan from ops/estep.py: rows a tile or
// consumer groups, ring stages, grid; the C side checks it and lays out
// the same bytes, estep_smem).  One block an SM, persistent, walking its
// share of the work (tiles or segments b, b + grid, ...).  One producer
// warp copies each tile's or segment's inputs into a ring of stages in
// shared memory: the 16-byte aligned interior of every contiguous span
// by one cp.async.bulk (the tensor memory accelerator), its ragged head
// and tail (under 16 bytes each, any address, any length) by plain loads,
// and one arrive on the stage's full mbarrier that expects the bulk bytes.
// A value staged from address p sits at byte p mod 16 of its 16-byte
// aligned slot, so no copy reads past its span.  Consumers wait on full,
// never meet at a block-wide barrier after the start, and hand a stage
// back on its empty mbarrier; every wait traps rather than hangs.
//
//   estep_project_stream_kernel: 15 consumer warps (with the producer, 16:
//   up to 128 registers a thread), a tile of 60 rows at the flagship (y
//   and xb rows one span each, the mask, mu and v by latent), 4 stages of
//   ~51 KB.  A warp takes 4 consecutive rows, copies their mu and v into
//   its scratch by row, then a row at a time: lanes over the channels,
//   read from the stage without bank conflicts; where Z <= 8 and Y <= 128
//   (ZT = Z) the lane's loadings, 0.5 a^2, selects and noise sit in
//   registers, and the rates of its four channels form first as
//   straight-line chains, then the selects, then the sums in channel
//   order.  Its Z x 4 sums go through its scratch to device memory as
//   runs of consecutive rows.
//
//   estep_step_stream_kernel: G (Z T R) in shared memory for the block's
//   lifetime, its rows at an odd stride (copied in by the consumers once)
//   so that a thread per (z, t) walking r and a thread per (z, r) walking
//   t both read without bank conflicts; two consumer groups of 256
//   threads, each on its own named barrier, take alternate segments of
//   the block, so one group's dependent phases overlap the other's weight
//   refresh; the producer keeps the next segments' X (Z R^2), xb rows (T
//   Y), mask, s, mu, w and v in a ring of 3 stages (~57 KB each at the
//   flagship).  u, w u, the phase vectors and the new mu stay in the
//   group's scratch; B and E run a thread per (z, t) over four chains
//   (quad_dot: the quad's lanes' sums in one thread, added as its xor 1 and
//   2 would), D a quad per row of X; delta, mu and w go to device memory
//   once, coalesced, at the segment's end.
//
// The cluster path of estep_step, for whole trials whose G does not fit one
// block (the final inference's and leave-one-neuron-out's T1000, where G
// alone is 1 MB): a thread-block cluster of one block per chunk of the sums
// over t, each with its chunk's rows of G resident; see
// estep_step_cluster_kernel below.
//
// The block path, for what neither holds (float64 at the flagship and at
// T1000; Z or R near 128; very long rows): the first design of both
// kernels.  estep_project_kernel takes a tile of RT rows a
// block (3125 blocks at the flagship), mu and v staged in shared memory,
// each warp a row at a time with KY loads a lane in flight through the
// read-only path.  estep_step_kernel is a block per segment (256 threads;
// 512 where there are fewer segments than two an SM), every latent
// inside it, latent groups of zg at a time (zg = Z but where the group's
// R-vectors would not fit the block's shared memory), G and the rows read
// through L1 and L2 after the block asks L2 for its segment's inputs, u
// in dmu and w u in w_out between the phases.
//
// In the block path, for Z <= ZB (SMALL) a lane keeps a row's mu and v and
// the ZB sums in registers; above, the row routine reads mu and v from
// shared memory and sums ZB latents a sweep over the channels, recomputing
// the predictor for each group of ZB.  A warp's ZB sums are added over its lanes by a
// reduce-scatter (xor 16, 8, 4: each lane keeps half of its values) and
// then xor 2 and 1: 9 shuffles for the ZB sums.
//
// Measured on an H100 (PERF.md, tools/torch_variant_ab.py; -DESTEP_CYCLES
// splits the streaming kernels' time): the block path's row pass is
// bound by the bytes its blocks keep in flight (3 blocks an SM of 8 warps,
// 4 + 4 loads a lane: ~25 KB an SM against a microsecond of latency), its
// Woodbury phases by chains of dependent loads between barriers (3-5 us
// each a block) and its weight refresh (15 of a block's 41 us) by the
// same row latency.  The streaming path keeps up to 200 KB an SM in
// flight; what bounds it is the consumers' issue (the row pass's ~200
// instructions a row; the Woodbury phases' barriers and chains).

#include <cooperative_groups.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "ns_common.cuh"

namespace cg = cooperative_groups;

namespace {

using vlgp::bar_arrive;
using vlgp::bar_init;
using vlgp::bar_wait;
using vlgp::bulk_copy;
using vlgp::in_slot;
using vlgp::span_slot;
using vlgp::stage_spans;

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
  const T* cm;                // (B, Y) channel weights of the members, or null (B = 1)
  long long N;                // S T base rows, shared by the members
  int Y, Z, B;
};

// One tile of base rows n0 .. n0 + nr - 1 (nr <= RT) of the row pass for
// member b, by the whole block: out[z, b, n] = sum_y resid[n, y] a[z, y]
// (PROJECT) or (sum_y U[n, y] a[z, y]^2) mask[n], from mu and v (Z, B,
// N), a latent Lz = B N values long; resid and U times cm[b] where there
// are members.  mu is read with plain loads: stage b-c passes the mu it
// has just written.  Uses 3 Z RT values of shared memory at sm.  NTH
// threads a block.
template <typename T, bool PROJECT, bool SMALL, int NTH>
__device__ void row_tile(const RowArgs<T>& p, const T* mu, const T* v, T* out, long long n0,
                         int nr, T* sm, int b) {
  const int Z = p.Z, Y = p.Y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long Lz = (long long)p.B * p.N, m0 = (long long)b * p.N + n0;
  const T* cmr = p.cm ? p.cm + (size_t)b * Y : nullptr;
  T* muS = sm;  // Z x RT
  T* vS = muS + Z * RT;
  T* oS = vS + Z * RT;
  for (int i = tid; i < Z * RT; i += NTH) {
    const int z = i / RT, j = i - z * RT;
    if (j < nr) {
      muS[i] = mu[z * Lz + m0 + j];
      vS[i] = v[z * Lz + m0 + j];
    }
  }
  __syncthreads();
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
          if (cmr) val *= __ldg(cmr + c);
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
  for (int i = tid; i < Z * RT; i += NTH) {
    const int z = i / RT, j = i - z * RT;
    if (j < nr) out[z * Lz + m0 + j] = oS[i];
  }
  __syncthreads();  // the tile's shared memory is free for the next user
}

// block u: member u mod B of base tile u / B
template <typename T, bool SMALL>
__global__ void __launch_bounds__(NT)
    estep_project_kernel(RowArgs<T> p, const T* mu, const T* v, T* s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long n0 = (long long)(blockIdx.x / p.B) * RT;
  const long long left = p.N - n0;
  row_tile<T, true, SMALL, NT>(p, mu, v, s, n0, left < RT ? (int)left : RT,
                               reinterpret_cast<T*>(smem_raw), (int)(blockIdx.x % p.B));
}

// A segment of the latent-major vectors is member b's base segment s, at
// b S + s of B S: mu, w, v, s, X and the outputs hold the members'
// segments member-major, y, xb and the mask the S base segments.
template <typename T>
struct StepArgs {
  RowArgs<T> rows;  // y unused
  const T* G;       // (Z, T, R)
  const T* s;       // (Z, B S, T)
  const T* mu;      // (Z, B S, T)
  const T* w;       // (Z, B S, T), the carried weights
  const T* X;       // (Z, B S, R, R)
  const T* v;       // (Z, B S, T)
  T* mu_out;        // (Z, B S, T)
  T* dmu;           // (Z, B S, T): u between phases B and E, then delta
  T* w_out;         // (Z, B S, T): w u between phases B and C, then the new weights
  int S, Tn, R, zg;  // S base segments
  T bound;
};

// block u: member b = u mod B of base segment u / B (segment b S + u / B)
template <typename T, bool SMALL, int NTH>
__global__ void __launch_bounds__(NTH) estep_step_kernel(StepArgs<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int B = p.rows.B, mb = blockIdx.x % B, tid = threadIdx.x, quad = tid >> 2, k = tid & 3;
  const long long bseg = blockIdx.x / B, seg = (long long)mb * p.S + bseg;
  const int Tn = p.Tn, R = p.R, Z = p.rows.Z, Y = p.rows.Y;
  const long long L = (long long)B * p.rows.N;  // B S T: the stride of a latent
  const long long base = seg * Tn, bbase = bseg * Tn;
  const T* mk = p.rows.mask + bbase;
  // the segment's inputs on their way to L2 before the phases read them
  const T* zrows[4] = {p.s, p.mu, p.w, p.v};
  for (int z = 0; z < Z; ++z) {
    prefetch_span(p.X + ((size_t)z * B * p.S + seg) * R * R, (size_t)R * R * sizeof(T));
    for (int j = 0; j < 4; ++j) prefetch_span(zrows[j] + z * L + base, Tn * sizeof(T));
  }
  prefetch_span(p.rows.xb + bbase * Y, (size_t)Tn * Y * sizeof(T));
  prefetch_span(mk, Tn * sizeof(T));
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
    // D. X G'(w u), a quad per row of X
    for (int o0 = 0; o0 < zc * R; o0 += NTH / 4) {
      const int o = o0 + quad;
      const bool live = o < zc * R;
      T acc = T(0);
      if (live) {
        const int zl = o / R, r = o - zl * R;
        const T* Xr = p.X + (((size_t)(z0 + zl) * B * p.S + seg) * R + r) * R;
        const T* g = gwu + zl * R;
#pragma unroll 4
        for (int q = k; q < R; q += 4) acc = fma_t(__ldg(Xr + q), g[q], acc);
      }
      acc = qsum(acc);
      if (live && k == 0) mv[o] = acc;
    }
    __syncthreads();
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
  }
  // the weights from the new mu and the old v
  for (int t0 = 0; t0 < Tn; t0 += RT)
    row_tile<T, false, SMALL, NTH>(p.rows, p.mu_out, p.v, p.w_out, bbase + t0, min(RT, Tn - t0),
                                   sm, mb);
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
                    const void* pois, const void* noise, const void* cm, long long N, int Y,
                    int Z, int B) {
  return RowArgs<T>{(const T*)y, (const T*)xb, (const T*)mask, (const T*)a,
                    (const unsigned char*)pois, (const T*)noise, (const T*)cm, N, Y, Z, B};
}

template <typename T>
cudaError_t launch_project(const RowArgs<T>& p, const void* mu, const void* v, void* s,
                           cudaStream_t st) {
  const size_t smem = row_smem<T>(p.Z);
  const unsigned blocks = (unsigned)((p.N + RT - 1) / RT * p.B);
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
  const bool few = (long long)p.rows.B * p.S < 2 * SMS;
  const int nth = few ? NT_FEW : NT;
  auto kernel = p.rows.Z <= ZB ? (few ? &estep_step_kernel<T, true, NT_FEW>
                                      : &estep_step_kernel<T, true, NT>)
                               : (few ? &estep_step_kernel<T, false, NT_FEW>
                                      : &estep_step_kernel<T, false, NT>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)p.rows.B * p.S, nth, smem, st>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The streaming path
// ---------------------------------------------------------------------------

constexpr int PW = 15;                 // consumer warps of a project block (16 warps
                                       // with the producer: up to 128 registers a thread)
constexpr int PNT = 32 * (PW + 1);     // and its producer warp
constexpr int GT = 256;                // threads of a consumer group of a step block
constexpr int NG_MAX = 2;              // consumer groups of a step block, at most
constexpr int SNT_MAX = NG_MAX * GT + 32;
constexpr int ST_MAX = 4;              // stages of a ring, at most
constexpr int BAR_BYTES = 128;         // the mbarriers, at the head of shared memory
constexpr size_t SMEM_MAX = 232448;    // shared memory a block can have on an H100

// Built with -DESTEP_CYCLES (tools/torch_variant_ab.py), the streaming
// kernels count clock cycles of one consumer thread and of the producer
// per block into g_cycles (estep_cycles copies them out): CY(...) keeps
// its statement only in that build.  Slots: 0 the consumer's loop, 1 its
// waits for a stage, 2 the producer's loop, 3 its waits for a free
// stage, 4 tiles or segments; estep_step also 5-9 phases A-E, 10 the
// weight refresh and the stores, 11 G's copy.
#ifdef ESTEP_CYCLES
#define CY(...) __VA_ARGS__
constexpr int CY_BLOCKS = 264, CY_SLOTS = 12;
__device__ unsigned long long g_cycles[2][CY_BLOCKS][CY_SLOTS];
__device__ __forceinline__ void cy_put(int which, const long long (&cy)[CY_SLOTS], int first,
                                       int last) {
  if (blockIdx.x < CY_BLOCKS)
    for (int i = first; i < last; ++i) g_cycles[which][blockIdx.x][i] = (unsigned long long)cy[i];
}
#else
#define CY(...)
#endif

// the threads of consumer group g (named barrier 1 + g)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(GT) : "memory");
}

// A lane's channels c = lane + 32 k, k < KY, where Y <= 32 KY and Z = ZT
// <= ZB: the loadings, (0.5 a) a as row_tile forms it, max(noise, 1e-30)
// and its reciprocal, and the Poisson and live flags (bit k), in registers
// for the block's lifetime.
template <typename T, int ZT>
struct LaneZ {
  T a[KY][ZT], ha[KY][ZT], sn[KY], isn[KY];
  unsigned pois, live;
  __device__ void load(const RowArgs<T>& p, int lane) {
    pois = live = 0;
#pragma unroll
    for (int k = 0; k < KY; ++k) {
      const int c = lane + 32 * k;
      const bool on = c < p.Y;
#pragma unroll
      for (int q = 0; q < ZT; ++q) {
        a[k][q] = on ? p.a[(size_t)q * p.Y + c] : T(0);
        ha[k][q] = T(0.5) * a[k][q] * a[k][q];
      }
      sn[k] = on ? safe_noise(p.noise[c]) : T(1);
      isn[k] = T(1) / sn[k];
      if (on) live |= 1u << k;
      if (on && p.pois[c] != 0) pois |= 1u << k;
    }
  }
};

// The predictor, the rates' argument and the rate of one channel of a row
// (row_tile's operations in its order): e = xb + sum_q mu_q a_q, r =
// exp(min(e + sum_q v_q (0.5 a_q) a_q, 10)).
template <typename T, int ZT>
__device__ __forceinline__ void rate(const T* a, const T* ha, const T (&mu)[ZT],
                                     const T (&v)[ZT], T xv, T& e, T& r) {
  T g = T(0);
  e = T(0);
#pragma unroll
  for (int q = 0; q < ZT; ++q) {
    e = fma_t(mu[q], a[q], e);
    g = fma_t(v[q], ha[q], g);
  }
  e = e + xv;
  r = exp_t(clip_hi(e + g));
}

// the select of one channel (the other side is never formed), times the
// row's mask for stage a
template <typename T, bool PROJECT>
__device__ __forceinline__ T pick(bool pois, T yv, T e, T r, T sn, T isn, T mk) {
  T val;
  if (pois) {
    val = PROJECT ? yv - r : r;
  } else {
    val = PROJECT ? (yv - e) / sn : isn;
  }
  return PROJECT ? val * mk : val;
}

// One row by a warp, for Z = ZT: row_tile's sums in its order from the
// row's channels xr, yr (shared memory), its mu, v and mask, and the
// member's channel weights cmr (null without members); returns
// warp_sums' value (lane 4 q holds latent q's).  Every lane forms all KY
// channels, its index clamped to the row (only a live channel enters a
// sum): first the rates, as straight-line chains the compiler
// interleaves, then the selects, then the sums over the channels in
// increasing order.
template <typename T, bool PROJECT, int ZT>
__device__ __forceinline__ T row_one(const LaneZ<T, ZT>& ln, int Y, const T* xr, const T* yr,
                                     const T (&mu)[ZT], const T (&v)[ZT], T mk, const T* cmr,
                                     int lane) {
  T e[KY], r[KY], val[KY];
#pragma unroll
  for (int k = 0; k < KY; ++k) {
    const int c = min(lane + 32 * k, Y - 1);
    rate<T, ZT>(ln.a[k], ln.ha[k], mu, v, xr[c], e[k], r[k]);
  }
#pragma unroll
  for (int k = 0; k < KY; ++k) {
    const int c = min(lane + 32 * k, Y - 1);
    val[k] = pick<T, PROJECT>((ln.pois >> k) & 1u, PROJECT ? yr[c] : T(0), e[k], r[k],
                              ln.sn[k], ln.isn[k], mk);
    if (cmr) val[k] *= __ldg(cmr + c);
  }
  T acc[ZB];
#pragma unroll
  for (int q = 0; q < ZB; ++q) acc[q] = T(0);
#pragma unroll
  for (int k = 0; k < KY; ++k)
#pragma unroll
    for (int q = 0; q < ZT; ++q)
      if ((ln.live >> k) & 1u)
        acc[q] = fma_t(val[k], PROJECT ? ln.a[k][q] : ln.a[k][q] * ln.a[k][q], acc[q]);
  return warp_sums(acc, lane);
}

// One row by a warp, for any Z and Y (the generic path), its channels and
// its mu and v (muW, vW: Z values) in shared memory: the Z sums go to o[z
// ostride] (times mk for the weights) from lanes 4 q, ZB latents a sweep
// over the channels, the predictor formed again for each group of ZB.
// The sums are row_tile's, in its order (for Z <= ZB too: its predictor
// adds the same products in the same order).
template <typename T, bool PROJECT>
__device__ __forceinline__ void row_pass(const RowArgs<T>& p, const T* xr, const T* yr,
                                         const T* muW, const T* vW, T mk, const T* cmr, T* o,
                                         int ostride, int lane) {
  const int Z = p.Z, Y = p.Y;
  for (int zb = 0; zb < Z; zb += ZB) {
    T acc[ZB];
#pragma unroll
    for (int q = 0; q < ZB; ++q) acc[q] = T(0);
    for (int c = lane; c < Y; c += 32) {
      T e = T(0), g = T(0);
      for (int z = 0; z < Z; ++z) {
        const T az = __ldg(p.a + (size_t)z * Y + c);
        e = fma_t(muW[z], az, e);
        g = fma_t(vW[z], T(0.5) * az * az, g);
      }
      e = e + xr[c];
      const T r = exp_t(clip_hi(e + g)), sn = safe_noise(__ldg(p.noise + c));
      T val = pick<T, PROJECT>(p.pois[c] != 0, PROJECT ? yr[c] : T(0), e, r, sn, T(1) / sn,
                               mk);
      if (cmr) val *= __ldg(cmr + c);
#pragma unroll
      for (int q = 0; q < ZB; ++q)
        if (zb + q < Z) {
          const T aq = __ldg(p.a + (size_t)(zb + q) * Y + c);
          acc[q] = fma_t(val, PROJECT ? aq : aq * aq, acc[q]);
        }
    }
    const T sum = warp_sums(acc, lane);
    const int q = lane >> 2;
    if ((lane & 3) == 0 && zb + q < Z) o[(zb + q) * ostride] = PROJECT ? sum : sum * mk;
  }
}

// The project block's shared memory: the mbarriers, `stages` stages of a
// tile of rt base rows (y and xb rows, the mask, then mu of each (latent,
// member) and v of each, latent-major), then each consumer warp's
// scratch: its rows' mu and v by row (2 Z values a row), then its Z x rt
// / PW sums, for one member at a time.
template <typename T>
struct ProjectLayout {
  size_t rows, lat, stage, total;
  __host__ __device__ ProjectLayout(int rt, int stages, int Y, int Z, int B) {
    rows = span_slot<T>((long long)rt * Y);
    lat = span_slot<T>(rt);
    stage = 2 * rows + (size_t)(1 + 2 * Z * B) * lat;
    total = BAR_BYTES + stages * stage + (size_t)PW * 3 * Z * (rt / PW) * sizeof(T);
  }
};

// ZT = Z (1 ... ZB) where Y <= 32 KY: the register path (row_one); ZT = 0:
// any shape (row_pass).
template <typename T, int ZT>
__global__ void __launch_bounds__(PNT, 1)
    estep_project_stream_kernel(RowArgs<T> p, const T* mu, const T* v, T* s, int rt, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* empty = full + ST_MAX;
  const int Z = p.Z, Y = p.Y, B = p.B, ZB1 = Z * B, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const long long N = p.N, ntiles = (N + rt - 1) / rt;
  const ProjectLayout<T> L(rt, stages, Y, Z, B);
  unsigned char* ring = smem_raw + BAR_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(full + i, 32);
      bar_init(empty + i, PW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  CY(long long cy[CY_SLOTS] = {}; const long long cy0 = clock64();)
  if (warp == PW) {  // the producer
    int k = 0;
    for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
      const int st = k % stages;
      CY(const long long w0 = clock64();)
      if (k >= stages) bar_wait(empty + st, ((k / stages) - 1) & 1);
      CY(cy[3] += clock64() - w0;)
      const long long n0 = tile * rt, left = N - n0;
      const int nr = left < rt ? (int)left : rt;
      unsigned char* stage = ring + st * L.stage;
      stage_spans<T>(3 + 2 * ZB1, [&](int i, unsigned char*& slot, const T*& src, long long& n) {
        if (i < 2) {
          slot = stage + i * L.rows;
          src = (i == 0 ? p.y : p.xb) + n0 * Y;
          n = (long long)nr * Y;
        } else {
          // the mask, then mu of each (latent, member) z B + b, then v of each
          const int j = i - 2;
          slot = stage + 2 * L.rows + j * L.lat;
          src = j == 0 ? p.mask + n0
                       : (j <= ZB1 ? mu : v) + (long long)((j - 1) % ZB1) * N + n0;
          n = nr;
        }
      }, full + st, lane);
    }
    CY(cy[2] = clock64() - cy0; if (lane == 0) cy_put(0, cy, 2, 4);)
    return;
  }
  using Lanes = LaneZ<T, ZT ? ZT : 1>;
  Lanes ln;
  if (ZT) ln.load(p, lane);
  const int rpw = rt / PW, Z2 = ZT ? 2 * ZT : 2 * Z;
  T* mvW = reinterpret_cast<T*>(ring + stages * L.stage) + (size_t)warp * 3 * Z * rpw;
  T* oW = mvW + 2 * Z * rpw;
  int k = 0;
  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    const int st = k % stages;
    CY(const long long w0 = clock64();)
    bar_wait(full + st, (k / stages) & 1);
    CY(cy[1] += clock64() - w0; cy[4] += 1;)
    const long long n0 = tile * rt, left = N - n0;
    const int j0 = warp * rpw, live = (int)max(0ll, min((long long)rpw, left - j0));
    unsigned char* stage = ring + st * L.stage;
    const T* yS = in_slot(stage, p.y + n0 * Y);
    const T* xS = in_slot(stage + L.rows, p.xb + n0 * Y);
    const T* mS = in_slot(stage + 2 * L.rows, p.mask + n0);
    unsigned char* lat = stage + 2 * L.rows + L.lat;
    // every member on the tile's rows, which stay in the stage
    for (int b = 0; b < B; ++b) {
      const T* cmr = p.cm ? p.cm + (size_t)b * Y : nullptr;
      // the warp's rows' mu and v of member b, by row, so a row's 2 Z
      // values sit together
      for (int i = lane; i < Z2 * live; i += 32) {
        const int jj = i / Z2, qq = i - jj * Z2;
        const int idx = qq < Z ? qq * B + b : ZB1 + (qq - Z) * B + b;  // its slot
        const T* src = (qq < Z ? mu : v) + (long long)(idx % ZB1) * N + n0;
        mvW[i] = in_slot(lat + idx * L.lat, src)[j0 + jj];
      }
      __syncwarp();
      if constexpr (ZT > 0) {
        for (int jj = 0; jj < live; ++jj) {
          const int j = j0 + jj;
          T m[ZT], w[ZT];
#pragma unroll
          for (int q = 0; q < ZT; ++q) {
            m[q] = mvW[jj * 2 * ZT + q];
            w[q] = mvW[jj * 2 * ZT + ZT + q];
          }
          const T sum = row_one<T, true, ZT>(ln, Y, xS + (size_t)j * Y, yS + (size_t)j * Y, m,
                                             w, mS[j], cmr, lane);
          const int q = lane >> 2;
          if ((lane & 3) == 0 && q < ZT) oW[q * rpw + jj] = sum;
        }
      } else {
        for (int jj = 0; jj < live; ++jj) {
          const int j = j0 + jj;
          row_pass<T, true>(p, xS + (size_t)j * Y, yS + (size_t)j * Y, mvW + jj * Z2,
                            mvW + jj * Z2 + Z, mS[j], cmr, oW + jj, rpw, lane);
        }
      }
      __syncwarp();
      // the warp's reads of the stage are done
      if (b == B - 1 && lane == 0) bar_arrive(empty + st);
      for (int i = lane; i < Z * rpw; i += 32) {
        const int z = i / rpw, jj = i - z * rpw;
        if (jj < live) s[((long long)z * B + b) * N + n0 + j0 + jj] = oW[i];
      }
      __syncwarp();
    }
  }
  CY(cy[0] = clock64() - cy0; if (threadIdx.x == 0) { cy_put(0, cy, 0, 2); cy_put(0, cy, 4, 5); })
}

// G's rows in shared memory, padded to an odd stride: a thread per (z, t)
// walking r and a thread per (z, r) walking t both read without bank
// conflicts
__host__ __device__ inline int g_stride(int R) { return R | 1; }

// The step block's shared memory: the mbarriers, G (Z T rows of
// g_stride(R)), `stages` stages of a segment (X by latent, the xb rows,
// the mask, then s, mu, w and v of each latent), then each consumer
// group's scratch: Gs, Gwu and M (Z R each), the chunks' sums of A and C
// where T has more than one chunk, u (then delta), w u (then the new w)
// and the new mu (Z T each), and the new mu and the old v by row (T x 2
// Z).
template <typename T>
struct StepLayout {
  size_t G, X, rows, vec, stage, group, total;
  __host__ __device__ StepLayout(int groups, int stages, int Tn, int Y, int Z, int R) {
    G = ((size_t)Z * Tn * g_stride(R) * sizeof(T) + 15) / 16 * 16;
    X = span_slot<T>((long long)R * R);
    rows = span_slot<T>((long long)Tn * Y);
    vec = span_slot<T>(Tn);
    stage = Z * X + rows + (size_t)(1 + 4 * Z) * vec;
    const int nch = t_chunks(Tn);
    group = ((size_t)(3 + (nch > 1 ? nch : 0)) * Z * R + (size_t)5 * Z * Tn) * sizeof(T);
    total = BAR_BYTES + G + stages * stage + groups * group;
  }
};

// sum_k P[k] Q[k] over k < n as a quad of lanes sums it (lane j over k = j,
// j + 4, ..., then xor 1 and 2): four chains, then (p0 + p1) + (p2 + p3),
// by one thread
template <typename T>
__device__ __forceinline__ T quad_dot(const T* P, const T* Q, int n) {
  T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
  int k = 0;
  for (; k + 3 < n; k += 4) {
    p0 = fma_t(P[k], Q[k], p0);
    p1 = fma_t(P[k + 1], Q[k + 1], p1);
    p2 = fma_t(P[k + 2], Q[k + 2], p2);
    p3 = fma_t(P[k + 3], Q[k + 3], p3);
  }
  if (k < n) p0 = fma_t(P[k], Q[k], p0);
  if (k + 1 < n) p1 = fma_t(P[k + 1], Q[k + 1], p1);
  if (k + 2 < n) p2 = fma_t(P[k + 2], Q[k + 2], p2);
  return (p0 + p1) + (p2 + p3);
}

// ZT as for the project kernel (the weight refresh).
template <typename T, int ZT>
__global__ void __launch_bounds__(SNT_MAX, 1)
    estep_step_stream_kernel(StepArgs<T> p, int groups, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* empty = full + ST_MAX;
  const int Tn = p.Tn, R = p.R, Z = p.rows.Z, Y = p.rows.Y, S = p.S, RP = g_stride(R);
  const int B = p.rows.B, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long NL = (long long)B * p.rows.N;  // B S T: the stride of a latent
  const long long units = (long long)B * S;      // unit u: member u mod B of base segment u / B
  const StepLayout<T> L(groups, stages, Tn, Y, Z, R);
  T* Gp = reinterpret_cast<T*>(smem_raw + BAR_BYTES);
  unsigned char* ring = smem_raw + BAR_BYTES + L.G;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(full + i, 32);
      bar_init(empty + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // latent z's vector j (0 s, 1 mu, 2 w, 3 v) from the segment at base
  auto zsrc = [&](int z, int j, long long base) {
    return (j == 0 ? p.s : j == 1 ? p.mu : j == 2 ? p.w : p.v) + z * NL + base;
  };
  CY(long long cy[CY_SLOTS] = {}; long long cy0 = clock64(), c1;)
  if (warp == groups * (GT / 32)) {  // the producer
    int k = 0;
    for (long long u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const long long bseg = u / B, seg = (u % B) * S + bseg;
      const int st = k % stages;
      CY(const long long w0 = clock64();)
      if (k >= stages) bar_wait(empty + st, ((k / stages) - 1) & 1);
      CY(cy[3] += clock64() - w0;)
      unsigned char* stage = ring + st * L.stage;
      stage_spans<T>(2 + 5 * Z, [&](int i, unsigned char*& slot, const T*& src, long long& n) {
        if (i < Z) {
          slot = stage + i * L.X;
          src = p.X + ((long long)i * units + seg) * R * R;
          n = (long long)R * R;
        } else if (i == Z) {
          slot = stage + Z * L.X;
          src = p.rows.xb + bseg * Tn * Y;
          n = (long long)Tn * Y;
        } else {
          const int j = i - Z - 1;  // the mask, then s, mu, w and v of each latent
          slot = stage + Z * L.X + L.rows + j * L.vec;
          src = j == 0 ? p.rows.mask + bseg * Tn : zsrc((j - 1) >> 2, (j - 1) & 3, seg * Tn);
          n = Tn;
        }
      }, full + st, lane);
    }
    CY(cy[2] = clock64() - cy0; if (lane == 0) cy_put(1, cy, 2, 4);)
    return;
  }
  // G into shared memory once, by every consumer thread, while the first
  // segments' copies land
  const int nthr = groups * GT, nG = Z * Tn * R;
  for (int i0 = threadIdx.x; i0 < nG; i0 += 8 * nthr) {
    T gv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) gv[u] = i0 + u * nthr < nG ? __ldg(p.G + i0 + u * nthr) : T(0);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * nthr, row = i / R;
      if (i < nG) Gp[row * RP + (i - row * R)] = gv[u];
    }
  }
  asm volatile("bar.sync %0, %1;" ::"r"(1 + NG_MAX), "r"(nthr) : "memory");
  CY(cy[11] = clock64() - cy0; cy0 = clock64();)
  const int g = warp / (GT / 32), gt = threadIdx.x - g * GT, gwarp = gt >> 5;
  const int quad = gt >> 2, k4 = gt & 3;
  using Lanes = LaneZ<T, ZT ? ZT : 1>;
  Lanes ln;
  if (ZT) ln.load(p.rows, lane);
  const int nzr = Z * R, nzt = Z * Tn, nch = t_chunks(Tn), tch = (Tn + nch - 1) / nch;
  T* gs = reinterpret_cast<T*>(ring + stages * L.stage + g * L.group);
  T* gwu = gs + nzr;
  T* mv = gwu + nzr;
  T* part = mv + nzr;  // nch x Z x R where nch > 1
  T* uS = part + (nch > 1 ? nch * nzr : 0);
  T* wuS = uS + nzt;
  T* munS = wuS + nzt;
  T* mvR = munS + nzt;  // T x 2 Z
  for (int k = g;; k += groups) {
    const long long u = blockIdx.x + (long long)k * gridDim.x;
    if (u >= units) break;
    const int mb = (int)(u % B);
    const long long bseg = u / B, seg = mb * (long long)S + bseg;
    const T* cmr = p.rows.cm ? p.rows.cm + (size_t)mb * Y : nullptr;
    const int st = k % stages;
    CY(c1 = clock64();)
    bar_wait(full + st, (k / stages) & 1);
    CY(cy[1] += clock64() - c1; cy[4] += 1; c1 = clock64();)
    unsigned char* stage = ring + st * L.stage;
    const long long base = seg * Tn, bbase = bseg * Tn;
    unsigned char* vecs = stage + Z * L.X + L.rows;
    const T* mk = in_slot(vecs, p.rows.mask + bbase);
    auto zv = [&](int z, int j) {
      return in_slot(vecs + (1 + 4 * z + j) * L.vec, zsrc(z, j, base));
    };
    // A. G's: a thread per (z, r) and chunk of t, t in increasing order, then
    // the chunks added in order
    for (int o = gt; o < nzr * nch; o += GT) {
      const int c = o / nzr, zr = o - c * nzr, z = zr / R, r = zr - z * R;
      const T* Gz = Gp + (size_t)z * Tn * RP + r;
      const T* sz = zv(z, 0);
      const int t1 = min(Tn, (c + 1) * tch);
      T acc = T(0);
#pragma unroll 4
      for (int t = c * tch; t < t1; ++t) acc = fma_t(Gz[(size_t)t * RP], sz[t], acc);
      (nch > 1 ? part : gs)[o] = acc;
    }
    group_sync(g);
    if (nch > 1) {
      for (int o = gt; o < nzr; o += GT) {
        T acc = part[o];
        for (int c = 1; c < nch; ++c) acc += part[c * nzr + o];
        gs[o] = acc;
      }
      group_sync(g);
    }
    CY(cy[5] += clock64() - c1; c1 = clock64();)
    // B. u = G G's - mu and w u, a thread per (z, t)
    for (int o = gt; o < nzt; o += GT) {
      const int z = o / Tn, t = o - z * Tn;
      const T m = zv(z, 1)[t], wm = zv(z, 2)[t] * mk[t];
      const T u = quad_dot(Gp + ((size_t)z * Tn + t) * RP, gs + z * R, R) - m;
      uS[o] = u;
      wuS[o] = wm * u;
    }
    group_sync(g);
    CY(cy[6] += clock64() - c1; c1 = clock64();)
    // C. G'(w u), as A
    for (int o = gt; o < nzr * nch; o += GT) {
      const int c = o / nzr, zr = o - c * nzr, z = zr / R, r = zr - z * R;
      const T* Gz = Gp + (size_t)z * Tn * RP + r;
      const T* wu = wuS + z * Tn;
      const int t1 = min(Tn, (c + 1) * tch);
      T acc = T(0);
#pragma unroll 4
      for (int t = c * tch; t < t1; ++t) acc = fma_t(Gz[(size_t)t * RP], wu[t], acc);
      (nch > 1 ? part : gwu)[o] = acc;
    }
    group_sync(g);
    if (nch > 1) {
      for (int o = gt; o < nzr; o += GT) {
        T acc = part[o];
        for (int c = 1; c < nch; ++c) acc += part[c * nzr + o];
        gwu[o] = acc;
      }
      group_sync(g);
    }
    CY(cy[7] += clock64() - c1; c1 = clock64();)
    // D. X G'(w u), a quad per row of X (X's rows are read across a quad's
    // lanes, 2-way bank conflicts at most where a thread's row would give 8)
    for (int o0 = 0; o0 < nzr; o0 += GT / 4) {
      const int o = o0 + quad;
      const bool live = o < nzr;
      T acc = T(0);
      if (live) {
        const int z = o / R, r = o - z * R;
        const T* Xr = in_slot(stage + z * L.X, p.X + ((long long)z * units + seg) * R * R) +
                      (size_t)r * R;
        const T* gz = gwu + z * R;
#pragma unroll 4
        for (int q = k4; q < R; q += 4) acc = fma_t(Xr[q], gz[q], acc);
      }
      acc = qsum(acc);
      if (live && k4 == 0) mv[o] = acc;
    }
    group_sync(g);
    CY(cy[8] += clock64() - c1; c1 = clock64();)
    // E. delta = u - G X G'(w u), clipped and masked; mu + delta, a thread per (z, t)
    for (int o = gt; o < nzt; o += GT) {
      const int z = o / Tn, t = o - z * Tn;
      const T acc = quad_dot(Gp + ((size_t)z * Tn + t) * RP, mv + z * R, R);
      const T d = clip(uS[o] - acc, p.bound) * mk[t];
      uS[o] = d;
      munS[o] = zv(z, 1)[t] + d;
      mvR[t * 2 * Z + z] = munS[o];
      mvR[t * 2 * Z + Z + z] = zv(z, 3)[t];
    }
    group_sync(g);
    CY(cy[9] += clock64() - c1; c1 = clock64();)
    // the weights from the new mu and the old v, a warp a row
    const T* xbS = in_slot(stage + Z * L.X, p.rows.xb + bbase * Y);
    if constexpr (ZT > 0) {
      for (int t = gwarp; t < Tn; t += GT / 32) {
        T m[ZT], w[ZT];
#pragma unroll
        for (int q = 0; q < ZT; ++q) {
          m[q] = mvR[t * 2 * ZT + q];
          w[q] = mvR[t * 2 * ZT + ZT + q];
        }
        const T sum = row_one<T, false, ZT>(ln, Y, xbS + (size_t)t * Y, nullptr, m, w, mk[t],
                                            cmr, lane);
        const int q = lane >> 2;
        if ((lane & 3) == 0 && q < ZT) wuS[q * Tn + t] = sum * mk[t];
      }
    } else {
      for (int t = gwarp; t < Tn; t += GT / 32)
        row_pass<T, false>(p.rows, xbS + (size_t)t * Y, nullptr, mvR + t * 2 * Z,
                           mvR + t * 2 * Z + Z, mk[t], cmr, wuS + t, Tn, lane);
    }
    group_sync(g);
    if (gt == 0) bar_arrive(empty + st);  // the group's reads of the stage are done
    for (int o = gt; o < nzt; o += GT) {
      const int z = o / Tn, t = o - z * Tn;
      const long long i = z * NL + base + t;
      p.dmu[i] = uS[o];
      p.mu_out[i] = munS[o];
      p.w_out[i] = wuS[o];
    }
    CY(cy[10] += clock64() - c1;)
  }
  CY(cy[0] = clock64() - cy0; if (threadIdx.x == 0) { cy_put(1, cy, 0, 2); cy_put(1, cy, 4, 12); })
}


// ---------------------------------------------------------------------------
// The cluster path of estep_step (T > 64 where G does not fit one block:
// the final inference's and leave-one-neuron-out's whole trials)
// ---------------------------------------------------------------------------

constexpr int CNT = 352;   // consumer threads of a cluster-path block (11 warps)
constexpr int CNTB = 384;  // and its producer warp: up to 168 registers a thread
constexpr int CL_MAX = 16;  // blocks of a cluster, at most (non-portable above 8)

// A cluster-path block's shared memory: the mbarriers, its rows of G (nr =
// ceil(T / C) rows of each latent at the odd stride), `stages` stages of
// a segment's share (its xr = ceil(R / C) rows of X by latent, its xb
// rows, its mask rows, then s, mu, w and v of each latent on its rows),
// then its scratch: every block's chunk sums of A and of C (C x Z R each,
// written by their blocks), Gs and Gwu (Z R each), M (Z R, each row
// written by its block), u (then delta), w u (then the new w) and the new
// mu on its rows (Z nr each), the new mu and the old v by row (nr x 2 Z).
template <typename T>
struct ClusterLayout {
  int nr, xr;
  size_t G, X, rows, vec, stage, total;
  __host__ __device__ ClusterLayout(int C, int stages, int Tn, int Y, int Z, int R) {
    nr = (Tn + C - 1) / C;
    xr = (R + C - 1) / C;
    G = ((size_t)Z * nr * g_stride(R) * sizeof(T) + 15) / 16 * 16;
    X = span_slot<T>((long long)xr * R);
    rows = span_slot<T>((long long)nr * Y);
    vec = span_slot<T>(nr);
    stage = Z * X + rows + (size_t)(1 + 4 * Z) * vec;
    total = BAR_BYTES + G + stages * stage +
            ((size_t)(2 * C + 3) * Z * R + (size_t)5 * Z * nr) * sizeof(T);
  }
};

// the cluster's barrier: every thread of every block arrives, then waits;
// writes before it (to any block's shared memory) are seen after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}
// the consumers of a block (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CNT) : "memory");
}

// One cluster of C = t_chunks(T) blocks a base segment at a time, every
// member of it in turn (units k = i B + b of the cluster's base segments
// c, c + clusters, ...); block q of the cluster owns chunk q of the sums
// over t (rows t0 .. t0 + nr - 1, the block path's chunk) and rows r0 ..
// r0 + xn - 1 of each latent's X.  G's rows of its chunk sit in shared
// memory for the block's lifetime; a producer warp keeps the next stages
// - 1 units' inputs on their way by bulk copies (stage_spans), refilling
// the stage of unit k - 1 once the cluster's first barrier of unit k shows
// its consumers done.  A unit: A, the block's chunk sums, written into
// every block's shared memory (distributed shared memory); cluster
// barrier; Gs = the chunks' sums added in chunk order, from the block's
// own copy; B and C on its rows, C's chunk sums written likewise;
// barrier; Gwu likewise; D on its rows of X, each row of M written into
// every block; barrier; E and the weight refresh on its rows, delta, mu
// and w to device memory.  So every output has the block path's
// operations in its order, and its bits.  A buffer is written for unit k
// + 1 only after a barrier that its readers of unit k pass after reading
// it, so one copy of each is enough.  Measured on an H100 (PERF.md,
// -DESTEP_CYCLES: slot 2 the cluster barriers, 3 the chunk sums): a unit
// costs a block ~23,000 cycles at T1000 Z5 R50, the barriers and the
// refresh a quarter each, every phase a chain of dependent shared-memory
// loads with one item a thread; the bytes would take a tenth of that.
template <typename T, int ZT>
__global__ void __launch_bounds__(CNTB, 1)
    estep_step_cluster_kernel(StepArgs<T> p, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), q = (int)cluster.block_rank();
  const int cid = (int)(blockIdx.x / C), ncl = (int)(gridDim.x / C);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  const int Tn = p.Tn, R = p.R, Z = p.rows.Z, Y = p.rows.Y, S = p.S, B = p.rows.B;
  const int RP = g_stride(R), tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long NL = (long long)B * p.rows.N;  // B S T: the stride of a latent
  const long long SB = (long long)B * S;
  const ClusterLayout<T> L(C, stages, Tn, Y, Z, R);
  const int t0 = q * L.nr, nr = min(Tn, t0 + L.nr) - t0;  // this block's chunk
  const int r0 = min(R, q * L.xr), xn = min(R, r0 + L.xr) - r0;  // and its rows of X
  const int nzr = Z * R;
  T* Gp = reinterpret_cast<T*>(smem_raw + BAR_BYTES);
  unsigned char* ring = smem_raw + BAR_BYTES + L.G;
  T* partA = reinterpret_cast<T*>(ring + stages * L.stage);  // C x Z R
  T* partC = partA + C * nzr;                                 // C x Z R
  T* gs = partC + C * nzr;
  T* gwu = gs + nzr;
  T* mv = gwu + nzr;
  T* uS = mv + nzr;  // Z x nr each
  T* wuS = uS + Z * L.nr;
  T* munS = wuS + Z * L.nr;
  T* mvR = munS + Z * L.nr;  // nr x 2 Z
  const int nbase = cid < S ? (S - cid + ncl - 1) / ncl : 0;
  const long long nunits = (long long)nbase * B;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) bar_init(full + i, 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // unit k's base segment and segment
  auto unit = [&](long long k, long long& bseg, long long& seg, int& mb) {
    mb = (int)(k % B);
    bseg = cid + (k / B) * ncl;
    seg = mb * (long long)S + bseg;
  };
  auto xsrc = [&](int z, long long seg) { return p.X + (((long long)z * SB + seg) * R + r0) * R; };
  auto zsrc = [&](int z, int j, long long seg) {  // latent z's vector j (0 s, 1 mu, 2 w, 3 v)
    return (j == 0 ? p.s : j == 1 ? p.mu : j == 2 ? p.w : p.v) + z * NL + seg * Tn + t0;
  };
  CY(long long cy[CY_SLOTS] = {}; long long cy0 = clock64(), c1;)
  if (warp == CNT / 32) {  // the producer
    // unit k's inputs into its stage
    auto issue = [&](long long k) {
      long long bseg, seg;
      int mb;
      unit(k, bseg, seg, mb);
      unsigned char* stage = ring + (k % stages) * L.stage;
      stage_spans<T>(2 + 5 * Z, [&](int i, unsigned char*& slot, const T*& src, long long& n) {
        if (i < Z) {
          slot = stage + i * L.X;
          src = xsrc(i, seg);
          n = (long long)xn * R;
        } else if (i == Z) {
          slot = stage + Z * L.X;
          src = p.rows.xb + (bseg * Tn + t0) * Y;
          n = (long long)nr * Y;
        } else {
          const int j = i - Z - 1;  // the mask, then s, mu, w and v of each latent
          slot = stage + Z * L.X + L.rows + j * L.vec;
          src = j == 0 ? p.rows.mask + bseg * Tn + t0 : zsrc((j - 1) >> 2, (j - 1) & 3, seg);
          n = nr;
        }
      }, full + k % stages, lane);
    };
    for (long long k = 0; k < stages && k < nunits; ++k) issue(k);
    cluster_barrier();  // the blocks' G in place
    for (long long k = 0; k < nunits; ++k) {
      cluster_barrier();  // the consumers are done with unit k - 1's stage
      if (k > 0 && k + stages - 1 < nunits) issue(k + stages - 1);
      cluster_barrier();
      cluster_barrier();
    }
    cluster_barrier();
    return;
  }
  // this block's rows of G into shared memory
  for (int i = tid; i < Z * nr * R; i += CNT) {
    const int z = i / (nr * R), rem = i - z * nr * R, tl = rem / R, r = rem - tl * R;
    Gp[(z * L.nr + tl) * RP + r] = __ldg(p.G + ((size_t)z * Tn + t0 + tl) * R + r);
  }
  using Lanes = LaneZ<T, ZT ? ZT : 1>;
  Lanes ln;
  if (ZT) ln.load(p.rows, lane);
  CY(cy[11] = clock64() - cy0;)
  cluster_barrier();  // every block of the cluster is running and has its G
  CY(cy0 = clock64();)
  for (long long k = 0; k < nunits; ++k) {
    long long bseg, seg;
    int mb;
    unit(k, bseg, seg, mb);
    const T* cmr = p.rows.cm ? p.rows.cm + (size_t)mb * Y : nullptr;
    CY(c1 = clock64();)
    bar_wait(full + k % stages, (unsigned)((k / stages) & 1));
    CY(cy[1] += clock64() - c1; cy[4] += 1; c1 = clock64();)
    unsigned char* stage = ring + (k % stages) * L.stage;
    unsigned char* vecs = stage + Z * L.X + L.rows;
    const T* mk = in_slot(vecs, p.rows.mask + bseg * Tn + t0);
    auto zv = [&](int z, int j) {
      return in_slot(vecs + (1 + 4 * z + j) * L.vec, zsrc(z, j, seg));
    };
    // A. this chunk's sums of G's, t in increasing order, into slot q of
    // every block's partA
    for (int o = tid; o < nzr; o += CNT) {
      const int z = o / R, r = o - z * R;
      const T* Gz = Gp + (size_t)z * L.nr * RP + r;
      const T* sz = zv(z, 0);
      T acc = T(0);
#pragma unroll 4
      for (int t = 0; t < nr; ++t) acc = fma_t(Gz[(size_t)t * RP], sz[t], acc);
      for (int c = 0; c < C; ++c) *cluster.map_shared_rank(partA + q * nzr + o, c) = acc;
    }
    CY(cy[5] += clock64() - c1; c1 = clock64();)
    cluster_barrier();
    CY(cy[2] += clock64() - c1; c1 = clock64();)
    // the chunks' sums added in chunk order
    for (int o = tid; o < nzr; o += CNT) {
      T acc = partA[o];
      for (int c = 1; c < C; ++c) acc += partA[c * nzr + o];
      gs[o] = acc;
    }
    consumer_sync();
    CY(cy[3] += clock64() - c1; c1 = clock64();)
    // B. u = G G's - mu and w u on this block's rows, a thread per (z, t)
    for (int o = tid; o < Z * nr; o += CNT) {
      const int z = o / nr, t = o - z * nr;
      const T m = zv(z, 1)[t], wm = zv(z, 2)[t] * mk[t];
      const T u = quad_dot(Gp + ((size_t)z * L.nr + t) * RP, gs + z * R, R) - m;
      uS[z * L.nr + t] = u;
      wuS[z * L.nr + t] = wm * u;
    }
    consumer_sync();
    CY(cy[6] += clock64() - c1; c1 = clock64();)
    // C. this chunk's sums of G'(w u), into slot q of every block's partC
    for (int o = tid; o < nzr; o += CNT) {
      const int z = o / R, r = o - z * R;
      const T* Gz = Gp + (size_t)z * L.nr * RP + r;
      const T* wu = wuS + z * L.nr;
      T acc = T(0);
#pragma unroll 4
      for (int t = 0; t < nr; ++t) acc = fma_t(Gz[(size_t)t * RP], wu[t], acc);
      for (int c = 0; c < C; ++c) *cluster.map_shared_rank(partC + q * nzr + o, c) = acc;
    }
    CY(cy[7] += clock64() - c1; c1 = clock64();)
    cluster_barrier();
    CY(cy[2] += clock64() - c1; c1 = clock64();)
    for (int o = tid; o < nzr; o += CNT) {
      T acc = partC[o];
      for (int c = 1; c < C; ++c) acc += partC[c * nzr + o];
      gwu[o] = acc;
    }
    consumer_sync();
    CY(cy[3] += clock64() - c1; c1 = clock64();)
    // D. this block's rows of X G'(w u), each into every block's M
    for (int o = tid; o < Z * xn; o += CNT) {
      const int z = o / xn, rl = o - z * xn;
      const T* Xr = in_slot(stage + z * L.X, xsrc(z, seg)) + (size_t)rl * R;
      const T m = quad_dot(Xr, gwu + z * R, R);
      for (int c = 0; c < C; ++c) *cluster.map_shared_rank(mv + z * R + r0 + rl, c) = m;
    }
    CY(cy[8] += clock64() - c1; c1 = clock64();)
    cluster_barrier();
    CY(cy[2] += clock64() - c1; c1 = clock64();)
    // E. delta = u - G X G'(w u), clipped and masked; mu + delta
    for (int o = tid; o < Z * nr; o += CNT) {
      const int z = o / nr, t = o - z * nr, i = z * L.nr + t;
      const T acc = quad_dot(Gp + (size_t)i * RP, mv + z * R, R);
      const T d = clip(uS[i] - acc, p.bound) * mk[t];
      uS[i] = d;
      munS[i] = zv(z, 1)[t] + d;
      mvR[t * 2 * Z + z] = munS[i];
      mvR[t * 2 * Z + Z + z] = zv(z, 3)[t];
    }
    consumer_sync();
    CY(cy[9] += clock64() - c1; c1 = clock64();)
    // the weights from the new mu and the old v, a warp a row
    const T* xbS = in_slot(stage + Z * L.X, p.rows.xb + (bseg * Tn + t0) * Y);
    if constexpr (ZT > 0) {
      for (int t = warp; t < nr; t += CNT / 32) {
        T m[ZT], w[ZT];
#pragma unroll
        for (int z = 0; z < ZT; ++z) {
          m[z] = mvR[t * 2 * ZT + z];
          w[z] = mvR[t * 2 * ZT + ZT + z];
        }
        const T sum = row_one<T, false, ZT>(ln, Y, xbS + (size_t)t * Y, nullptr, m, w, mk[t],
                                            cmr, lane);
        const int zq = lane >> 2;
        if ((lane & 3) == 0 && zq < ZT) wuS[zq * L.nr + t] = sum * mk[t];
      }
    } else {
      for (int t = warp; t < nr; t += CNT / 32)
        row_pass<T, false>(p.rows, xbS + (size_t)t * Y, nullptr, mvR + t * 2 * Z,
                           mvR + t * 2 * Z + Z, mk[t], cmr, wuS + t, L.nr, lane);
    }
    consumer_sync();  // the row pass is done
    for (int o = tid; o < Z * nr; o += CNT) {
      const int z = o / nr, t = o - z * nr, i = z * L.nr + t;
      const long long g = z * NL + seg * Tn + t0 + t;
      p.dmu[g] = uS[i];
      p.mu_out[g] = munS[i];
      p.w_out[g] = wuS[i];
    }
    CY(cy[10] += clock64() - c1;)
  }
  CY(cy[0] = clock64() - cy0; if (tid == 0) { cy_put(1, cy, 0, 12); })
  cluster_barrier();  // no block leaves while another may write its shared memory
}

// The kernel of ZT = Z where the register path takes the shape (Z <= ZB,
// Y <= 32 KY), else of ZT = 0.
#define ESTEP_BY_Z(KERNEL, T)                                     \
  if (Y <= 32 * KY) switch (Z) {                                  \
      case 1: return &KERNEL<T, 1>;                               \
      case 2: return &KERNEL<T, 2>;                               \
      case 3: return &KERNEL<T, 3>;                               \
      case 4: return &KERNEL<T, 4>;                               \
      case 5: return &KERNEL<T, 5>;                               \
      case 6: return &KERNEL<T, 6>;                               \
      case 7: return &KERNEL<T, 7>;                               \
      case 8: return &KERNEL<T, 8>;                               \
    }                                                             \
  return &KERNEL<T, 0>;

template <typename T>
auto project_stream_kernel(int Z, int Y) -> decltype(&estep_project_stream_kernel<T, 0>) {
  ESTEP_BY_Z(estep_project_stream_kernel, T)
}
template <typename T>
auto step_stream_kernel(int Z, int Y) -> decltype(&estep_step_stream_kernel<T, 0>) {
  ESTEP_BY_Z(estep_step_stream_kernel, T)
}
template <typename T>
auto step_cluster_kernel(int Z, int Y) -> decltype(&estep_step_cluster_kernel<T, 0>) {
  ESTEP_BY_Z(estep_step_cluster_kernel, T)
}
#undef ESTEP_BY_Z

template <typename T>
cudaError_t launch_project_stream(const RowArgs<T>& p, const void* mu, const void* v, void* s,
                                  int rt, int stages, int grid, cudaStream_t st) {
  if (rt < PW || rt % PW != 0 || stages < 1 || stages > ST_MAX || grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = ProjectLayout<T>(rt, stages, p.Y, p.Z, p.B).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = project_stream_kernel<T>(p.Z, p.Y);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, PNT, smem, st>>>(p, (const T*)mu, (const T*)v, (T*)s, rt, stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step_stream(const StepArgs<T>& p, int groups, int stages, int grid,
                               cudaStream_t st) {
  if (groups < 1 || groups > NG_MAX || stages < 1 || stages > ST_MAX || grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = StepLayout<T>(groups, stages, p.Tn, p.rows.Y, p.rows.Z, p.R).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = step_stream_kernel<T>(p.rows.Z, p.rows.Y);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, groups * GT + 32, smem, st>>>(p, groups, stages);
  return cudaGetLastError();
}

// the cluster path's kernel at one shape, its shared memory and cluster
// attributes set; its launch configuration for `grid` blocks (a multiple
// of C) into cfg
template <typename T>
cudaError_t cluster_config(int Tn, int Y, int Z, int R, int C, int stages, int grid,
                           cudaStream_t st, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr,
                           decltype(&estep_step_cluster_kernel<T, 0>)& kernel) {
  if (C < 2 || C > CL_MAX || C != t_chunks(Tn) || stages < 1 || stages > ST_MAX || grid < C ||
      grid % C != 0)
    return cudaErrorInvalidValue;
  const size_t smem = ClusterLayout<T>(C, stages, Tn, Y, Z, R).total;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  kernel = step_cluster_kernel<T>(Z, Y);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(CNTB);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_step_cluster(const StepArgs<T>& p, int C, int stages, int grid,
                                cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  decltype(&estep_step_cluster_kernel<T, 0>) kernel;
  cudaError_t err = cluster_config<T>(p.Tn, p.rows.Y, p.rows.Z, p.R, C, stages, grid, st, cfg,
                                      attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, kernel, p, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// clusters of C blocks the current device holds at once (0: none fits), or
// -error
template <typename T>
int cluster_resident(int Tn, int Y, int Z, int R, int C, int stages) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  decltype(&estep_step_cluster_kernel<T, 0>) kernel;
  cudaError_t err = cluster_config<T>(Tn, Y, Z, R, C, stages, C, 0, cfg, attr, kernel);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// estep_step's launch on path 0 (block), 1 (stream) or 2 (cluster)
template <typename T>
int step_path(const StepArgs<T>& p, int path, int units, int stages, int grid, cudaStream_t st) {
  switch (path) {
    case 0: return (int)launch_step(p, st);
    case 1: return (int)launch_step_stream(p, units, stages, grid, st);
    case 2: return (int)launch_step_cluster(p, units, stages, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Stage a: y and xb (N, Y), mask (N,), a (Z, Y), mu and v (Z, B, N), pois
// (Y) bytes, noise (Y,), cm (B, Y) or NULL (B = 1), s (Z, B, N) out; N = S
// T base rows shared by the B members, all contiguous, float64 when
// is_double else float32.  The launch plan (ops/estep.py): rows > 0
// streams tiles of `rows` base rows, every member of each, through
// `stages` stages on `grid` persistent blocks; rows = 0 takes the block
// path (a block per member of a tile).
int estep_project(const void* y, const void* xb, const void* mask, const void* a, const void* mu,
                  const void* v, const void* pois, const void* noise, const void* cm, void* s,
                  int N, int Y, int Z, int B, int is_double, int rows, int stages, int grid,
                  void* stream) {
  if (N < 1 || Y < 1 || Z < 1 || Z > ZMAX || B < 1 || (B > 1 && cm == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double) {
    const RowArgs<double> p = row_args<double>(y, xb, mask, a, pois, noise, cm, N, Y, Z, B);
    return (int)(rows ? launch_project_stream(p, mu, v, s, rows, stages, grid, st)
                      : launch_project(p, mu, v, s, st));
  }
  const RowArgs<float> p = row_args<float>(y, xb, mask, a, pois, noise, cm, N, Y, Z, B);
  return (int)(rows ? launch_project_stream(p, mu, v, s, rows, stages, grid, st)
                    : launch_project(p, mu, v, s, st));
}

// Stages b and c: G (Z, T, R), s, mu, w and v (Z, B S, T), X (Z, B S, R,
// R), mask (S, T), a (Z, Y), xb (S, T, Y), pois (Y) bytes, noise (Y,), cm
// (B, Y) or NULL (B = 1); mu_out, dmu and w_out (Z, B S, T) out, all
// contiguous, float64 when is_double else float32; segment b S + s is
// member b's base segment s.  The launch plan: path 1 streams segments
// through `stages` stages on `grid` persistent blocks of `units` consumer
// groups with G resident; path 2 runs grid / units persistent clusters of
// units = t_chunks(T) blocks, each block one chunk of t with its rows of G
// resident; path 0 takes the block path (a block per segment).
int estep_step(const void* G, const void* s, const void* mu, const void* w, const void* X,
               const void* mask, const void* a, const void* xb, const void* v, const void* pois,
               const void* noise, const void* cm, void* mu_out, void* dmu, void* w_out, int S,
               int T, int Y, int Z, int R, int B, double dmu_bound, int is_double, int path,
               int units, int stages, int grid, void* stream) {
  if (S < 1 || T < 1 || Y < 1 || Z < 1 || Z > ZMAX || R < 1 || R > RMAX || B < 1 ||
      (B > 1 && cm == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long N = (long long)S * T;
  const int zg = latent_group(Z, R, T);
  if (is_double) {
    StepArgs<double> p{row_args<double>(nullptr, xb, mask, a, pois, noise, cm, N, Y, Z, B),
                       (const double*)G, (const double*)s, (const double*)mu, (const double*)w,
                       (const double*)X, (const double*)v, (double*)mu_out, (double*)dmu,
                       (double*)w_out, S, T, R, zg, dmu_bound};
    return step_path(p, path, units, stages, grid, st);
  }
  StepArgs<float> p{row_args<float>(nullptr, xb, mask, a, pois, noise, cm, N, Y, Z, B),
                    (const float*)G, (const float*)s, (const float*)mu, (const float*)w,
                    (const float*)X, (const float*)v, (float*)mu_out, (float*)dmu,
                    (float*)w_out, S, T, R, zg, (float)dmu_bound};
  return step_path(p, path, units, stages, grid, st);
}

// Shared memory in bytes of a path with a launch plan, as the kernels lay
// it out (at most INT_MAX): kind 0 estep_project's streaming path (a =
// rows, b = stages, B members), kind 1 estep_step's streaming path (a =
// groups, b = stages), kind 2 its cluster path (a = blocks of a cluster,
// b = stages); ops/estep.py plans with its own copy of the layouts, and
// chip_smoke.py holds the two equal.
int estep_smem(int kind, int T, int Y, int Z, int R, int B, int is_double, int a, int b) {
  size_t bytes = 0;
  if (kind == 0)
    bytes = is_double ? ProjectLayout<double>(a, b, Y, Z, B).total
                      : ProjectLayout<float>(a, b, Y, Z, B).total;
  else if (kind == 1)
    bytes = is_double ? StepLayout<double>(a, b, T, Y, Z, R).total
                      : StepLayout<float>(a, b, T, Y, Z, R).total;
  else
    bytes = is_double ? ClusterLayout<double>(a, b, T, Y, Z, R).total
                      : ClusterLayout<float>(a, b, T, Y, Z, R).total;
  return bytes < (size_t)INT_MAX ? (int)bytes : INT_MAX;
}

// Clusters of estep_step's cluster path (C blocks, `stages` stages) that the
// current device holds at once at this shape (0: none fits; below 0: a CUDA
// error).  ops/estep.py reads it once a shape, outside any capture, and
// launches that many clusters at most.
int estep_cluster_resident(int T, int Y, int Z, int R, int is_double, int C, int stages) {
  if (T < 1 || Y < 1 || Z < 1 || Z > ZMAX || R < 1 || R > RMAX) return -(int)cudaErrorInvalidValue;
  return is_double ? cluster_resident<double>(T, Y, Z, R, C, stages)
                   : cluster_resident<float>(T, Y, Z, R, C, stages);
}

// The cycle counts of `which` (0 estep_project, 1 estep_step) into the host
// buffer out (CY_BLOCKS x CY_SLOTS 64-bit values); reset = 1 zeroes them.
// A build without -DESTEP_CYCLES counts nothing and returns
// cudaErrorNotSupported.
int estep_cycles(int which, void* out, int reset) {
#ifdef ESTEP_CYCLES
  const size_t bytes = sizeof(unsigned long long) * CY_BLOCKS * CY_SLOTS;
  if (reset) {
    static unsigned long long zero[CY_BLOCKS * CY_SLOTS];
    return (int)cudaMemcpyToSymbol(g_cycles, zero, bytes, which * bytes);
  }
  return (int)cudaMemcpyFromSymbol(out, g_cycles, bytes, which * bytes);
#else
  (void)which, (void)out, (void)reset;
  return (int)cudaErrorNotSupported;
#endif
}

}  // extern "C"
