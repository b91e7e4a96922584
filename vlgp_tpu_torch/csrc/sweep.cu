// The whole E-step in one cooperative launch, for Hopper: replaces
// vlgp_tpu/ops/sweep.py:_sweep_pallas (kernel body _make_sweep_kernel).
//
// The function.  The segments form exit groups of `bs` (16 at the flagship
// E-step), all Z latents inside; each group runs its own Newton sweeps:
//
//   initial   M = I + G'WG from the masked weights, X refined warm from the
//             carry (ns_warm_iters) or cold (ns_iters);
//   per sweep (i < niter, and with tol > 0: i < 2 or |dmu|^2 > tol^2 |mu|^2
//             on the group's own norms of its last sweep)
//     a. eta = xb + sum_z mu_z a_z, r = exp(min(eta + sum_z v_z a2_z, 10)),
//        resid = pois (y - r) + (1 - pois)(y - eta) invn, masked,
//        s_z = resid . a_z
//     b. u = G G's - mu, delta = u - G X G'(w u), clipped to dmu_bound and
//        masked; mu += delta
//     c. w_z = sum_y (pois r + (1 - pois) invn) a_z^2, masked, with r from
//        the new mu and the OLD v
//     d. Gram + warm Newton-Schulz refine of every (z, segment) matrix and,
//        under VB, v = diag(G X G'), masked, from the refined X.
//
// Every refine is residual-checked per group, as the TPU kernel does: while
// the group's worst residual is not below 1e-2, up to two more passes of
// ns_iters rounds; a warm refine that still fails restarts the group cold
// (not for the initial no-carry refine, which already started cold), with
// its own two escalations.  Zeros, vem's first carry, are a Newton-Schulz
// fixed point that only this restart escapes.  Per group the kernel writes
// its worst final residual and its counts (sweeps, refine passes, rounds).
//
// Design: one cooperative launch of a persistent grid, with a grid sync
// between stages.  Blocks have tiled_threads(R) threads (128 at R = 40,
// 1024 at R = 128), and the grid is as many as fit on every SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor: 8 per SM at R = 40 with
// ns_gram's 27.7 KB, 1 at R = 128), capped at the Z S matrices.  Stages
// a-c of a segment touch that segment alone, so one block takes a whole
// segment (segment_stage): xb, y, mu, v, a and a2 copied to shared memory by
// cp.async, every latent at once, no sync between a, b and c.  A refine
// pass takes one block per matrix, on the register-tiled routines of
// ns_common.cuh (as ns_gram: Mt, X, Xt padded in shared memory, v from the
// X the block holds).  In a sweep where every block has a live segment, the
// block refines its segment's Z matrices right after its stages a-c
// (segments, `fused`), so blocks drift apart and latency-bound stages a-c
// overlap Newton-Schulz products on each SM; in a sweep of a few groups the
// segment stages run alone and the refine spreads their matrices over the
// grid.  An escalation or restart pass, and its sync, runs only when some
// group needs it, and the launch ends when no group is live.
//
// Group decisions without atomics or an owner: after each sync every block
// takes each group's decision itself, from per-matrix residuals (rmat) or
// per-segment norms (npart) in device memory, reducing the group's values
// in one fixed order: every block reaches the same bits, so every branch
// and grid sync is grid-uniform, and the order does not depend on the grid.
// Pass k writes the residuals of parity k & 1, and sweep i the norms of
// parity i & 1, so a block still reading pass k's (sweep i's) while another
// has begun pass k + 1 (sweep i + 1) reads consistent values.  Block 0
// alone keeps the outputs resid and counts (and rlast, each group's last
// residual).  Data written by one block and read by another within the
// launch (mu, w, v, dmu, X, rmat, npart) is never read through the
// read-only path.  No atomics: repeated runs give the same bits.  Every
// product is a full float32 FMA (the TPU's bf16x3 split is not carried
// over).
//
// What bounds it on this card (NVIDIA H100 80GB HBM3, 700 W, Z5 S2000 T50
// Y100 R40, real carry, tol 3e-3: 8-9 ms, against a 1.6 ms FP32 bound):
// the refine passes, ~0.75 M FMAs per matrix and pass (Gram, 4 warm
// rounds, residual, v) from shared memory, at ns_gram's rate (its warm 4 +
// v takes 0.72 ms over the same 10,000 matrices); then the segment stages,
// which are latency-bound: a chain of dependent shared-memory and L2 reads
// per step.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "ns_common.cuh"

namespace {

using namespace vlgp;
namespace cg = cooperative_groups;

constexpr int NT_MAX = 1024;       // threads of a block at R = 128
constexpr float EXP_BOUND = 10.f;  // vlgp_tpu/ops/math.py:trunc_exp
constexpr int RB = 4;              // rows a thread of the segment stage takes at once

// stats, block 0's record of the launch when asked for: grid syncs, blocks,
// blocks per SM
enum Stat { SYNCS, BLOCKS, BLOCKS_PER_SM, STATS };

struct SweepArgs {
  const float* y;      // (S, T, Y)
  const float* xb;     // (S, T, Y)
  const float* mask;   // (S, T)
  const float* a;      // (Z, Y)
  const float* a2;     // (Z, Y) = 0.5 a a
  const float* pois;   // (Y) 1 for Poisson channels, 0 for Gaussian
  const float* invn;   // (Y) 1 / max(noise, 1e-30)
  const float* G;      // (Z, T, R)
  float* mu;           // (Z, S, T) in/out
  float* w;            // (Z, S, T) in/out (masked by the kernel)
  float* v;            // (Z, S, T) in/out
  float* dmu;          // (Z, S, T) out (zeros in)
  float* X;            // (Z, S, R, R) in (the carry, when has_x) / out
  float* rmat;         // (2, S / bs, Z, bs) scratch: residual per matrix and parity
  float* npart;        // (2, S, 2) scratch: |delta|^2, |mu|^2 per sweep parity and segment
  float* rlast;        // (S / bs) scratch: each group's last residual
  float* resid;        // (S / bs) worst residual per group
  int* counts;         // (S / bs, 3) sweeps, refine passes, NS rounds
  long long* stats;    // (STATS) block 0's record of the launch, see Stat, or null
  int S, T, Y, Z, R, bs;
  int niter, adaptive;
  float tol2, dmu_bound;
  int ns_iters, ns_warm_iters, vb, has_x, bpsm;
};

// NaN-propagating min(x, EXP_BOUND), as jnp.minimum
__device__ __forceinline__ float exp_clip(float x) {
  return expf((x < EXP_BOUND || x != x) ? x : EXP_BOUND);
}

// NaN-propagating clip to [-b, b], as jnp.clip
__device__ __forceinline__ float clip(float x, float b) {
  return x < -b ? -b : (x > b ? b : x);
}

// A grid sync, counted by block 0 (stats).
__device__ __forceinline__ void counted_sync(const SweepArgs& p, cg::grid_group& grid) {
  grid.sync();
  if (p.stats && blockIdx.x == 0 && threadIdx.x == 0) p.stats[SYNCS] += 1;
}

__device__ __forceinline__ bool has_bit(const unsigned* bits, int g) {
  return (bits[g >> 5] >> (g & 31)) & 1u;
}

// Row stride of the segment stage's xb and y rows: Y rounded up to an odd
// number of 16-byte words, so rows are 16-byte aligned and the float4 reads
// of eight consecutive rows fall in distinct banks.
__host__ __device__ inline int row_stride(int Y) { return 4 * (((Y + 3) / 4) | 1); }

// Floats of the shared region: the refine's Mt, X, Xt (4 nb x ld each), G
// chunk (TC x 4 nb), weights (TC), partial sums of v (nb x TC) and one float
// per warp, as ns_gram; or the segment stage's mu, v, s and u (Z x T each),
// the mask (T), three Z x R vectors, a and a2 (Z x Y) and at least one row
// each of xb and y (stride row_stride(Y)), whichever is more.  The group bit
// sets follow it (ops/sweep.py:_sweep_smem_bytes).
__host__ __device__ inline int region_floats(int Z, int T, int Y, int R) {
  const int nb = tiles_per_side(R), nwarp = tiled_threads(R) / 32;
  const int ns = 3 * 4 * nb * padded_ld(R) + TC * 5 * nb + TC + nwarp;
  const int seg = 4 * Z * T + T + 3 * Z * R + 2 * Z * Y + 2 * row_stride(Y);
  return ns > seg ? ns : seg;
}

struct Smem {
  float *Mt, *X, *Xt, *Gc, *wc, *part, *red;
  unsigned *live, *set;  // bit g: group g is live this sweep / in this pass
  int ld, n, nwords, region;
};

__device__ Smem layout(const SweepArgs& p, float* base) {
  Smem s;
  const int nb = tiles_per_side(p.R);
  s.ld = padded_ld(p.R);
  s.n = 4 * nb * s.ld;
  s.Mt = base;
  s.X = s.Mt + s.n;
  s.Xt = s.X + s.n;
  s.Gc = s.Xt + s.n;
  s.wc = s.Gc + TC * 4 * nb;
  s.part = s.wc + TC;
  s.red = s.part + TC * nb;
  s.region = region_floats(p.Z, p.T, p.Y, p.R);
  s.nwords = (p.S / p.bs + 31) / 32;
  s.live = reinterpret_cast<unsigned*>(base + s.region);
  s.set = s.live + s.nwords;
  return s;
}

// Stages a (PROJECT: s_z = resid . a_z into out, Z x T in shared memory)
// and c (w_z = U . a_z^2, masked, into w) for one segment, by the block,
// per chunk of tch rows: xb (and y) copied to shared memory by cp.async,
// all in flight at once; every (t, y) entry of the predictor at muS, vS
// (Z x T), in place of xb; then each (z, t) sum over y, as four chains (y
// mod 4) added in a fixed order.  A thread takes one column y of every
// nph-th row (nph = nt / Y phases when Y < nt), RB rows at once, so its
// channel factors load once and no index is divided per entry.
template <bool PROJECT>
__device__ void segment_rows(const SweepArgs& p, int seg, const float* muS, const float* vS,
                             const float* aS, const float* a2S, const float* mk, float* xbuf,
                             float* ybuf, int ys, int tch, float* out) {
  const int T = p.T, Y = p.Y, Z = p.Z, tid = threadIdx.x, nt = blockDim.x;
  const int nph = nt > Y ? nt / Y : 1;
  for (int t0 = 0; t0 < T; t0 += tch) {
    const int tc = min(tch, T - t0);
    const size_t off = ((size_t)seg * T + t0) * Y;
    if (Y % 4 == 0) {  // 16-byte copies
      const int Y4 = Y / 4;
      for (int e = tid; e < tc * Y4; e += nt) {
        const int tt = e / Y4, k = tt * ys + 4 * (e - tt * Y4);
        __pipeline_memcpy_async(xbuf + k, p.xb + off + 4 * e, 16);
        if (PROJECT) __pipeline_memcpy_async(ybuf + k, p.y + off + 4 * e, 16);
      }
    } else {
      for (int u = tid; u < nph * Y; u += nt) {
        const int ph = u / Y, yy = u - ph * Y;
        for (int tt = ph; tt < tc; tt += nph) {
          __pipeline_memcpy_async(xbuf + tt * ys + yy, p.xb + off + tt * Y + yy, sizeof(float));
          if (PROJECT)
            __pipeline_memcpy_async(ybuf + tt * ys + yy, p.y + off + tt * Y + yy, sizeof(float));
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int u = tid; u < nph * Y; u += nt) {
      const int ph = u / Y, yy = u - ph * Y;
      const float pz = __ldg(p.pois + yy), inv = __ldg(p.invn + yy);
      for (int tt0 = ph; tt0 < tc; tt0 += RB * nph) {  // RB rows at once, RB chains in flight
        float eta[RB], arg[RB];
        int t[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const int tt = tt0 + i * nph;
          t[i] = t0 + (tt < tc ? tt : tt0);  // a row past the chunk repeats tt0, unused
          eta[i] = xbuf[(t[i] - t0) * ys + yy];
          arg[i] = 0.f;
        }
        for (int z = 0; z < Z; ++z) {
          const float az = aS[z * Y + yy], a2z = a2S[z * Y + yy];
#pragma unroll
          for (int i = 0; i < RB; ++i) {
            eta[i] = fmaf(muS[z * T + t[i]], az, eta[i]);
            arg[i] = fmaf(vS[z * T + t[i]], a2z, arg[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (tt0 + i * nph >= tc) break;
          const int k = (t[i] - t0) * ys + yy;
          const float r = exp_clip(eta[i] + arg[i]);
          if (PROJECT) {
            const float yv = ybuf[k];
            xbuf[k] = (pz * (yv - r) + (1.f - pz) * (yv - eta[i]) * inv) * mk[t[i]];
          } else {
            xbuf[k] = pz * r + (1.f - pz) * inv;
          }
        }
      }
    }
    __syncthreads();
    for (int o = tid; o < Z * tc; o += nt) {
      const int z = o / tc, tt = o - z * tc, t = t0 + tt;
      const float* rw = xbuf + tt * ys;
      const float* az = (PROJECT ? aS : a2S) + z * Y;
      const float f = PROJECT ? 1.f : 2.f;
      float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains, y mod 4, summed in order
      int yy = 0;
      if (Y % 4 == 0) {  // 16-byte reads of the row and of a
        for (; yy < Y; yy += 4) {
          const float4 x = *reinterpret_cast<const float4*>(rw + yy);
          const float4 w4 = *reinterpret_cast<const float4*>(az + yy);
          part[0] = fmaf(x.x, f * w4.x, part[0]);
          part[1] = fmaf(x.y, f * w4.y, part[1]);
          part[2] = fmaf(x.z, f * w4.z, part[2]);
          part[3] = fmaf(x.w, f * w4.w, part[3]);
        }
      }
      for (; yy + 4 <= Y; yy += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) part[j] = fmaf(rw[yy + j], f * az[yy + j], part[j]);
      }
      for (; yy < Y; ++yy) part[0] = fmaf(rw[yy], f * az[yy], part[0]);
      const float acc = (part[0] + part[1]) + (part[2] + part[3]);
      if (PROJECT) out[z * T + t] = acc;
      else p.w[((size_t)z * p.S + seg) * T + t] = acc * mk[t];
    }
    __syncthreads();  // the buffers are free for the next chunk
  }
}

// Stages a-c of one segment of a live group, by the whole block, every
// latent at once: a. s_z; b. the Woodbury step u = G G's - mu, delta = u -
// G X G'(w u), clipped and masked, mu += delta (mu, dmu to device memory),
// and the segment's |delta|^2 and |mu|^2 to norms[2 seg], norms[2 seg + 1]
// (per latent a warp sum over t, then the latents in order); c. w from the
// new mu and the old v.
// The sums of stage b run over their index in increasing order.  Out of
// line, so that its registers do not add to the refine's; it lays out the
// kernel's shared region its own way.
__device__ __noinline__ void segment_stage(const SweepArgs& p, int seg, int region,
                                           float* norms) {
  extern __shared__ float4 sm4[];  // the kernel's shared region
  const int T = p.T, Y = p.Y, Z = p.Z, R = p.R, S = p.S, ZT = Z * T, ZR = Z * R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ys = row_stride(Y);
  const int tch = min(T, (region - 4 * ZT - 3 * ZR - 2 * Z * Y - T) / (2 * ys));
  float* aS = reinterpret_cast<float*>(sm4);  // Z x Y; 16-byte aligned when Y % 4 == 0
  float* a2S = aS + Z * Y;
  float* xbuf = a2S + Z * Y;  // tch x ys
  float* ybuf = xbuf + tch * ys;
  float* muS = ybuf + tch * ys;  // Z x T
  float* vS = muS + ZT;
  float* sS = vS + ZT;  // s, then w
  float* uS = sS + ZT;  // u, then delta
  float* gts = uS + ZT;  // Z x R
  float* gwu = gts + ZR;
  float* mv = gwu + ZR;
  float* mk = mv + ZR;  // T
  __syncthreads();  // the region's earlier users are done
  for (int i = tid; i < ZT; i += nt) {
    const int z = i / T;
    const size_t idx = ((size_t)z * S + seg) * T + i - z * T;
    __pipeline_memcpy_async(muS + i, p.mu + idx, sizeof(float));
    __pipeline_memcpy_async(vS + i, p.v + idx, sizeof(float));
  }
  for (int i = tid; i < Z * Y; i += nt) {
    __pipeline_memcpy_async(aS + i, p.a + i, sizeof(float));
    __pipeline_memcpy_async(a2S + i, p.a2 + i, sizeof(float));
  }
  for (int t = tid; t < T; t += nt)
    __pipeline_memcpy_async(mk + t, p.mask + (size_t)seg * T + t, sizeof(float));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  segment_rows<true>(p, seg, muS, vS, aS, a2S, mk, xbuf, ybuf, ys, tch, sS);
  for (int o = tid; o < ZR; o += nt) {  // G' s
    const int z = o / R, r = o - z * R;
    const float* Gz = p.G + (size_t)z * T * R;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t) acc = fmaf(__ldg(Gz + t * R + r), sS[z * T + t], acc);
    gts[o] = acc;
  }
  __syncthreads();
  for (int o = tid; o < ZT; o += nt) {  // u = G G's - mu; w in place of s
    const int z = o / T, t = o - z * T;
    const float* Gt = p.G + ((size_t)z * T + t) * R;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) acc = fmaf(__ldg(Gt + r), gts[z * R + r], acc);
    uS[o] = acc - muS[o];
    sS[o] = p.w[((size_t)z * S + seg) * T + t];
  }
  __syncthreads();
  for (int o = tid; o < ZR; o += nt) {  // G' (w u)
    const int z = o / R, r = o - z * R;
    const float* Gz = p.G + (size_t)z * T * R;
    float acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < T; ++t)
      acc = fmaf(__ldg(Gz + t * R + r), sS[z * T + t] * uS[z * T + t], acc);
    gwu[o] = acc;
  }
  __syncthreads();
  for (int o = tid; o < ZR; o += nt) {  // X G'(w u)
    const int z = o / R, r = o - z * R;
    const float* Xr = p.X + (((size_t)z * S + seg) * R + r) * R;
    const float* gw = gwu + z * R;
    float acc = 0.f;
    if (R % 4 == 0) {  // rows 16-byte aligned: every load of the row in flight at once
      for (int q = 0; q < R; q += 4) {
        const float4 x = *reinterpret_cast<const float4*>(Xr + q);
        acc = fmaf(x.x, gw[q], acc);
        acc = fmaf(x.y, gw[q + 1], acc);
        acc = fmaf(x.z, gw[q + 2], acc);
        acc = fmaf(x.w, gw[q + 3], acc);
      }
    } else {
      for (int q = 0; q < R; ++q) acc = fmaf(Xr[q], gw[q], acc);
    }
    mv[o] = acc;
  }
  __syncthreads();
  for (int o = tid; o < ZT; o += nt) {  // delta = u - G X G'(w u)
    const int z = o / T, t = o - z * T;
    const float* Gt = p.G + ((size_t)z * T + t) * R;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < R; ++r) acc = fmaf(__ldg(Gt + r), mv[z * R + r], acc);
    const float d = clip(uS[o] - acc, p.dmu_bound) * mk[t];
    const float mn = muS[o] + d;
    uS[o] = d;
    muS[o] = mn;
    const size_t idx = ((size_t)z * S + seg) * T + t;
    p.dmu[idx] = d;
    p.mu[idx] = mn;
  }
  __syncthreads();
  const int lane = tid & 31;
  for (int z = tid >> 5; z < Z; z += nt >> 5) {  // the norms, one warp per latent
    float d2 = 0.f, m2 = 0.f;
    for (int t = lane; t < T; t += 32) {
      d2 = fmaf(uS[z * T + t], uS[z * T + t], d2);
      m2 = fmaf(muS[z * T + t], muS[z * T + t], m2);
    }
    d2 = warp_sum(d2);
    m2 = warp_sum(m2);
    if (lane == 0) {
      gwu[2 * z] = d2;  // gwu and mv (2 Z R >= 2 Z floats), free since the delta step
      gwu[2 * z + 1] = m2;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float d2 = 0.f, m2 = 0.f;
    for (int z = 0; z < Z; ++z) {
      d2 += gwu[2 * z];
      m2 += gwu[2 * z + 1];
    }
    norms[2 * (size_t)seg] = d2;
    norms[2 * (size_t)seg + 1] = m2;
  }
  segment_rows<false>(p, seg, muS, vS, aS, a2S, mk, xbuf, ybuf, ys, tch, nullptr);
}


// One matrix (z, seg) of a refine pass: M from G and w, X cold or from the
// X in device memory, `iters` rounds, X stored, its residual to *rout and,
// with want_v, v = diag(G X G') masked.  The pad of X and Xt is zero on
// entry (refine_pass).
__device__ void refine_matrix(const SweepArgs& p, const Smem& s, int z, int seg, bool cold,
                              int iters, bool want_v, float* rout) {
  const int R = p.R, T = p.T, RR = R * R, ld = s.ld;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t zs = (size_t)z * p.S + seg;
  const float* Gz = p.G + (size_t)z * T * R;
  float* Xg = p.X + zs * RR;
  gram_build_tiled(Gz, p.w + zs * T, T, R, ld, s.Mt, s.Gc, s.wc);
  if (cold) {
    for (int i = tid; i < 2 * s.n; i += nt) s.X[i] = 0.f;  // X and Xt
    __syncthreads();
    ns_cold_start_tiled(s.Mt, s.X, s.Xt, R, ld, s.red);
  } else {
    for (int i = tid; i < RR; i += nt) {
      const int r = i / R, q = i - r * R;
      const float x = Xg[i];
      s.X[r * ld + q] = x;
      s.Xt[q * ld + r] = x;
    }
  }
  __syncthreads();
  ns_iterate_tiled(s.Mt, s.X, s.Xt, R, ld, iters);
  const float res = ns_residual_tiled(s.Mt, s.X, R, ld, s.red);
  for (int i = tid; i < RR; i += nt) {
    const int r = i / R;
    Xg[i] = s.X[r * ld + i - r * R];
  }
  if (tid == 0) *rout = res;
  if (want_v) {
    float* v = p.v + zs * T;
    marginal_v_tiled(Gz, s.X, T, R, ld, s.Gc, s.part, v);
    __syncthreads();  // v is complete
    const float* mk = p.mask + (size_t)seg * T;
    for (int t = tid; t < T; t += nt) v[t] *= __ldg(mk + t);
  }
}

// One refine pass over the matrices of the groups in s.set, one block per
// matrix, grid-strided in group-major order (so a group's matrices spread
// over consecutive blocks); residuals to rmat of parity `par`.
__device__ void refine_pass(const SweepArgs& p, const Smem& s, int par, bool cold, int iters,
                            bool want_v) {
  const int ZB = p.Z * p.bs, nmat = p.Z * p.S;
  float* rm = p.rmat + (size_t)par * nmat;
  bool zeroed = false;
  for (int m = blockIdx.x; m < nmat; m += gridDim.x) {
    const int g = m / ZB, k = m - g * ZB;
    if (!has_bit(s.set, g)) continue;
    if (!zeroed) {  // the stages before left the region dirty: zero the pads
      for (int i = threadIdx.x; i < 3 * s.n; i += blockDim.x) s.Mt[i] = 0.f;
      zeroed = true;  // gram_build_tiled's first barrier orders it
    }
    refine_matrix(p, s, k / p.bs, g * p.bs + k % p.bs, cold, iters, want_v, rm + m);
  }
}

// Stages a-c of sweep i for every segment of the live groups, one block per
// segment, grid-strided, norms to npart of parity i & 1.  With `fused`, the
// block then runs the first refine pass of
// the segment's Z matrices (warm, ns_warm_iters rounds) itself, residuals to
// rmat of parity `par`: with a segment on every block, blocks drift apart,
// and one block's latency-bound stages a-c overlap another's Newton-Schulz
// products on the same SM.
__device__ void segments(const SweepArgs& p, const Smem& s, int i, bool fused, int par,
                         bool want_v) {
  const int ZB = p.Z * p.bs;
  float* rm = p.rmat + (size_t)par * p.Z * p.S;
  float* norms = p.npart + (size_t)(i & 1) * 2 * p.S;
  for (int seg = blockIdx.x; seg < p.S; seg += gridDim.x) {
    const int g = seg / p.bs, j = seg - g * p.bs;
    if (!has_bit(s.live, g)) continue;
    segment_stage(p, seg, s.region, norms);
    if (!fused) continue;
    for (int i = threadIdx.x; i < 3 * s.n; i += blockDim.x) s.Mt[i] = 0.f;  // the pads
    for (int z = 0; z < p.Z; ++z)
      refine_matrix(p, s, z, seg, false, p.ns_warm_iters, want_v,
                    rm + (size_t)g * ZB + z * p.bs + j);
  }
}

// After a pass of parity `par` (taken after a grid sync): s.set <- the
// groups of s.set whose worst residual (NaN-propagating max of their Z bs
// matrices) is not below RESID_TOL.  Block 0 books the pass (passes,
// rounds) and each group's residual.  Returns whether the set is nonempty;
// block-uniform, and the same in every block.
__device__ bool after_pass(const SweepArgs& p, const Smem& s, int par, int iters) {
  const int ZB = p.Z * p.bs, ngrp = p.S / p.bs;
  const float* rm = p.rmat + (size_t)par * p.Z * p.S;
  int any = 0;
  for (int g0 = 0; g0 < ngrp; g0 += blockDim.x) {
    const int g = g0 + threadIdx.x;
    bool fail = false;
    if (g < ngrp && has_bit(s.set, g)) {
      const float4* q = reinterpret_cast<const float4*>(rm + (size_t)g * ZB);
      float r = 0.f;
#pragma unroll 4
      for (int k = 0; k < ZB / 4; ++k) {  // 16-byte loads: bs % 4 == 0
        const float4 v = q[k];
        r = nanmax(nanmax(nanmax(nanmax(r, v.x), v.y), v.z), v.w);
      }
      fail = !(r < RESID_TOL);
      if (blockIdx.x == 0) {
        p.rlast[g] = r;
        p.counts[3 * g + 1] += 1;
        p.counts[3 * g + 2] += iters;
      }
    }
    const unsigned b = __ballot_sync(0xffffffffu, fail);
    const int word = (g0 >> 5) + (threadIdx.x >> 5);
    if ((threadIdx.x & 31) == 0 && word < s.nwords) s.set[word] = b;
    any |= fail;
  }
  return __syncthreads_or(any);
}

// At the top of sweep i: s.live <- the groups that sweep.  With the
// adaptive exit, from sweep 2 on, a group sweeps if it swept in sweep i - 1
// and its |delta|^2 and |mu|^2 of that sweep (npart of parity (i - 1) & 1),
// summed over its bs segments in order, say so; a group that has stopped
// keeps its last norms, so it stays stopped.  Block 0 counts the sweep.
// Returns whether any group sweeps.
__device__ bool sweep_live(const SweepArgs& p, const Smem& s, int i) {
  const int ngrp = p.S / p.bs;
  const float* norms = p.npart + (size_t)((i - 1) & 1) * 2 * p.S;
  int any = 0;
  for (int g0 = 0; g0 < ngrp; g0 += blockDim.x) {
    const int g = g0 + threadIdx.x;
    bool live = false;
    if (g < ngrp) {
      if (!p.adaptive || i < 2) {
        live = true;
      } else if (has_bit(s.live, g)) {  // each warp reads the word it then rewrites
        const float4* q = reinterpret_cast<const float4*>(norms + 2 * (size_t)g * p.bs);
        float nd = 0.f, nm = 0.f;
#pragma unroll 4
        for (int k = 0; k < p.bs / 2; ++k) {  // two segments per 16-byte load
          const float4 v = q[k];
          nd += v.x;
          nm += v.y;
          nd += v.z;
          nm += v.w;
        }
        live = nd > p.tol2 * nm;
      }
      if (live && blockIdx.x == 0) p.counts[3 * g] += 1;
    }
    const unsigned b = __ballot_sync(0xffffffffu, live);
    const int word = (g0 >> 5) + (threadIdx.x >> 5);
    if ((threadIdx.x & 31) == 0 && word < s.nwords) s.live[word] = b;
    any |= live;
  }
  return __syncthreads_or(any);
}

// The residual-checked refine of every matrix of the live groups (s.live):
// a first pass, up to two escalations of ns_iters rounds while a group's
// residual is not below 1e-2 (vlgp_tpu/ops/sweep.py:165-183), then, for a
// warm refine, a cold restart of the groups that still fail, with its own
// two escalations (:185-204).  Each pass ends in a grid sync; a pass that
// no group needs is not run.  Block 0 then folds each live group's last
// residual into its worst.  (One loop over the passes, so the refine's
// code, and its registers, exist once.)
__device__ void ns_refine(const SweepArgs& p, const Smem& s, cg::grid_group& grid, int& par,
                          bool cold, int iters, bool was_warm, bool want_v, bool first_done) {
  for (int k = threadIdx.x; k < s.nwords; k += blockDim.x) s.set[k] = s.live[k];
  __syncthreads();
  // step 0: first pass (run by segments when first_done); 1, 2: escalations;
  // 3: cold restart; 4, 5: its escalations
  for (int step = 0;; ++step) {
    if (step > 0 || !first_done) {
      refine_pass(p, s, par, cold, iters, want_v);
      counted_sync(p, grid);
    }
    const bool any = after_pass(p, s, par, iters);
    par ^= 1;
    if (!any || step == 5 || (step == 2 && !was_warm)) break;
    cold = step == 2;
    iters = p.ns_iters;
  }
  if (blockIdx.x == 0) {
    for (int g = threadIdx.x; g < p.S / p.bs; g += blockDim.x)
      if (has_bit(s.live, g)) p.resid[g] = nanmax(p.resid[g], p.rlast[g]);
  }
}

__global__ void __launch_bounds__(NT_MAX) sweep_kernel(const __grid_constant__ SweepArgs p) {
  extern __shared__ float4 sm4[];
  cg::grid_group grid = cg::this_grid();
  const Smem s = layout(p, reinterpret_cast<float*>(sm4));
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ngrp = p.S / p.bs;
  int par = 0;

  if (blockIdx.x == 0) {
    for (int g = tid; g < ngrp; g += nt) {
      p.resid[g] = 0.f;
      p.counts[3 * g] = p.counts[3 * g + 1] = p.counts[3 * g + 2] = 0;
    }
    if (tid == 0 && p.stats) {
      p.stats[SYNCS] = 0;
      p.stats[BLOCKS] = gridDim.x;
      p.stats[BLOCKS_PER_SM] = p.bpsm;
    }
  }
  // the kernel masks w itself (vlgp_tpu/ops/sweep.py:243)
  const size_t ST = (size_t)p.S * p.T, n = ST * p.Z;
  for (size_t i = (size_t)blockIdx.x * nt + tid; i < n; i += (size_t)gridDim.x * nt)
    p.w[i] *= __ldg(p.mask + i % ST);
  for (int k = tid; k < s.nwords; k += nt) {  // every group takes the initial refine
    const int left = ngrp - 32 * k;
    s.live[k] = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  }
  counted_sync(p, grid);

  // i = -1 is the initial refine: warm from the carry, or cold; no v.  A
  // sweep with a live segment for every block runs its first refine pass
  // inside the segment stage (segments); a sweep of a few groups spreads
  // their matrices over the grid instead (measured: NVIDIA H100 80GB HBM3,
  // 700 W, 0.80 against 1.65 ms at S32, 8.33 against 8.47 ms at S2000)
  for (int i = -1; i < p.niter; ++i) {
    bool fused = false;
    if (i >= 0) {
      if (!sweep_live(p, s, i)) break;
      int live = 0;
      for (int k = 0; k < s.nwords; ++k) live += __popc(s.live[k]);
      fused = live * p.bs >= (int)gridDim.x;
      segments(p, s, i, fused, par, p.vb != 0);
      counted_sync(p, grid);
    }
    const bool cold = i < 0 && !p.has_x;
    ns_refine(p, s, grid, par, cold, cold ? p.ns_iters : p.ns_warm_iters, !cold,
              i >= 0 && p.vb, fused);
  }
}

}  // namespace

extern "C" {

// y, xb (S,T,Y); mask (S,T); a, a2 (Z,Y); pois, invn (Y); G (Z,T,R);
// mu, w, v, dmu (Z,S,T); X (Z,S,R,R); rmat (2 Z S,); npart (4 S,); rlast,
// resid (S/bs,); counts (S/bs, 3) int32; stats (STATS,) int64 or null.  S is a
// multiple of bs, and bs of 4; all float32, contiguous.  One cooperative
// launch on `stream`; a grid that cannot be co-resident is refused with the
// launch's error.
int vlgp_sweep(const float* y, const float* xb, const float* mask, const float* a,
               const float* a2, const float* pois, const float* invn, const float* G,
               float* mu, float* w, float* v, float* dmu, float* X, float* rmat, float* npart,
               float* rlast, float* resid, int* counts, long long* stats, int S, int T, int Y,
               int Z, int R, int bs, int niter, int adaptive, float tol2, float dmu_bound,
               int ns_iters, int ns_warm_iters, int vb, int has_x, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || Y < 1 || Z < 1 || bs < 4 || bs % 4 || S < bs || S % bs != 0 ||
      niter < 0 || ns_iters < 0 || ns_warm_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int nt = tiled_threads(R);
  const size_t smem = sizeof(float) * (region_floats(Z, T, Y, R) + 2 * ((S / bs + 31) / 32));
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, bpsm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bpsm, sweep_kernel, nt, smem)) !=
      cudaSuccess)
    return (int)err;
  if (bpsm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // every block co-resident, and no more than a refine pass has matrices
  const long items = (long)Z * S;
  const int blocks = (int)((long)bpsm * nsm < items ? (long)bpsm * nsm : items);
  SweepArgs p{y, xb, mask, a, a2, pois, invn, G, mu, w, v, dmu, X, rmat, npart,
              rlast, resid, counts, stats, S, T, Y, Z, R, bs, niter, adaptive, tol2,
              dmu_bound, ns_iters, ns_warm_iters, vb, has_x, bpsm};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)sweep_kernel, blocks, nt, args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
