// The whole E-step in one kernel, for Hopper: replaces
// vlgp_tpu/ops/sweep.py:_sweep_pallas (kernel body _make_sweep_kernel).
//
// One thread block per exit group of `bs` consecutive segments (125 blocks
// at the flagship E-step, bs = 16), all Z latents inside.  The block runs
// the group's Newton sweeps until its own exit:
//
//   initial   M = I + G'WG from the masked weights, X refined warm from the
//             carry (ns_warm_iters) or cold (ns_iters);
//   per sweep (i < niter, and with tol > 0: i < 2 or |dmu|^2 > tol^2 |mu|^2
//             on the group's own norms, starting from 1 and 1)
//     a. eta = xb + sum_z mu_z a_z, r = exp(min(eta + sum_z v_z a2_z, 10)),
//        resid = pois (y - r) + (1 - pois)(y - eta) invn, masked,
//        s_z = resid . a_z                      (one warp per (segment, t))
//     b. u = G G's - mu, delta = u - G X G'(w u), clipped to dmu_bound and
//        masked; mu += delta                    (one warp per (z, segment))
//     c. w_z = sum_y (pois r + (1 - pois) invn) a_z^2, masked, with r from
//        the new mu and the OLD v               (one warp per (segment, t))
//     d. Gram + warm Newton-Schulz refine of every (z, segment) matrix
//     e. under VB, v = diag(G X G'), masked
//     f. the group's |dmu|^2 and |mu|^2.
//
// Every refine is residual-checked per group, as the TPU kernel does: while
// the group's worst residual is not below 1e-2, up to two more passes of
// ns_iters rounds; a warm refine that still fails restarts the whole group
// cold (skipped for the initial no-carry refine, which already started
// cold).  Zeros, vem's first carry, are a Newton-Schulz fixed point
// that only this restart escapes.  The block's worst residual, including
// the initial refine, and its counts (sweeps, refine passes, Newton-Schulz
// rounds) are written per group.
//
// Design.  The posterior tensors mu, w, v, dmu (Z, S, T) and the carried
// inverses X (Z, S, R, R: 512 KB per group at the flagship) live in the
// output buffers in device memory, updated in place by the block that owns
// the group, so no size is bounded by shared memory but M, X and one R x R
// scratch of the matrix being refined (ns_common.cuh; the per-row and
// per-pair vectors of stages a-c reuse that space).  Each matrix is rebuilt
// from G and w for every refine pass: T R^2 FMAs, less than one
// Newton-Schulz round's 2 R^3.  s_z goes through a (Z, S, T) scratch and u
// through the dmu buffer.  Every exit and restart decision is a block-wide
// reduction that every thread receives, so each branch is uniform and
// __syncthreads stays legal; no atomics, so repeated runs give the same
// bits.  Every product is a full float32 FMA (the TPU's bf16x3 split,
// vlgp_tpu/ops/sweep.py:97-110, is not carried over).
//
// What bounds it on this card: at the flagship each sweep is ~0.65 M FMAs
// per matrix (Gram, 4 warm rounds, residual, v), operands from shared
// memory, on 125 blocks of 512 threads, one per SM: shared-memory latency
// at low occupancy, far above both the FLOP and the byte bound.  More
// blocks per group (cluster shared memory) or wgmma products are later work.

#include "ns_common.cuh"

namespace {

using namespace vlgp;

constexpr int NT = 512;         // threads per block
constexpr int NWARP = NT / 32;
constexpr float EXP_BOUND = 10.f;  // vlgp_tpu/ops/math.py:trunc_exp

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
  float* sproj;        // (Z, S, T) scratch
  float* resid;        // (S / bs) worst residual per group
  int* counts;         // (S / bs, 3) sweeps, refine passes, NS rounds
  int S, T, Y, Z, R, bs;
  int niter, adaptive;
  float tol2, dmu_bound;
  int ns_iters, ns_warm_iters, vb, has_x;
};

// NaN-propagating min(x, EXP_BOUND), as jnp.minimum
__device__ __forceinline__ float exp_clip(float x) {
  return expf((x < EXP_BOUND || x != x) ? x : EXP_BOUND);
}

// NaN-propagating clip to [-b, b], as jnp.clip
__device__ __forceinline__ float clip(float x, float b) {
  return x < -b ? -b : (x > b ? b : x);
}

struct Smem {
  float* M;
  float* X;
  float* Tm;
  float* Gc;
  float* wc;
  float* red;
};

// Stages a (project = true: s_z = resid . a_z into sproj) and c (project =
// false: w_z = U . a_z^2 into w), one warp per (segment, t) row of the
// group; `row` is the warp's Y floats of shared memory.
__device__ void rows_stage(const SweepArgs& p, int s0, bool project, float* row) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int T = p.T, Y = p.Y, Z = p.Z, S = p.S;
  for (int q = wid; q < p.bs * T; q += NWARP) {
    const int seg = s0 + q / T, t = q % T;
    const size_t st = (size_t)seg * T + t;
    const float mk = p.mask[st];
    for (int yy = lane; yy < Y; yy += 32) {
      float eta = p.xb[st * Y + yy], arg = 0.f;
      for (int z = 0; z < Z; ++z) {
        const size_t zst = ((size_t)z * S + seg) * T + t;
        eta = fmaf(p.mu[zst], p.a[z * Y + yy], eta);
        arg = fmaf(p.v[zst], p.a2[z * Y + yy], arg);
      }
      const float r = exp_clip(eta + arg);
      const float pz = p.pois[yy];
      if (project) {
        const float yv = p.y[st * Y + yy];
        row[yy] = (pz * (yv - r) + (1.f - pz) * (yv - eta) * p.invn[yy]) * mk;
      } else {
        row[yy] = pz * r + (1.f - pz) * p.invn[yy];
      }
    }
    __syncwarp();
    for (int z = 0; z < Z; ++z) {
      float acc = 0.f;
      for (int yy = lane; yy < Y; yy += 32) {
        const float az = p.a[z * Y + yy];
        acc = fmaf(row[yy], project ? az : 2.f * p.a2[z * Y + yy], acc);
      }
      acc = warp_sum(acc);
      const size_t zst = ((size_t)z * S + seg) * T + t;
      if (lane == 0) {
        if (project) p.sproj[zst] = acc;
        else p.w[zst] = acc * mk;
      }
    }
    __syncwarp();  // `row` is free for the next row
  }
}

// Stage b: the Woodbury step for every (z, segment) pair of the group, one
// warp per pair; `vec` is the warp's 3 R floats of shared memory.
__device__ void delta_stage(const SweepArgs& p, int s0, float* vec) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int T = p.T, R = p.R, S = p.S;
  float* gts = vec;
  float* gwu = vec + R;
  float* mv = vec + 2 * R;
  for (int m = wid; m < p.Z * p.bs; m += NWARP) {
    const int z = m / p.bs, seg = s0 + m % p.bs;
    const float* Gz = p.G + (size_t)z * T * R;
    const size_t zs = (size_t)z * S + seg;
    float* mu = p.mu + zs * T;
    const float* w = p.w + zs * T;
    float* u = p.dmu + zs * T;  // u, then delta
    const float* s = p.sproj + zs * T;
    const float* X = p.X + zs * R * R;
    const float* mk = p.mask + (size_t)seg * T;
    for (int r = lane; r < R; r += 32) {  // G' s
      float acc = 0.f;
      for (int t = 0; t < T; ++t) acc = fmaf(Gz[t * R + r], s[t], acc);
      gts[r] = acc;
    }
    __syncwarp();
    for (int t = lane; t < T; t += 32) {  // u = G G's - mu
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc = fmaf(Gz[t * R + r], gts[r], acc);
      u[t] = acc - mu[t];
    }
    __syncwarp();
    for (int r = lane; r < R; r += 32) {  // G' (w u)
      float acc = 0.f;
      for (int t = 0; t < T; ++t) acc = fmaf(Gz[t * R + r], w[t] * u[t], acc);
      gwu[r] = acc;
    }
    __syncwarp();
    for (int r = lane; r < R; r += 32) {  // X G'(w u)
      float acc = 0.f;
      for (int q = 0; q < R; ++q) acc = fmaf(X[r * R + q], gwu[q], acc);
      mv[r] = acc;
    }
    __syncwarp();
    for (int t = lane; t < T; t += 32) {  // delta = u - G X G'(w u)
      float acc = 0.f;
      for (int r = 0; r < R; ++r) acc = fmaf(Gz[t * R + r], mv[r], acc);
      const float d = clip(u[t] - acc, p.dmu_bound) * mk[t];
      u[t] = d;
      mu[t] += d;
    }
    __syncwarp();
  }
}

template <int E>
struct Group {
  const SweepArgs& p;
  Smem sm;
  int s0;
  int passes = 0, rounds = 0;

  // One pass over the group's matrices: rebuild M from G and w, start X
  // cold or from the carried X, run `iters` rounds, store X; returns the
  // group's worst residual.
  __device__ __noinline__ float pass(bool cold, int iters) {
    const int R = p.R, RR = R * R, T = p.T;
    float worst = 0.f;
    for (int m = 0; m < p.Z * p.bs; ++m) {
      const int z = m / p.bs, seg = s0 + m % p.bs;
      const size_t zs = (size_t)z * p.S + seg;
      float* Xg = p.X + zs * RR;
      gram_build<NT, E>(p.G + (size_t)z * T * R, p.w + zs * T, T, R, sm.M, sm.Gc, sm.wc);
      if (cold) {
        ns_cold_start<NT>(sm.M, sm.X, R, sm.red);
      } else {
        for (int i = threadIdx.x; i < RR; i += NT) sm.X[i] = Xg[i];
      }
      __syncthreads();
      ns_iterate<NT, E>(sm.M, sm.X, sm.Tm, R, iters);
      worst = nanmax(worst, ns_residual<NT, E>(sm.M, sm.X, R, sm.red));
      for (int i = threadIdx.x; i < RR; i += NT) Xg[i] = sm.X[i];
    }
    __syncthreads();  // every X of the group is stored
    ++passes;
    rounds += iters;
    return worst;
  }

  // first pass, then up to two escalation passes of ns_iters rounds while
  // the residual is not below tolerance (vlgp_tpu/ops/sweep.py:165-183)
  __device__ float refine(bool cold, int first_iters) {
    float r = pass(cold, first_iters);
    for (int k = 0; k < 2 && !(r < RESID_TOL); ++k) r = pass(false, p.ns_iters);
    return r;
  }

  // a warm refine that fails restarts the group cold (:185-204)
  __device__ float ns_refine(bool cold, int first_iters, bool was_warm) {
    float r = refine(cold, first_iters);
    if (was_warm && !(r < RESID_TOL)) r = refine(true, p.ns_iters);
    return r;
  }

  __device__ void marginal_vs() {
    const int R = p.R, RR = R * R, T = p.T;
    for (int m = 0; m < p.Z * p.bs; ++m) {
      const int z = m / p.bs, seg = s0 + m % p.bs;
      const size_t zs = (size_t)z * p.S + seg;
      __syncthreads();  // the previous matrix's v is done with sm.X
      for (int i = threadIdx.x; i < RR; i += NT) sm.X[i] = p.X[zs * RR + i];
      __syncthreads();
      marginal_v<NT>(p.G + (size_t)z * T * R, sm.X, T, R, sm.Gc, p.v + zs * T,
                     p.mask + (size_t)seg * T);
    }
    __syncthreads();
  }
};

template <int E>
__global__ void __launch_bounds__(NT) sweep_kernel(SweepArgs p) {
  extern __shared__ float smem[];
  const int R = p.R, RR = R * R, T = p.T;
  Smem sm;
  sm.M = smem;
  sm.X = sm.M + RR;
  sm.Tm = sm.X + RR;
  sm.Gc = sm.Tm + RR;
  sm.wc = sm.Gc + TC * R;
  sm.red = sm.wc + TC;
  const int g = blockIdx.x;
  const int s0 = g * p.bs;
  const int wid = threadIdx.x >> 5;
  const int n = p.Z * p.bs * T;  // posterior entries of the group
  Group<E> grp{p, sm, s0};

  // the kernel masks w itself (vlgp_tpu/ops/sweep.py:243)
  for (int i = threadIdx.x; i < n; i += NT) {
    const int z = i / (p.bs * T), st = i % (p.bs * T);
    p.w[((size_t)z * p.S + s0) * T + st] *= p.mask[(size_t)s0 * T + st];
  }
  __syncthreads();

  float worst = p.has_x ? grp.ns_refine(false, p.ns_warm_iters, true)
                        : grp.ns_refine(true, p.ns_iters, false);
  int i = 0;
  float nd = 1.f, nm = 1.f;
  while (i < p.niter && (!p.adaptive || i < 2 || nd > p.tol2 * nm)) {
    __syncthreads();  // the rows below may overlap the reduction slots
    rows_stage(p, s0, true, smem + wid * p.Y);
    __syncthreads();
    delta_stage(p, s0, smem + wid * 3 * R);
    __syncthreads();
    rows_stage(p, s0, false, smem + wid * p.Y);
    __syncthreads();
    worst = nanmax(worst, grp.ns_refine(false, p.ns_warm_iters, true));
    if (p.vb) grp.marginal_vs();
    float d2 = 0.f, m2 = 0.f;
    for (int k = threadIdx.x; k < n; k += NT) {
      const int z = k / (p.bs * T), st = k % (p.bs * T);
      const size_t idx = ((size_t)z * p.S + s0) * T + st;
      d2 = fmaf(p.dmu[idx], p.dmu[idx], d2);
      m2 = fmaf(p.mu[idx], p.mu[idx], m2);
    }
    nd = block_sum<NT>(d2, sm.red);
    nm = block_sum<NT>(m2, sm.red);
    ++i;
  }
  if (threadIdx.x == 0) {
    p.resid[g] = worst;
    p.counts[3 * g] = i;
    p.counts[3 * g + 1] = grp.passes;
    p.counts[3 * g + 2] = grp.rounds;
  }
}

// entries per thread, rounded up to a compiled register-array size
int entries(int R) {
  const int e = (R * R + NT - 1) / NT;
  return e <= 4 ? 4 : e <= 8 ? 8 : e <= 16 ? 16 : 32;
}

template <int E>
cudaError_t launch(const SweepArgs& p, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sweep_kernel<E><<<p.S / p.bs, NT, smem, st>>>(p);
  return cudaGetLastError();
}

// Shared memory of one block, in bytes: the refine's M, X, scratch, G chunk
// and reduction slots, or the stages' per-warp rows (Y floats) and vectors
// (3 R floats), whichever is larger (ops/sweep.py:_sweep_smem_bytes).
int smem_bytes(int Y, int R) {
  const int ns = 3 * R * R + TC * R + TC + NWARP;
  const int rows = NWARP * (Y > 3 * R ? Y : 3 * R);
  return (int)sizeof(float) * (ns > rows ? ns : rows);
}

}  // namespace

extern "C" {

// y, xb (S,T,Y); mask (S,T); a, a2 (Z,Y); pois, invn (Y); G (Z,T,R);
// mu, w, v, dmu, sproj (Z,S,T); X (Z,S,R,R); resid (S/bs,); counts
// (S/bs, 3) int32.  S is a multiple of bs; all float32, contiguous.
int vlgp_sweep(const float* y, const float* xb, const float* mask, const float* a,
               const float* a2, const float* pois, const float* invn, const float* G,
               float* mu, float* w, float* v, float* dmu, float* X, float* sproj,
               float* resid, int* counts, int S, int T, int Y, int Z, int R, int bs,
               int niter, int adaptive, float tol2, float dmu_bound, int ns_iters,
               int ns_warm_iters, int vb, int has_x, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || Y < 1 || Z < 1 || bs < 1 || S < bs || S % bs != 0 ||
      niter < 0 || ns_iters < 0 || ns_warm_iters < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes(Y, R);
  const SweepArgs p{y, xb, mask, a, a2, pois, invn, G, mu, w, v, dmu, X, sproj, resid,
                    counts, S, T, Y, Z, R, bs, niter, adaptive, tol2, dmu_bound,
                    ns_iters, ns_warm_iters, vb, has_x};
  cudaStream_t st = (cudaStream_t)stream;
  switch (entries(R)) {
    case 4:  return (int)launch<4>(p, smem, st);
    case 8:  return (int)launch<8>(p, smem, st);
    case 16: return (int)launch<16>(p, smem, st);
    default: return (int)launch<32>(p, smem, st);
  }
}

}  // extern "C"
