// Newton-Schulz inverses X = (I + A)^{-1} of small SPD systems, for Hopper.
//
// Five entry points share the register-tiled routines of ns_common.cuh:
//
//   ns_gram    replaces vlgp_tpu/ops/spd.py:_ns_gram_pallas (kernel body
//              _make_ns_gram_kernel), the per-matrix design.  Per (latent
//              z, segment s) it builds A = G_z' diag(w_zs) G_z in shared
//              memory, streaming rows of G_z and w_zs over T in chunks of
//              TC rows, runs Newton-Schulz X <- X (2I - (I+A) X), writes X,
//              one residual max|(I+A)X - I| per matrix and, when asked,
//              v = diag(G X G') computed from the X the block still holds.
//              A block per matrix: the block path.
//   ns_gram_stream  the same function and bits on persistent blocks (the
//              streaming path, see below), where ops/spd.py:gram_plan
//              picks it.
//   ns_gram_pairs  the same function for long T (the long-T design; the
//              rule that picks it is ops/spd.py:_ns_gram_design, by (T, R)
//              alone).  Three launches, see "The long-T design" below.
//   ns_packed  replaces vlgp_tpu/ops/spd.py:_ns_packed_pallas (kernel body
//              _make_ns_packed_kernel): the same iteration on a given
//              A (B, R, R).
//   ns_packed_probe_skip  replaces the probe_skip mode of the same Pallas
//              kernel (vlgp_tpu/ops/spd.py:492-519): per group of
//              `per_block` matrices (the TPU kernel's grid block,
//              _packed_geometry(tiles=12)), a group whose worst x0 residual
//              is below 1e-2 returns x0 bit for bit, any other group (NaN
//              included) is refined from x0.
//
// Modes (ns_gram, ns_packed): cold start at c I with c = 2 / (1 + max
// row-sum of |I+A|); warm start at x0 (iters = 0 is legal); probe
// (resid_only): one product measures x0's residual, no X is written, and
// ns_gram emits v from x0.
//
// Design.  One thread block per matrix, of nb^2 threads rounded up to a
// warp, nb = ceil(R / 4): 128 threads at R = 40, 192 at R = 50, 1024 at
// R = 128.  Each thread owns a 4 x 4 tile of every product in 16 registers
// (ns_common.cuh, "Register-tiled routines").  The block keeps M = I + A
// transposed, X by rows and X transposed in dynamic shared memory, each
// padded to 4 nb rows of stride ld = padded_ld(R) (44 floats at R = 40,
// 132 at R = 128), with the pad zero.  A product P Q reads row k of P's
// transpose and row k of Q as one 16-byte word each per 16 FMAs, which is
// why M and X are kept transposed: M X reads Mt and X, X (2I - M X) reads
// Xt and the T that overwrote X, and the new X is stored both ways.  The
// Gram build and v = diag(G X G') use the same tiles on the streamed G
// chunk.  At R = 128 ns_gram's three matrices, G chunk and partial sums of
// v take 223,488 bytes of the 232,448 a block may use.  Every multiply is
// a full float32 FMA: no TF32 and no
// bf16 (the TPU's bf16 products made the iteration miss its 1e-2
// tolerance, vlgp_tpu/ops/spd.py:54-65), and each entry sums over k in
// the same order as before the tiling.  The TPU kernels' block-diagonal
// packing of 128 // R matrices into one 128 x 128 tile is a trick for the
// TPU's matrix unit and is dropped.
//
// What bounds it on this card: at the main-path shapes (R = 40, 10,000
// matrices) each Newton-Schulz round is 2 R^3 FMAs per matrix with operands
// in shared memory; X is read and written once per call, so device memory
// is far from the bound.  At two 16-byte loads per 16 FMAs the products
// are no longer capped by shared-memory bandwidth (the untiled product read
// two 4-byte words per FMA, which capped it near 1/8 of the FP32 rate); what is left
// is the FMA instruction rate, the idle lanes of a block (100 tiles on 128
// threads at R = 40), the four barriers per round, and the stores of each
// tile (T by rows, the new X by rows and by columns).  On an H100 (700 W)
// ns_gram's 16 cold rounds at R = 40 ran at 36% of the FP32 bound, with
// 59-64 registers per thread, the 64 that __launch_bounds__(1024) allows
// (8 bytes of ns_gram spilled).
//
// The streaming path.  The block path pays, per matrix: a block's start,
// zeroing its three matrices, G_z streamed from L2 twice (for the Gram and
// for v, behind two barriers a 32-row chunk, by scalar loads), x0 and X by
// scalar loads and stores, and four block barriers a round over four warps,
// under the 64 registers that __launch_bounds__(1024) leaves, with two
// 16-byte shared-memory loads per 16 FMAs.  The streaming path keeps one
// block per (latent, j < per) resident for the whole call, per = SMs / Z,
// so that a block meets one latent: G_z is copied into shared memory once,
// by rows and transposed, and neither the Gram nor v reads device memory
// but the matrix's w row.  A producer warp copies each matrix's w row
// and x0 (by cp.async.bulk on mbarriers, ragged ends by plain loads, each
// at its address mod 16) into one of two stages of the consumer warp that
// will solve it and into that warp's Xt, as soon as the warp has read
// them; the warp moves x0 into X (and X into Xt) itself.
// Each consumer warp solves
// one matrix at a time with no barrier but __syncwarp: a lane owns an 8 x 8
// tile of every product in 64 registers (25 lanes at R = 40) and reads four
// 16-byte words per 64 FMAs, so the warps of the block (one an SM's
// quarter or more) issue FMAs with little waiting on shared memory.  The
// stage is released once the Gram and x0 are read.  X leaves by 16-byte
// stores of rows, v by rows.  Each product, the Gram, the residual and v
// sum over k in the block path's order, so a matrix has the same bits on
// either path, whatever S is and whichever block or warp takes it.  R <= 40
// (a warp's 25 tiles) and 232,448 bytes; gram_plan keeps the block path
// elsewhere.  A first draft with four-warp groups of 4 x 4 tiles on named
// barriers (two a round) ran the rounds slower than the block path (PERF.md).
//
// The long-T design.  At T = 1000 the per-matrix design streams all of G_z
// (T x R, 200 KB at R = 50) through every block's shared memory twice, for
// the Gram and for v, with two barriers per 32-row chunk, and reuses no row
// of G across segments: ~5 GB of L2 reads at 12,500 matrices, and it lost
// to its own plain version there (PERF.md, Findings).  The TPU kernel shares
// one G block among per_block segments (vlgp_tpu/ops/spd.py:807-817), so
// its Gram is a matrix product with G reused.  ns_gram_pairs does that
// with the card's FP32 SIMT units, over the P = R (R + 1) / 2 pairs of the
// upper triangle (A is symmetric):
//   1. ns_gram_pairs_kernel: A[z, s, p] = sum_t w[z, s, t] K_z[t, p],
//      K_z[t, p] = G_z[t, i] G_z[t, j], a register-tiled GEMM (M = S,
//      N = P, K = T) whose B tile is formed from G as it is staged: one
//      multiply per element of Bs against BM FMAs that read it.  The pairs
//      go to a (Z, S, P) scratch from torch's allocator (64 MB at Z5 S2500
//      R50).
//   2. ns_gram_solve_kernel: one block per matrix unpacks I + A into Mt and
//      runs ns_solve as ns_packed does (cold, warm, probe); with want_v it
//      writes Xp (X_ii, X_ij + X_ji) over its own row of the scratch.
//   3. ns_gram_v_kernel: v[z, s, t] = sum_p Xp[z, s, p] K_z[t, p], the same
//      GEMM with N = T and K = P; the block's rows of G stay in shared
//      memory for the whole K loop.
// Each GEMM output is one FMA chain over k in increasing order, with no
// split-K and no atomics, so a segment's X, residual and v are the same
// bits whatever S is and wherever the segment falls in a tile; the tile
// (128 x 128, or 128 x 64 when the grid would not give every SM two blocks)
// changes nothing but speed.  What bounds it: T P FMAs per matrix per
// GEMM (2.55 M at T1000 R50, each a full float32 FMA: no TF32, no wgmma),
// against 2 R^3 per Newton-Schulz round; w and Xp are read from device
// memory once per column of tiles (10 at P = 1275), consecutive blocks
// sharing them through L2.
//
// ns_gram_pairs runs launch 1, 3 or both on one Hopper GEMM
// core (pairs_gemm_kernel, "The streaming GEMM" below), under a plan from
// ops/spd.py:pairs_plan, which streams a GEMM
// where its 128 x 128 tiles give every SM four rounds (a leave-one-neuron-
// out chunk) and keeps the tiled kernels above, with the same bits, where
// they are faster (few tiles: the final inference).  The tiled kernels' register tile
// issued FMAs at 47% and 43% of the FP32 rate at Z5 S2500 T1000 R50, behind
// a block barrier every 8 k, the B tile formed and the A tile copied by the
// same warps between products, and 3.03-3.79 waves of non-persistent
// blocks (PERF.md, Findings).
//
// probe_skip takes two launches of one block per matrix, in stream order:
// the probe (ns_packed_kernel in probe mode) writes every x0's residual to
// r0 in device memory; then each block of the refine reads its group's
// residuals and either copies x0 or refines.  The skip decision needs every
// residual of the group before any matrix of it is refined, and the second
// launch gives that ordering for free.  A thread-block cluster per group
// could not: a group is 24 matrices at R = 50, more than the 16 blocks a
// cluster may hold.
//
// The residual reduction propagates NaN (fmaxf would drop it), so a NaN X
// can never pass the caller's `isfinite(resid) && resid < tol` check.  No
// atomics: repeated runs give the same bits.  Each entry point returns
// cudaGetLastError() of its launches.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <climits>
#include <cstdio>
#include <cstring>

#include "ns_common.cuh"

namespace {

using namespace vlgp;

constexpr int NT_MAX = 1024;    // threads of a block at R = 128

// Shared-memory layout of a block: Mt, X, Xt (4 nb x ld each), then the
// kernel's extra space.
struct Layout {
  int nb, ld, n;  // tiles per side, row stride, floats per matrix
  __host__ __device__ explicit Layout(int R)
      : nb(tiles_per_side(R)), ld(padded_ld(R)), n(4 * tiles_per_side(R) * padded_ld(R)) {}
};

__device__ void zero_shared(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// Solve in shared memory: Mt = (I + A)^T is complete on entry and X, Xt
// are zero.  Initializes X (cold or from x0b), iterates unless
// `resid_only`, writes the residual of the final X to *resid_out and X to
// Xout (when not null).
__device__ void ns_solve(const float* Mt, float* X, float* Xt, float* red,
                         const float* x0b, float* Xout, float* resid_out,
                         int R, int ld, int iters, int resid_only) {
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
  if (!resid_only) ns_iterate_tiled(Mt, X, Xt, R, ld, iters);
  const float res = ns_residual_tiled(Mt, X, R, ld, red);
  if (tid == 0) *resid_out = res;
  if (Xout != nullptr && !resid_only) {
    for (int i = tid; i < RR; i += blockDim.x) {
      const int r = i / R;
      Xout[i] = X[r * ld + i - r * R];
    }
  }
}

__global__ void __launch_bounds__(NT_MAX)
ns_gram_kernel(const float* __restrict__ G, const float* __restrict__ w,
               const float* __restrict__ x0, float* __restrict__ Xo,
               float* __restrict__ resid, float* __restrict__ v,
               int S, int T, int R, int iters, int resid_only, int want_v) {
  extern __shared__ float4 sm4[];
  const Layout L(R);
  float* Mt = reinterpret_cast<float*>(sm4);
  float* X = Mt + L.n;
  float* Xt = X + L.n;
  float* Gc = Xt + L.n;            // TC x 4 nb chunk of G_z (4 nb x TC for v)
  float* wc = Gc + TC * 4 * L.nb;  // TC weights
  float* part = wc + TC;           // nb x TC partial sums of v
  float* red = part + TC * L.nb;   // one float per warp
  const int RR = R * R;
  const int b = blockIdx.x;  // b = z * S + s
  const int z = b / S;
  const float* Gz = G + (size_t)z * T * R;

  zero_shared(Mt, 3 * L.n);
  gram_build_tiled(Gz, w + (size_t)b * T, T, R, L.ld, Mt, Gc, wc);
  ns_solve(Mt, X, Xt, red, x0 ? x0 + (size_t)b * RR : nullptr,
           Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, L.ld, iters, resid_only);
  // v_t = G_t X G_t' from the X this block holds (x0 in probe mode)
  if (want_v) marginal_v_tiled(Gz, X, T, R, L.ld, Gc, part, v + (size_t)b * T);
}

// Mt = (I + A)^T from A by rows; the caller synchronises after.
__device__ void load_packed(const float* Ab, float* Mt, int R, int ld) {
  for (int i = threadIdx.x; i < R * R; i += blockDim.x) {
    const int r = i / R, k = i - r * R;
    Mt[k * ld + r] = Ab[i] + (r == k ? 1.f : 0.f);
  }
}

__global__ void __launch_bounds__(NT_MAX)
ns_packed_kernel(const float* __restrict__ A, const float* __restrict__ x0,
                 float* __restrict__ Xo, float* __restrict__ resid,
                 int R, int iters, int resid_only) {
  extern __shared__ float4 sm4[];
  const Layout L(R);
  float* Mt = reinterpret_cast<float*>(sm4);
  float* X = Mt + L.n;
  float* Xt = X + L.n;
  float* red = Xt + L.n;
  const int RR = R * R;
  const int b = blockIdx.x;
  zero_shared(Mt, 3 * L.n);
  __syncthreads();
  load_packed(A + (size_t)b * RR, Mt, R, L.ld);
  __syncthreads();
  ns_solve(Mt, X, Xt, red, x0 ? x0 + (size_t)b * RR : nullptr,
           Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, L.ld, iters, resid_only);
}

// Pass 2 of probe_skip, one block per matrix m; pass 1 (ns_packed_kernel in
// probe mode) left every x0's residual in r0.  The block takes the
// NaN-propagating max of r0 over its group, m / per_block (the last group
// may be ragged).  A converged group copies x0[m] to X[m] bit for bit and
// keeps r0[m]; a drifted one (NaN included) runs max(iters, 1) rounds from
// x0[m]: the TPU kernel's probe product reused as the first half-step,
// X1 = x0 (2I - M x0), then iters - 1 rounds, is the same arithmetic.
__global__ void __launch_bounds__(NT_MAX)
ns_probe_skip_refine_kernel(const float* __restrict__ A, const float* __restrict__ x0,
                            const float* __restrict__ r0, float* __restrict__ Xo,
                            float* __restrict__ resid, int B, int R, int per_block,
                            int iters) {
  const int RR = R * R;
  const int m = blockIdx.x;
  const int g0 = m / per_block * per_block, g1 = min(B, g0 + per_block);
  float worst = 0.f;
  for (int i = g0; i < g1; ++i) worst = nanmax(worst, r0[i]);
  if (worst < RESID_TOL) {  // block-uniform; a NaN residual refines
    for (int i = threadIdx.x; i < RR; i += blockDim.x)
      Xo[(size_t)m * RR + i] = x0[(size_t)m * RR + i];
    if (threadIdx.x == 0) resid[m] = r0[m];
    return;
  }
  extern __shared__ float4 sm4[];
  const Layout L(R);
  float* Mt = reinterpret_cast<float*>(sm4);
  float* X = Mt + L.n;
  float* Xt = X + L.n;
  float* red = Xt + L.n;
  zero_shared(Mt, 3 * L.n);
  __syncthreads();
  load_packed(A + (size_t)m * RR, Mt, R, L.ld);
  __syncthreads();
  ns_solve(Mt, X, Xt, red, x0 + (size_t)m * RR, Xo + (size_t)m * RR, resid + m,
           R, L.ld, iters > 1 ? iters : 1, 0);
}

// ---------------------------------------------------------------------------
// ns_gram's streaming path (see "The streaming path" at the top)
// ---------------------------------------------------------------------------

constexpr int GS_WARPS_MAX = 8;    // consumer warps of a streaming block, at most
constexpr int GS_THREADS = 32 * (GS_WARPS_MAX + 1);  // and the producer warp
constexpr int GS_R_MAX = 40;       // the largest R whose 8 x 8 tiles a warp holds (25)
constexpr int GS_BAR_BYTES = 6 * 8 * GS_WARPS_MAX;  // six mbarriers a consumer warp
constexpr size_t GS_SMEM_MAX = 232448;  // shared memory a block can have on an H100

// A streaming block's shared memory: the mbarriers, G by rows (T rows of
// ld, columns at scol) and transposed (np rows of tp), then each consumer
// warp's two stages (a matrix's w row each, at its address mod 16), Mt
// (or, after the residual, v's partial sums: ceil(R / 4) rows of tp), X
// and Xt, np rows of ld each, Xt at least x0's slot (x0 lands there).
// ops/spd.py:_gram_stream_smem is its copy.
struct StreamLayout {
  int np, ld, tp;
  size_t n, mt, G, w, xt, warp, total;  // n and mt in floats, the rest in bytes
  __host__ __device__ StreamLayout(int T, int R, int warps) {
    np = 8 * warp_tiles(R);
    ld = warp_ld(R);
    tp = 4 * (((T + 3) / 4) | 1);
    n = (size_t)np * ld;
    mt = n > (size_t)tiles_per_side(R) * tp ? n : (size_t)tiles_per_side(R) * tp;
    G = sizeof(float) * ((size_t)T * ld + (size_t)np * tp);
    w = span_slot<float>(T);
    const size_t x0 = span_slot<float>((long long)R * R);
    xt = sizeof(float) * n > x0 ? sizeof(float) * n : x0;
    warp = 2 * w + sizeof(float) * (mt + n) + xt;
    total = GS_BAR_BYTES + G + warps * warp;
  }
};

// One persistent block per (latent z, j < per): G_z resident, the matrices
// b = z S + s of s = j, j + per, ... in turn; matrix m of consumer warp g
// is matrix k = g + m warps of the block's walk.  The producer warp copies
// its w row into the warp's stage m % 2 (mbarrier full) once the warp has
// read matrix m - 2's (wfree), and its x0 into the warp's Xt (xfull) once
// the warp has read the last Xt there (xfree: after the rounds, or in
// probe mode after x0 went to X).  The warp solves it with the block
// path's steps: the Gram from the stage's w, X and Xt from x0, the cold
// start or the rounds, the residual, X stored, v.  Each mbarrier has one
// waiter, which waits on its phases in order (a wait on a parity is only
// sound for the current phase or the one before it).
__global__ void __launch_bounds__(GS_THREADS, 1)
ns_gram_stream_kernel(const float* __restrict__ G, const float* __restrict__ w,
                      const float* __restrict__ x0, float* __restrict__ Xo,
                      float* __restrict__ resid, float* __restrict__ v, int S, int T, int R,
                      int iters, int resid_only, int want_v, int per) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // full and wfree: two a warp, [2 g + stage]; xfull and xfree: one a warp
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* wfree = full + 2 * GS_WARPS_MAX;
  unsigned long long* xfull = wfree + 2 * GS_WARPS_MAX;
  unsigned long long* xfree = xfull + GS_WARPS_MAX;
  const bool has_x0 = x0 != nullptr;
  const int warps = blockDim.x / 32 - 1;
  const StreamLayout L(T, R, warps);
  float* Gr = reinterpret_cast<float*>(smem_raw + GS_BAR_BYTES);
  float* Gt = Gr + (size_t)T * L.ld;
  unsigned char* base = smem_raw + GS_BAR_BYTES + L.G;
  // warp g's stage i (0, 1), its Mt (i = 2), X (3) and Xt (4)
  auto part_of = [&](int g, int i) {
    unsigned char* p = base + g * L.warp + (i < 2 ? i : 2) * L.w;
    return i < 3 ? p : p + sizeof(float) * (L.mt + (i == 4 ? L.n : 0));
  };
  const int z = blockIdx.x / per, j = blockIdx.x - z * per;
  const int RR = R * R, g = threadIdx.x >> 5, lane = threadIdx.x & 31, nthr = 32 * warps;
  if (threadIdx.x == 0) {
    for (int i = 0; i < warps; ++i) {
      bar_init(full + 2 * i, 32);
      bar_init(full + 2 * i + 1, 32);
      bar_init(wfree + 2 * i, 1);
      bar_init(wfree + 2 * i + 1, 1);
      bar_init(xfull + i, 32);
      bar_init(xfree + i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every warp's pads zero once (every store keeps them so)
  for (int i = threadIdx.x; i < (int)(warps * L.warp / sizeof(float)); i += blockDim.x)
    reinterpret_cast<float*>(base)[i] = 0.f;
  __syncthreads();
  if (g == warps) {  // the producer
    for (int k = 0;; ++k) {
      const long long s = j + (long long)k * per;
      if (s >= S) break;
      const int q = k % warps, m = k / warps, wb = m & 1;
      const long long b = (long long)z * S + s;
      if (m >= 2) bar_wait(wfree + 2 * q + wb, ((m >> 1) - 1) & 1);
      unsigned char* stage = part_of(q, wb);
      stage_spans<float>(1,
                         [&](int, unsigned char*& slot, const float*& src, long long& n) {
                           slot = stage;
                           src = w + b * T;
                           n = T;
                         },
                         full + 2 * q + wb, lane);
      if (has_x0) {
        if (m >= 1) bar_wait(xfree + q, (m - 1) & 1);
        unsigned char* xt = part_of(q, 4);
        stage_spans<float>(1,
                           [&](int, unsigned char*& slot, const float*& src, long long& n) {
                             slot = xt;
                             src = x0 + b * RR;
                             n = RR;
                           },
                           xfull + q, lane);
      }
    }
    return;
  }
  float* Mt = reinterpret_cast<float*>(part_of(g, 2));
  float* X = reinterpret_cast<float*>(part_of(g, 3));
  float* Xt = reinterpret_cast<float*>(part_of(g, 4));
  // G_z into both layouts by all consumers, while the first stages land
  const float* Gz = G + (size_t)z * T * R;
  for (int i = threadIdx.x; i < T * L.np; i += nthr) {
    const int t = i / L.np, c = i - t * L.np;
    Gr[t * L.ld + scol(c)] = c < R ? Gz[(size_t)t * R + c] : 0.f;
  }
  for (int i = threadIdx.x; i < L.np * L.tp; i += nthr) {
    const int c = i / L.tp, t = i - c * L.tp;
    Gt[i] = c < R && t < T ? Gz[(size_t)t * R + c] : 0.f;
  }
  asm volatile("bar.sync 1, %0;" ::"r"(nthr) : "memory");
  for (int m = 0;; ++m) {
    const long long s = j + (long long)(g + m * warps) * per;
    if (s >= S) break;
    const long long b = (long long)z * S + s;
    const int wb = m & 1;
    bar_wait(full + 2 * g + wb, (m >> 1) & 1);
    gram_warp(Gr, in_slot(part_of(g, wb), w + b * T), T, R, L.ld, Mt, lane);
    __syncwarp();  // Mt is complete; the stage is read
    if (lane == 0) bar_arrive(wfree + 2 * g + wb);
    if (has_x0) {
      bar_wait(xfull + g, m & 1);
      load_x_warp(in_slot(reinterpret_cast<unsigned char*>(Xt), x0 + b * RR), X, R, L.ld, lane);
      __syncwarp();  // x0 is read
      if (resid_only) {
        if (lane == 0) bar_arrive(xfree + g);
      } else {
        transpose_warp(X, Xt, R, L.ld, lane);
        __syncwarp();
      }
    } else {
      cold_start_warp(Mt, X, Xt, R, L.ld, lane);
      __syncwarp();
    }
    if (!resid_only) {
      iterate_warp(Mt, X, Xt, R, L.ld, iters, lane);
      if (has_x0 && lane == 0) bar_arrive(xfree + g);  // iterate_warp's last read of Xt is done
    }
    const float res = residual_warp(Mt, X, R, L.ld, lane);
    if (lane == 0) resid[b] = res;
    if (!resid_only) store_x_warp(X, Xo + b * RR, R, L.ld, lane);
    if (want_v) {
      __syncwarp();  // every read of Mt is done: v's partial sums go there
      v_warp(Gt, L.tp, X, T, R, L.ld, Mt, v + b * T, lane);
    }
    __syncwarp();  // every read of this matrix's X, Mt and partial sums is done
  }
}

// Bytes of shared memory of a packed block (Mt, X, Xt, one float per warp).
size_t packed_smem(int R) {
  return sizeof(float) * (3 * Layout(R).n + tiled_threads(R) / 32);
}

cudaError_t launch_packed(const float* A, const float* x0, float* X, float* resid,
                          int B, int R, int iters, int resid_only, cudaStream_t st) {
  const size_t smem = packed_smem(R);
  cudaError_t err = cudaFuncSetAttribute(
      ns_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ns_packed_kernel<<<B, tiled_threads(R), smem, st>>>(A, x0, X, resid, R, iters, resid_only);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ns_gram's long-T design: three launches on one stream (see the note at
// the top; the pair form and the GEMM tile are in ns_common.cuh)
// ---------------------------------------------------------------------------

// Launch 1: Ap[z, s, p] = sum_t w[z, s, t] G_z[t, i] G_z[t, j], M = S, N = P,
// K = T.  Grid (tiles of P fastest, then tiles of S; Z), so the blocks that
// share a slice of w run together and it is read from device memory once.
// Per step the BK x BN tile of K is formed from G: thread (n, kb) owns the
// pair n0 + n and multiplies G[t, i] G[t, j] for its BK / KSTEP rows t, one
// multiply per element of Bs against BM FMAs that read it.  The next step's
// tile of w is copied into the other buffer (cp.async) and its rows of G
// loaded into registers before the step's products, and its Bs is stored
// after them: two buffers, one barrier per step.
template <int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
ns_gram_pairs_kernel(const float* __restrict__ G, const float* __restrict__ w,
                     float* __restrict__ Ap, int S, int T, int R) {
  __shared__ __align__(16) float As[2][GEMM_BK * (BM + 4)];
  __shared__ __align__(16) float Bs[2][GEMM_BK * BN];
  constexpr int KSTEP = GEMM_THREADS / BN;  // rows of Bs between a thread's elements
  constexpr int KB = GEMM_BK / KSTEP;       // a thread's elements of Bs per step
  const int P = num_pairs(R);
  const int ntn = (P + BN - 1) / BN;
  const int n0 = (blockIdx.x % ntn) * BN, m0 = (blockIdx.x / ntn) * BM, z = blockIdx.y;
  const float* Gz = G + (size_t)z * T * R;
  const float* wz = w + (size_t)z * S * T;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n = threadIdx.x % BN, kb = threadIdx.x / BN;
  const bool live = n0 + n < P;
  int pi = 0, rem = live ? n0 + n : 0;  // the pair (pi, pj) of column n
  while (rem >= R - pi) rem -= R - pi++;
  const int pj = pi + rem;

  float g1[KB], g2[KB];
  auto fetch = [&](int k0, int buf) {
    atile_copy<BM>(As[buf], wz, S, T, m0, k0);
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      const int t = k0 + kb + q * KSTEP;
      const bool ok = live && t < T;
      g1[q] = ok ? __ldg(Gz + (size_t)t * R + pi) : 0.f;
      g2[q] = ok ? __ldg(Gz + (size_t)t * R + pj) : 0.f;
    }
  };
  auto stage = [&](int buf) {
    atile_wait();
#pragma unroll
    for (int q = 0; q < KB; ++q) Bs[buf][(kb + q * KSTEP) * BN + n] = __fmul_rn(g1[q], g2[q]);
  };

  float acc[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  const int nk = (T + GEMM_BK - 1) / GEMM_BK;
  fetch(0, 0);
  stage(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) fetch((kt + 1) * GEMM_BK, (kt + 1) & 1);
    gemm_tile_step<BM, BN>(As[kt & 1], Bs[kt & 1], ty, tx, acc);
    if (more) stage((kt + 1) & 1);
    __syncthreads();
  }
  gemm_tile_store<BM, BN>(Ap + (size_t)z * S * P, S, P, m0, n0, ty, tx, acc);
}

// Launch 2, one block per matrix b = z S + s: M = I + A unpacked from its
// pairs into Mt, ns_solve as ns_packed_kernel runs it (cold, warm or probe),
// then with want_v the pairs of Xp, from the X the block holds (x0 in probe
// mode), written over the block's own row of Ap, which it no longer reads.
__global__ void __launch_bounds__(NT_MAX)
ns_gram_solve_kernel(float* __restrict__ Ap, const float* __restrict__ x0,
                     float* __restrict__ Xo, float* __restrict__ resid,
                     int R, int iters, int resid_only, int want_v) {
  extern __shared__ float4 sm4[];
  const Layout L(R);
  float* Mt = reinterpret_cast<float*>(sm4);
  float* X = Mt + L.n;
  float* Xt = X + L.n;
  float* red = Xt + L.n;
  const int RR = R * R, P = num_pairs(R);
  const int b = blockIdx.x;
  float* Ab = Ap + (size_t)b * P;
  zero_shared(Mt, 3 * L.n);
  __syncthreads();
  for (int e = threadIdx.x; e < RR; e += blockDim.x) {
    const int r = e / R, q = e - r * R;
    const int p = r <= q ? pair_index(r, q, R) : pair_index(q, r, R);
    Mt[q * L.ld + r] = Ab[p] + (r == q ? 1.f : 0.f);
  }
  __syncthreads();
  ns_solve(Mt, X, Xt, red, x0 ? x0 + (size_t)b * RR : nullptr,
           Xo ? Xo + (size_t)b * RR : nullptr, resid + b, R, L.ld, iters, resid_only);
  // X is final: ns_solve's last write of it precedes the residual's barriers
  if (want_v) {
    for (int e = threadIdx.x; e < RR; e += blockDim.x) {
      const int r = e / R, q = e - r * R;
      if (r <= q)
        Ab[pair_index(r, q, R)] = r == q ? X[r * L.ld + r] : X[r * L.ld + q] + X[q * L.ld + r];
    }
  }
}

// Launch 3: v[z, s, t] = sum_p Xp[z, s, p] G_z[t, i] G_z[t, j], M = S, N = T,
// K = P, on the same tile.  The block's N range is fixed, so its rows of G
// are read once into Gs, transposed (R rows of BN + 1: conflict-free both
// ways), with the pair table beside them; each step forms Bs from Gs.
template <int BM, int BN>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
ns_gram_v_kernel(const float* __restrict__ G, const float* __restrict__ Xp,
                 float* __restrict__ v, int S, int T, int R) {
  __shared__ __align__(16) float As[2][GEMM_BK * (BM + 4)];
  __shared__ __align__(16) float Bs[2][GEMM_BK * BN];
  extern __shared__ float4 dyn4[];
  constexpr int KSTEP = GEMM_THREADS / BN;
  constexpr int KB = GEMM_BK / KSTEP;
  const int P = num_pairs(R);
  const int ntn = (T + BN - 1) / BN;
  const int n0 = (blockIdx.x % ntn) * BN, m0 = (blockIdx.x / ntn) * BM, z = blockIdx.y;
  const float* Gz = G + (size_t)z * T * R;
  const float* Xz = Xp + (size_t)z * S * P;
  float* Gs = reinterpret_cast<float*>(dyn4);  // Gs[r (BN + 1) + c] = G_z[n0 + c, r], 0 past T
  unsigned char* pi = reinterpret_cast<unsigned char*>(Gs + R * (BN + 1));
  unsigned char* pj = pi + P;
  for (int e = threadIdx.x; e < R * BN; e += GEMM_THREADS) {
    const int c = e / R, r = e - c * R;
    Gs[r * (BN + 1) + c] = n0 + c < T ? __ldg(Gz + (size_t)(n0 + c) * R + r) : 0.f;
  }
  pair_table(R, pi, pj);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n = threadIdx.x % BN, kb = threadIdx.x / BN;
  const float* gcol = Gs + n;

  auto stage = [&](int buf, int k0) {
    atile_wait();
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      const int p = k0 + kb + q * KSTEP;
      Bs[buf][(kb + q * KSTEP) * BN + n] =
          p < P ? __fmul_rn(gcol[pi[p] * (BN + 1)], gcol[pj[p] * (BN + 1)]) : 0.f;
    }
  };

  float acc[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  const int nk = (P + GEMM_BK - 1) / GEMM_BK;
  atile_copy<BM>(As[0], Xz, S, P, m0, 0);
  __syncthreads();  // Gs and the pair table are complete
  stage(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const bool more = kt + 1 < nk;
    if (more) atile_copy<BM>(As[(kt + 1) & 1], Xz, S, P, m0, (kt + 1) * GEMM_BK);
    gemm_tile_step<BM, BN>(As[kt & 1], Bs[kt & 1], ty, tx, acc);
    if (more) stage((kt + 1) & 1, (kt + 1) * GEMM_BK);
    __syncthreads();
  }
  gemm_tile_store<BM, BN>(v + (size_t)z * S * T, S, T, m0, n0, ty, tx, acc);
}

// 128 x 128 tiles when a Z x M x N product has enough of them to give every
// SM two blocks, else 128 x 64: at Z5 S100 T1000 R50 the 128 x 64 tiles of
// both GEMMs took 55-66% of the 128 x 128 tiles' time and 94-97% of 64 x
// 64's, at Z5 S2500 the 128 x 128 tiles 87-90% of 128 x 64's (NVIDIA H100
// 80GB HBM3, 700 W; PERF.md, Findings).  Either shape gives the same bits
// (ns_common.cuh).  `nsm`: the card's SMs.
bool wide_tiles(int Z, int M, int N, int nsm) {
  return (long long)Z * ((M + 127) / 128) * ((N + 127) / 128) >= 2LL * nsm;
}

template <int BM, int BN>
cudaError_t launch_gram_pairs(const float* G, const float* w, float* Ap, int Z, int S, int T,
                              int R, cudaStream_t st) {
  const dim3 grid(((num_pairs(R) + BN - 1) / BN) * ((S + BM - 1) / BM), Z);
  ns_gram_pairs_kernel<BM, BN><<<grid, GEMM_THREADS, 0, st>>>(G, w, Ap, S, T, R);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_v_pairs(const float* G, const float* Xp, float* v, int Z, int S, int T,
                           int R, cudaStream_t st) {
  const size_t smem = sizeof(float) * R * (BN + 1) + 2 * num_pairs(R);
  cudaError_t err = cudaFuncSetAttribute(
      ns_gram_v_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((T + BN - 1) / BN) * ((S + BM - 1) / BM), Z);
  ns_gram_v_kernel<BM, BN><<<grid, GEMM_THREADS, smem, st>>>(G, Xp, v, S, T, R);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The streaming GEMM: launches 1 and 3 of the long-T design on Hopper
//
// C[z, m, n] = sum_k A[z, m, k] B_z[k, n] with kind 0, the Gram: A = w,
// M = S, K = T, N = P, B_z[t, p] = G_z[t, i] G_z[t, j]; kind 1, v: A = Xp,
// M = S, K = P, N = T, B_z[p, t] = G_z[t, i] G_z[t, j].  Persistent blocks
// take the tiles tau = blockIdx.x, blockIdx.x + gridDim.x, ... of a list
// ordered by latent, then by column of tiles, then by row of tiles, so the
// blocks in flight share one latent's rows of A and columns of B in L2.  A
// block is CW = WM WN consumer warps (a BM x BN = 64 WM x 32 WN tile) and
// H helper warps around a ring of `stages` stages of PG_BK k each.
//
// A's rows.  A is read as a 2D tensor of Z S / 4 groups of four rows, each
// group one row of 4 K floats: its stride, 16 K bytes, is 16-byte aligned
// whatever K is (Xp's rows of P = 1275 floats are not), so the tensor
// memory accelerator can copy it.  A tile's BM rows g0 .. g0 + BM - 1 (g =
// z S + m) hold BM / 4 rows of each residue b = g mod 4: one box of BM / 4
// groups, which lands at stage rows [b BM / 4, (b + 1) BM / 4) of PG_LDA
// floats.  A box must start at a 16-byte word, so it starts at the word
// below b K + k0 and spans 36 floats: residue b's k0 sits at a_off(b, K) =
// (b K) mod 4 in its rows.  Helper h loads the boxes of residues b = h, h +
// H, ... with one cp.async.bulk.tensor.2d each.  Where a box would read
// what is not the tile's, the helper copies those rows by 4-byte cp.async
// into the same places instead, zero past K: the stage holding k = K - 1
// when K % 32 != 0, a tile with rows in the tensor's last, partial group,
// and every stage when A's address is not 16-byte aligned (copy_tma 0).
// Both complete on the stage's full mbarrier.
//
// B.  `stages` - 2 stages after its copies of A a helper forms its HC =
// BN / H columns of the stage's B ([k][n]): kind 0 from the stage's rows
// of G, which helper 0 stages when it copies A (gfull: one bulk copy where
// the rows' span is 16-byte aligned, else stage_spans),
// through each lane's pair (i, j); kind 1 from its columns of G for the
// tile's t (the panel, rows of R | 1 floats, loaded as it forms the tile's
// first stage), through the pair of each k.  k past K and n past N form 0.
// Each lane loads PG_FB k of B before it stores them (a shared store would
// otherwise hold back the next load).  Then the helper arrives on full.
//
// Consumers.  Warp (wm, wn), lane 4 lm + ln, owns stage rows 64 wm + lm +
// 8 i and columns 32 wn + 4 ln + j and 32 wn + 16 + 4 ln + j (i < 8, j <
// 4): per k eight 4-byte loads of A (eight consecutive rows a load, at 36
// floats a row and offsets below 4: eight distinct banks; for even K, whose
// offsets are even, eight 8-byte loads per two k) and two 16-byte loads of
// B, against 64 FMAs.  It releases the stage (empty)
// once read, and stores its 8 x 8 sums, each at its stage row's (z, m),
// after a tile's last stage while the helpers fill the next tile's stages.
//
// No block barrier after the start.  Each output is one fmaf chain over k
// in increasing order from 0, k past K adding 0 * 0, and each B element is
// __fmul_rn(G[t, i], G[t, j]): the tiled kernels' bits at every tile shape, stage
// count, grid and copy path.  What bounds it: the FP32 FMA rate (T P FMAs
// a matrix a GEMM); a lane's 8 x 8 sums load 16 floats from shared memory
// a k against 64 FMAs, so at full FMA rate the consumers alone would keep
// shared memory busy every cycle.  -DPG_DIAG_CYCLES builds a copy that
// prints block 0's cycle split (first consumer and first helper).
// ---------------------------------------------------------------------------

constexpr int PG_BK = 32;                            // k a stage
constexpr int PG_LDA = PG_BK + 4;                    // floats a row of an A stage (a box row)
constexpr int PG_STAGES_MIN = 3, PG_STAGES_MAX = 4;  // the ring's depth
constexpr int PG_ALIGN = 128;       // the A stages' alignment (a box's destination)
constexpr int PG_BAR_BYTES = 3 * 8 * PG_STAGES_MAX;  // full, empty, gfull a stage
constexpr int PG_UNROLL = 4;        // k steps of a consumer's loop body
constexpr int PG_FB = 8;            // k of B a helper lane loads before it stores them

// the tile shapes the plan may name, (WM, WN, H) by shape: 0: 128 x 128, 8
// consumer warps and 4 helpers; 1: 64 x 128, 4 + 2; 2: 64 x 64, 2 + 2
constexpr int PG_SHAPES = 3;
__host__ __device__ inline int pairs_bm(int shape) { return shape == 0 ? 128 : 64; }
__host__ __device__ inline int pairs_bn(int shape) { return shape == 2 ? 64 : 128; }

__host__ __device__ inline int pairs_rs(int R) { return R | 1; }

// A block's shared memory, in bytes from the first 128-byte boundary of the
// dynamic shared memory (PG_ALIGN bytes of slack at most before it):
// `stages` A stages (BM rows of PG_LDA floats), `stages` B stages (PG_BK rows
// of BN), then for kind 0 `stages` slots of G rows (PG_BK R floats, at
// their address mod 16) or for kind 1 the panel (BN rows of R | 1), then
// the mbarriers.  ops/spd.py:_pairs_smem is its copy; ns_pairs_smem
// reports it.
struct PairsLayout {
  size_t b, g, gslot, bars, total;
  __host__ __device__ PairsLayout(int kind, int BM, int BN, int R, int stages) {
    b = sizeof(float) * (size_t)stages * BM * PG_LDA;
    g = b + sizeof(float) * (size_t)stages * PG_BK * BN;
    gslot = span_slot<float>((long long)PG_BK * R);
    bars = g + (kind == 0 ? (size_t)stages * gslot : sizeof(float) * (size_t)BN * pairs_rs(R));
    total = PG_ALIGN + bars + PG_BAR_BYTES;
  }
};

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// acc[i][j] += A[row i, k] B[k, col j] for one k: A from av[i] (.x, or .y
// with second), B's 8 columns of the lane from the stage's row k
__device__ __forceinline__ void fma_k(float (&acc)[8][8], const float2 (&av)[8],
                                      const float* Bk, int second) {
  const float4 b0 = *reinterpret_cast<const float4*>(Bk);
  const float4 b1 = *reinterpret_cast<const float4*>(Bk + 16);
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = second ? av[i].y : av[i].x;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
  }
}

// where residue b's k0 lands in its stage rows: its box starts at the
// 16-byte word below b K + k0 (k0 a multiple of 32)
__host__ __device__ __forceinline__ int a_off(int b, int K) { return (b * K) & 3; }

#ifdef PG_DIAG_CYCLES
#define PG_STAMP(acc, t0) ((acc) += clock64() - (t0), (t0) = clock64())
#else
#define PG_STAMP(acc, t0) ((void)0)
#endif

template <int KIND, int WM, int WN, int H>
__global__ void __launch_bounds__(32 * (WM * WN + H), 384 / (32 * (WM * WN + H)))
pairs_gemm_kernel(const __grid_constant__ CUtensorMap amap, const float* __restrict__ G,
                  const float* __restrict__ A, float* __restrict__ C, int Z, int S, int T,
                  int R, int stages, int copy_tma) {
  constexpr int BM = 64 * WM, BN = 32 * WN, CW = WM * WN, HC = BN / H, BOX = BM / 4;
  static_assert(HC % 32 == 0 && 4 % H == 0, "a helper lane owns whole columns, whole boxes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PairsLayout L(KIND, BM, BN, R, stages);
  unsigned char* base = smem_raw + ((PG_ALIGN - (smem_u32(smem_raw) & (PG_ALIGN - 1))) &
                                    (PG_ALIGN - 1));
  float* As0 = reinterpret_cast<float*>(base);
  float* Bs0 = reinterpret_cast<float*>(base + L.b);
  unsigned char* gbase = base + L.g;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(base + L.bars);
  unsigned long long* empty = full + PG_STAGES_MAX;
  unsigned long long* gfull = empty + PG_STAGES_MAX;
  const int P = num_pairs(R);
  const int M = S, N = KIND ? T : P, K = KIND ? P : T;
  const int ntm = (M + BM - 1) / BM, ntn = (N + BN - 1) / BN;
  const long long per_z = (long long)ntm * ntn, tiles = per_z * Z;
  const long long rows = (long long)Z * S, full_rows = rows / 4 * 4;  // rows a box may read
  const int nk = (K + PG_BK - 1) / PG_BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(full + s, 33 * H);  // each helper lane its copies of A, each helper its B
      bar_init(empty + s, CW);
      bar_init(gfull + s, 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

#ifdef PG_DIAG_CYCLES
  long long c0 = 0, c1 = 0, c2 = 0, c3 = 0, c4 = 0, tc = clock64();
#endif
  if (warp < CW) {  // a consumer
    const int wm = warp / WN, wn = warp - wm * WN, lm = lane >> 2, ln = lane & 3;
    // stage row r holds residue b = r / BOX at offset (b K) mod 4 (a_off)
    int arow0[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 64 * wm + lm + 8 * i;
      arow0[i] = r * PG_LDA + a_off(r / BOX, K);
    }
    const bool even_k = (K & 1) == 0;  // a_off even: 8-byte aligned pairs of k
    int s = 0;
    unsigned pass = 0;
    for (long long tau = blockIdx.x; tau < tiles; tau += gridDim.x) {
      const int z = (int)(tau / per_z);
      const int rem = (int)(tau - z * per_z), nt = rem / ntm, mt = rem - nt * ntm;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int kt = 0; kt < nk; ++kt) {
        PG_STAMP(c2, tc);
        bar_wait(full + s, pass & 1);
        PG_STAMP(c0, tc);
        const float* As = As0 + (size_t)s * BM * PG_LDA;
        const float* Bs = Bs0 + (size_t)s * PG_BK * BN + 32 * wn + 4 * ln;
        const float* arow[8];  // row 64 wm + lm + 8 i, from its first k
#pragma unroll
        for (int i = 0; i < 8; ++i) arow[i] = As + arow0[i];
        if (even_k) {  // every offset even: A two k at a time by 8-byte loads
#pragma unroll PG_UNROLL
          for (int k = 0; k < PG_BK; k += 2) {
            float2 av[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float2*>(arow[i] + k);
            fma_k(acc, av, Bs + k * BN, 0);
            fma_k(acc, av, Bs + (k + 1) * BN, 1);
          }
        } else {
#pragma unroll PG_UNROLL
          for (int k = 0; k < PG_BK; ++k) {
            float2 av[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) av[i].x = arow[i][k];
            fma_k(acc, av, Bs + k * BN, 0);
          }
        }
        __syncwarp();  // the warp's reads of the stage are done
        if (lane == 0) bar_arrive(empty + s);
        if (++s == stages) s = 0, ++pass;
        PG_STAMP(c1, tc);
      }
      // stage row r holds tile row (g - g0) = ((b - g0) mod 4) + 4 a, b = r / BOX, a = r % BOX
      const long long g0 = (long long)z * S + (long long)mt * BM;
      const int nb = nt * BN + 32 * wn + 4 * ln;
      float* Cz = C + (size_t)z * M * N;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 64 * wm + lm + 8 * i, b = r / BOX;
        const int m = mt * BM + (int)((b - g0) & 3) + 4 * (r - b * BOX);
        if (m >= M) continue;
        float* row = Cz + (size_t)m * N;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = nb + (j < 4 ? j : 12 + j);
          if (n < N) row[n] = acc[i][j];
        }
      }
      PG_STAMP(c3, tc);
    }
#ifdef PG_DIAG_CYCLES
    if (blockIdx.x == 0 && warp == 0 && lane == 0)
      printf("PG_CYCLES kind %d consumer: wait full %lld, products %lld, loop %lld, store %lld\n",
             KIND, c0, c1, c2, c3);
#endif
    return;
  }

  // a helper: issue(g), stage g's copies of A (and, helper 0, its rows of
  // G), runs `lag` stages ahead of form(g), its columns of B, so that a
  // copy's latency overlaps the stages formed meanwhile
  const int h = warp - CW, RS = pairs_rs(R), lag = stages - 2;
  const long long total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nk;
  float* panel = reinterpret_cast<float*>(gbase);  // kind 1
  long long ti = blockIdx.x, tf = blockIdx.x;     // the issue and the form cursor's tiles
  int ki = 0, kf = 0, si = 0, sf = 0;              // their k stage and ring slot
  unsigned passi = 0, passf = 0;                   // their passes of the ring
  long long gi0 = 0;                               // the issue cursor's first row z S + m0
  bool boxes = false;                              // the issue cursor's tile by boxes
  int zi = 0, zf = 0, nf0 = 0;
  int pi[HC / 32], pj[HC / 32];                    // kind 0: the pair of each of the lane's columns
  int ci = 0, cj = 0;                              // kind 1: the pair of the next k
  for (long long g = 0; g < total + lag; ++g) {
    PG_STAMP(c4, tc);
    if (g < total) {  // issue(g)
      if (ki == 0) {
        zi = (int)(ti / per_z);
        const int rem = (int)(ti - zi * per_z), nt = rem / ntm;
        gi0 = (long long)zi * S + (long long)(rem - nt * ntm) * BM;
        boxes = copy_tma && gi0 + BM <= full_rows;
      }
      PG_STAMP(c4, tc);
      if (passi > 0) bar_wait(empty + si, (passi - 1) & 1);
      PG_STAMP(c0, tc);
      const int k0 = ki * PG_BK, kn = min(PG_BK, K - k0);
      float* As = As0 + (size_t)si * BM * PG_LDA;
      if (KIND == 0 && h == 0) {  // the stage's rows of G, for every helper
        const float* gsrc = G + ((size_t)zi * T + k0) * R;
        unsigned char* slot = gbase + si * L.gslot;
        const unsigned gbytes = 4u * kn * R;
        if ((reinterpret_cast<uintptr_t>(gsrc) & 15) == 0 && (gbytes & 15) == 0) {
          // one bulk copy (no ragged ends to load first)
          bar_arrive(gfull + si, lane == 0 ? gbytes : 0u);
          if (lane == 0) bulk_copy(slot, gsrc, gbytes, gfull + si);
        } else {
          stage_spans<float>(
              1,
              [&](int, unsigned char*& sl, const float*& sr, long long& n) {
                sl = slot;
                sr = gsrc;
                n = (long long)kn * R;
              },
              gfull + si, lane);
        }
      }
      if (boxes && kn == PG_BK) {  // a box a residue b = h, h + H, ...
        if (lane == 0) {
          bar_arrive(full + si, (4 / H) * BOX * PG_LDA * sizeof(float));
          for (int b = h; b < 4; b += H) {
            const long long gb = gi0 + ((b - gi0) & 3);
            tma_load_2d(As + b * BOX * PG_LDA, &amap, b * K + k0 - a_off(b, K), (int)(gb >> 2),
                        full + si);
          }
        } else {
          bar_arrive(full + si);
        }
      } else {  // 4-byte copies, a lane a k, zero-filled past K and the tensor
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // boxes wrote this slot
        const bool kok = lane < kn;
        for (int b = h; b < 4; b += H) {
          const long long gb = gi0 + ((b - gi0) & 3);
          float* dst = As + b * BOX * PG_LDA + a_off(b, K) + lane;
          for (int a = 0; a < BOX; ++a) {
            const long long gr = gb + 4 * a;
            const bool ok = kok && gr < rows;
            const float* src = ok ? A + gr * K + k0 + lane : A;
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                             smem_u32(dst + a * PG_LDA)),
                         "l"(src), "r"(ok ? 4 : 0)
                         : "memory");
          }
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                         smem_u32(full + si))
                     : "memory");
      }
      PG_STAMP(c1, tc);
      if (++si == stages) si = 0, ++passi;
      if (++ki == nk) ki = 0, ti += gridDim.x;
    }
    if (g >= lag) {  // form(g - lag)
      if (kf == 0) {
        zf = (int)(tf / per_z);
        const int rem = (int)(tf - zf * per_z);
        nf0 = rem / ntm * BN;
        if (KIND == 0) {
#pragma unroll
          for (int q = 0; q < HC / 32; ++q) {
            const int p = nf0 + h * HC + lane + 32 * q;
            int i = 0, r = p < P ? p : P;  // past P: i = R, never read
            while (i < R && r >= R - i) r -= R - i++;
            pi[q] = i;
            pj[q] = i + r;
          }
        } else {  // the panel: G_z[n0 + c, r] at c RS + r for the helper's columns, 0 past T
          const int c0 = h * HC, lim = max(0, min(HC, T - (nf0 + c0))) * R;
          const float* src = G + ((size_t)zf * T + nf0 + c0) * R;
          int c = lane / R, r = lane - c * R;
          for (int e0 = 0; e0 < HC * R; e0 += 32 * 8) {
            float val[8];
            int cc[8], rr[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int e = e0 + lane + 32 * u;
              val[u] = e < lim ? __ldg(src + e) : 0.f;
              cc[u] = c;
              rr[u] = r;
              for (r += 32; r >= R; r -= R) ++c;
            }
#pragma unroll
            for (int u = 0; u < 8; ++u)
              if (e0 + lane + 32 * u < HC * R) panel[(c0 + cc[u]) * RS + rr[u]] = val[u];
          }
          __syncwarp();
          ci = cj = 0;
        }
      }
      PG_STAMP(c4, tc);
      const int k0 = kf * PG_BK, kn = min(PG_BK, K - k0);
      float* Bs = Bs0 + (size_t)sf * PG_BK * BN;
      if (KIND == 0) {
        bar_wait(gfull + sf, passf & 1);
        PG_STAMP(c2, tc);
        const float* gv = in_slot(gbase + sf * L.gslot, G + ((size_t)zf * T + k0) * R);
#pragma unroll
        for (int q = 0; q < HC / 32; ++q) {
          const int c = h * HC + lane + 32 * q;
          const bool live = pi[q] < R;
          const float* g1 = gv + pi[q];
          const float* g2 = gv + pj[q];
#pragma unroll
          for (int kb = 0; kb < PG_BK; kb += PG_FB) {
            float x[PG_FB], y[PG_FB];
#pragma unroll
            for (int u = 0; u < PG_FB; ++u) {
              const bool ok = live && kb + u < kn;
              x[u] = ok ? g1[(kb + u) * R] : 0.f;
              y[u] = ok ? g2[(kb + u) * R] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < PG_FB; ++u) Bs[(kb + u) * BN + c] = __fmul_rn(x[u], y[u]);
          }
        }
      } else {
#pragma unroll
        for (int kb = 0; kb < PG_BK; kb += PG_FB) {
          int ia[PG_FB], ja[PG_FB];  // the pairs of the batch's k (past P: i = R, never read)
#pragma unroll
          for (int u = 0; u < PG_FB; ++u) {
            ia[u] = ci;
            ja[u] = cj;
            if (++cj == R) cj = ++ci;
          }
#pragma unroll
          for (int q = 0; q < HC / 32; ++q) {
            const float* col = panel + (h * HC + lane + 32 * q) * RS;
            float x[PG_FB], y[PG_FB];
#pragma unroll
            for (int u = 0; u < PG_FB; ++u) {
              const bool ok = kb + u < kn;
              x[u] = ok ? col[ia[u]] : 0.f;
              y[u] = ok ? col[ja[u]] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < PG_FB; ++u)
              Bs[(kb + u) * BN + h * HC + lane + 32 * q] = __fmul_rn(x[u], y[u]);
          }
        }
      }
      __syncwarp();  // the warp's B is written
      if (lane == 0) bar_arrive(full + sf);
      PG_STAMP(c3, tc);
      if (++sf == stages) sf = 0, ++passf;
      if (++kf == nk) kf = 0, tf += gridDim.x;
    }
  }
#ifdef PG_DIAG_CYCLES
  if (blockIdx.x == 0 && h == 0 && lane == 0)
    printf("PG_CYCLES kind %d helper: wait empty %lld, copy A %lld, wait G %lld, form B %lld, "
           "other %lld\n", KIND, c0, c1, c2, c3, c4);
#endif
}

// cuTensorMapEncodeTiled, libcuda's, found through the runtime (no link
// against libcuda)
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A (Z S rows of K floats) as groups of four rows: a 2D tensor of Z S / 4
// rows of 4 K floats, boxes of `box` rows x PG_LDA floats (a box starts at
// a 16-byte word), no swizzle, zero fill.  false where A's address is not 16-byte aligned, the tensor
// has no full group, or the encoder refuses.
bool rows_map(CUtensorMap* map, const float* A, int K, long long rows, int box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(A) % 16 != 0 || rows < 4) return false;
  const cuuint64_t dim[2] = {(cuuint64_t)4 * K, (cuuint64_t)(rows / 4)};
  const cuuint64_t stride[1] = {(cuuint64_t)16 * K};
  const cuuint32_t boxdim[2] = {PG_LDA, (cuuint32_t)box};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(A), dim, stride,
                boxdim, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int KIND, int WM, int WN, int H>
cudaError_t launch_pairs_gemm(const float* G, const float* A, float* C, int Z, int S, int T,
                              int R, int grid, int stages, int copy_tma, cudaStream_t st) {
  const size_t smem = PairsLayout(KIND, 64 * WM, 32 * WN, R, stages).total;
  const int K = KIND ? num_pairs(R) : T;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (copy_tma && !rows_map(&map, A, K, (long long)Z * S, 16 * WM)) copy_tma = 0;
  cudaError_t err = cudaFuncSetAttribute(pairs_gemm_kernel<KIND, WM, WN, H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  pairs_gemm_kernel<KIND, WM, WN, H><<<grid, 32 * (WM * WN + H), smem, st>>>(
      map, G, A, C, Z, S, T, R, stages, copy_tma);
  return cudaGetLastError();
}

// One GEMM of the long-T design on the streaming GEMM: kind 0 the Gram
// (A = w), 1 v (A = Xp), at a tile shape, grid and stage count of the plan;
// copy_tma asks for A by boxes (4-byte copies where the tensor map cannot
// be made).  Refuses what the kernel cannot run: an unknown shape, stages
// outside [PG_STAGES_MIN, PG_STAGES_MAX], more than 232,448 bytes.
cudaError_t launch_pairs(int kind, int shape, const float* G, const float* A, float* C, int Z,
                         int S, int T, int R, int grid, int stages, int copy_tma,
                         cudaStream_t st) {
  if (shape < 0 || shape >= PG_SHAPES || stages < PG_STAGES_MIN || stages > PG_STAGES_MAX ||
      grid < 1 || PairsLayout(kind, pairs_bm(shape), pairs_bn(shape), R, stages).total > GS_SMEM_MAX)
    return cudaErrorInvalidValue;
  switch (PG_SHAPES * kind + shape) {
    case 0: return launch_pairs_gemm<0, 2, 4, 4>(G, A, C, Z, S, T, R, grid, stages, copy_tma, st);
    case 1: return launch_pairs_gemm<0, 1, 4, 2>(G, A, C, Z, S, T, R, grid, stages, copy_tma, st);
    case 2: return launch_pairs_gemm<0, 1, 2, 2>(G, A, C, Z, S, T, R, grid, stages, copy_tma, st);
    case 3: return launch_pairs_gemm<1, 2, 4, 4>(G, A, C, Z, S, T, R, grid, stages, copy_tma, st);
    case 4: return launch_pairs_gemm<1, 1, 4, 2>(G, A, C, Z, S, T, R, grid, stages, copy_tma, st);
    default: return launch_pairs_gemm<1, 1, 2, 2>(G, A, C, Z, S, T, R, grid, stages, copy_tma, st);
  }
}

}  // namespace

extern "C" {

// G (Z,T,R), w (Z,S,T), x0 (Z,S,R,R) or null; X (Z,S,R,R) or null in probe
// mode; resid (Z*S,); v (Z,S,T) or null.  All float32, contiguous.
int ns_gram(const float* G, const float* w, const float* x0, float* X, float* resid,
            float* v, int Z, int S, int T, int R, int iters, int use_x0,
            int resid_only, int want_v, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || Z < 1 || S < 1 || iters < 0 ||
      (resid_only && !use_x0) || (!resid_only && X == nullptr) ||
      (want_v && v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  const Layout L(R);
  const int nt = tiled_threads(R);
  const size_t smem = sizeof(float) * (3 * L.n + TC * 5 * L.nb + TC + nt / 32);
  cudaError_t err = cudaFuncSetAttribute(
      ns_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_gram_kernel<<<Z * S, nt, smem, (cudaStream_t)stream>>>(G, w, x0, X, resid, v, S, T, R,
                                                            iters, resid_only, want_v);
  return (int)cudaGetLastError();
}

// ns_gram's long-T design, with ns_gram's arguments, `pairs` (Z,S,P)
// float32 scratch, P = R (R + 1) / 2: the Gram's pairs, overwritten in place
// by Xp when want_v.  Three launches on `stream`: the Gram as a GEMM, the
// Newton-Schulz solve, and with want_v the product for v.  Each GEMM under
// the plan of ops/spd.py:pairs_plan: for the Gram (g_*) and for v (v_*) the
// streaming GEMM's tile shape (0: 128 x 128, 1: 64 x 128, 2: 64 x 64; -1:
// the tiled kernel, the rest unread), the grid, the stages and whether
// A's rows go by tensor-memory-accelerator boxes (tma; a GEMM whose A is
// not 16-byte aligned takes 4-byte copies whatever it says); `nsm` the
// card's SM count for the tiled kernel's tile shape.
int ns_gram_pairs(const float* G, const float* w, const float* x0, float* X, float* resid,
                  float* v, float* pairs, int Z, int S, int T, int R, int iters, int use_x0,
                  int resid_only, int want_v, int g_shape, int g_grid, int g_stages, int g_tma,
                  int v_shape, int v_grid, int v_stages, int v_tma, int nsm, void* stream) {
  const bool tiled = g_shape < 0 || (want_v && v_shape < 0);  // Z in the tiled grid's y
  if (R < 1 || R > RMAX || T < 1 || Z < 1 || (tiled && Z > 65535) || S < 1 || iters < 0 ||
      pairs == nullptr || nsm < 1 || (resid_only && !use_x0) || (!resid_only && X == nullptr) ||
      (want_v && v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const int P = num_pairs(R);
  cudaError_t err =
      g_shape >= 0 ? launch_pairs(0, g_shape, G, w, pairs, Z, S, T, R, g_grid, g_stages, g_tma, st)
      : wide_tiles(Z, S, P, nsm) ? launch_gram_pairs<128, 128>(G, w, pairs, Z, S, T, R, st)
                                 : launch_gram_pairs<128, 64>(G, w, pairs, Z, S, T, R, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = packed_smem(R);
  err = cudaFuncSetAttribute(ns_gram_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_gram_solve_kernel<<<Z * S, tiled_threads(R), smem, st>>>(pairs, x0, X, resid, R, iters,
                                                              resid_only, want_v);
  err = cudaGetLastError();
  if (err != cudaSuccess || !want_v) return (int)err;
  if (v_shape >= 0)
    return (int)launch_pairs(1, v_shape, G, pairs, v, Z, S, T, R, v_grid, v_stages, v_tma, st);
  return (int)(wide_tiles(Z, S, T, nsm) ? launch_v_pairs<128, 128>(G, pairs, v, Z, S, T, R, st)
                                        : launch_v_pairs<128, 64>(G, pairs, v, Z, S, T, R, st));
}

// The streaming GEMM's shared memory in bytes as the kernel lays it out
// (kind 0 the Gram, 1 v); ops/spd.py plans with its own copy, and
// chip_smoke.py holds the two equal.
int ns_pairs_smem(int kind, int shape, int R, int stages) {
  const size_t bytes = PairsLayout(kind, pairs_bm(shape), pairs_bn(shape), R, stages).total;
  return bytes < (size_t)INT_MAX ? (int)bytes : INT_MAX;
}

// ns_gram's streaming path, with ns_gram's arguments and the launch plan
// (ops/spd.py:gram_plan): `warps` consumer warps a block, `per` blocks a
// latent (grid Z per); R <= 40.
int ns_gram_stream(const float* G, const float* w, const float* x0, float* X, float* resid,
                   float* v, int Z, int S, int T, int R, int iters, int use_x0, int resid_only,
                   int want_v, int warps, int per, void* stream) {
  if (R < 1 || R > GS_R_MAX || T < 1 || Z < 1 || S < 1 || iters < 0 ||
      (resid_only && !use_x0) || (!resid_only && X == nullptr) ||
      (want_v && v == nullptr) || warps < 1 || warps > GS_WARPS_MAX || per < 1 ||
      (long long)Z * per > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  const StreamLayout L(T, R, warps);
  if (L.total > GS_SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ns_gram_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return (int)err;
  ns_gram_stream_kernel<<<Z * per, 32 * (warps + 1), L.total, (cudaStream_t)stream>>>(
      G, w, x0, X, resid, v, S, T, R, iters, resid_only, want_v, per);
  return (int)cudaGetLastError();
}

// The streaming path's shared memory in bytes as the kernel lays it out
// (at most INT_MAX); ops/spd.py plans with its own copy of the layout, and
// chip_smoke.py holds the two equal.
int ns_gram_smem(int T, int R, int warps) {
  const size_t bytes = StreamLayout(T, R, warps).total;
  return bytes < (size_t)INT_MAX ? (int)bytes : INT_MAX;
}

// A (B,R,R), x0 (B,R,R) or null; X (B,R,R) or null in probe mode; resid (B,).
int ns_packed(const float* A, const float* x0, float* X, float* resid, int B, int R,
              int iters, int use_x0, int resid_only, void* stream) {
  if (R < 1 || R > RMAX || B < 1 || iters < 0 || (resid_only && !use_x0) ||
      (!resid_only && X == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  return (int)launch_packed(A, x0, X, resid, B, R, iters, resid_only, (cudaStream_t)stream);
}

// A, x0, X (B,R,R); resid (B,): per matrix, x0's residual in a converged
// group and the refined residual in a drifted one; r0 (B,) scratch.  Two
// launches on `stream`: the probe writes r0, then the refine reads it.
int ns_packed_probe_skip(const float* A, const float* x0, float* X, float* resid, float* r0,
                         int B, int R, int per_block, int iters, void* stream) {
  if (R < 1 || R > RMAX || B < 1 || per_block < 1 || iters < 0 || x0 == nullptr ||
      X == nullptr || r0 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_packed(A, x0, nullptr, r0, B, R, 0, 1, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = packed_smem(R);
  err = cudaFuncSetAttribute(ns_probe_skip_refine_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_probe_skip_refine_kernel<<<B, tiled_threads(R), smem, st>>>(A, x0, r0, X, resid, B, R,
                                                                 per_block, iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
