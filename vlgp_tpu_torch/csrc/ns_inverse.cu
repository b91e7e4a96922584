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

#include <climits>

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
// by Xp when want_v, and the card's SM count `nsm` for the tile shape.
// Three launches on `stream`: the Gram as a GEMM, the Newton-Schulz solve,
// and with want_v the product for v.
int ns_gram_pairs(const float* G, const float* w, const float* x0, float* X, float* resid,
                  float* v, float* pairs, int Z, int S, int T, int R, int iters, int use_x0,
                  int resid_only, int want_v, int nsm, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || Z < 1 || Z > 65535 || S < 1 || iters < 0 || nsm < 1 ||
      pairs == nullptr || (resid_only && !use_x0) || (!resid_only && X == nullptr) ||
      (want_v && v == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!use_x0) x0 = nullptr;
  if (resid_only) X = nullptr;
  cudaStream_t st = (cudaStream_t)stream;
  const int P = num_pairs(R);
  cudaError_t err = wide_tiles(Z, S, P, nsm) ? launch_gram_pairs<128, 128>(G, w, pairs, Z, S, T, R, st)
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
  err = wide_tiles(Z, S, T, nsm) ? launch_v_pairs<128, 128>(G, pairs, v, Z, S, T, R, st)
                            : launch_v_pairs<128, 64>(G, pairs, v, Z, S, T, R, st);
  return (int)err;
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
