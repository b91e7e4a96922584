"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the ten sources of vlgp_tpu_torch/csrc/ with nvcc
   (sm_90a), one process each, all at once;
3. ns_gram against its plain PyTorch version on the card, at the two
   main-path shapes (E/H-step segments and the final full-length
   inference), in the cold, warm, probe and want_v modes, plus a NaN warm
   start that must be rejected; each shape in the design that
   ops/spd.py:_ns_gram_design picks for its (T, R) (per matrix at T = 50,
   the long-T "pairs" design at T = 1000); then the per-matrix design's
   two paths at the segments (Z5 S2000 T50 R40) in every mode the fit runs
   (GRAM_MODES: cold 16, cold 16 + v, cold 18, warm 4 + v, warm 8, probe +
   v, probe, iters = 0 with x0): the launch plan's streaming path bit for
   bit with the block path, both within AGREE_TOL of the plain version, the
   plan's shared memory equal to the kernel's layout, each timed as graph
   replays in turns (block, stream, stream, block) beside the plain
   version and the bound;
4. ns_packed the same way at the update_v shape and at elbo_terms' shape
   on the segments (B10000 R40, T = 50); both kernels at the shapes of a
   leave_one_neuron_out chunk of 25 neurons (ns_gram Z5 S2500 T1000 R50,
   ns_packed B12500 R50); then both kernels at
   edge shapes in every mode (R = 1, 3, 8, 17, 40, 50, 100, 127, 128 with
   T off the 32-row chunk; iters = 0 with x0; the streaming path, forced
   wherever it can run (R <= 40), bit for bit with the block path in every
   mode of GRAM_MODES); then both designs of
   ns_gram on both sides of the crossover (T = _PAIRS_MIN_T - 1 and
   _PAIRS_MIN_T, S = 131, a ragged last GEMM tile, R = 1, 17, 50, 127,
   128) in every mode; the first 100 segments of the S2500 chunk call and
   of an S2000 segment call equal, bit for bit, a call on those 100 rows
   alone (X, residual and v); and a NaN planted in one segment's w leaves
   that segment's residual NaN and every other segment finite, in both
   designs and (at Z5 S2000 T50 R40) on both per-matrix paths, bit for bit;
   inv_one_plus_gram at Z5 S100 T1000 R50 (the long-T design) and at Z5
   S2000 T50 R40 (the streaming path) captured in a CUDA graph and replayed
   from a good and a NaN carry, equal to the eager call bit for bit;
   ns_gram's long-T design with both GEMMs forced onto the streaming GEMM
   (ops/spd.py:pairs_stream_plan) bit for bit with the tiled GEMMs
   (TILED_PLAN) in cold+v, warm+v, probe+v and iters = 0 at the 9c chunk,
   S100 T1000, S500 T200 and S131 at T 100, 101, 1023 by R 1, 17, 50, 127,
   128 (and w unaligned at T100 R17), each plan's shared memory equal to
   the kernel's layout, pairs_plan's choice logged, and each GEMM timed at
   the chunk and at S100 (traces of warm 4 + v in turns, tiled, stream,
   stream, tiled) beside torch.matmul on the same operands and the bound;
5. sweep (the fused E-step) against its plain version at the flagship
   E-step shape (Z5 S2000 T50 Y100 R40, exit groups of 16) cold, from a
   real carry, from the zeros carry and with the adaptive exit (the mode
   the fit runs, timed on input draws 0, 1 and 2 with their total and
   slowest-group passes), then at edge shapes (R = 1, 50, 128, padded
   groups, a ragged mask): outputs within 1e-4 and the same sweep, pass and
   round counts per group; each call logs its cooperative grid (blocks,
   blocks per SM) and its grid syncs;
6. spd_inverse against its plain version at R = 1, 3, 17, 33, 40, 63, 64,
   65, 100, 127, 128 (B10000 and a ragged B10001 at R40), with a NaN
   matrix among finite ones and a negative pivot, timed at B10000 R40 and
   R64 and B2000 R128;
   probe_skip at B500 R50 (a ragged last group) with converged, drifted
   and NaN-carrying groups, all groups converged, all drifted, and at R17
   with only its ragged last group drifted;
   svd_loading (the loading's SVD) against its plain version (torch.linalg.svd,
   the same order and sign convention) at the flagship loading 5 x 100
   and at 1 x 1, 2 x 3, 17 x 1000, 64 x 64 and 128 x 10000, in float32 and
   float64: orthonormal rows, a vh' vh = a, descending order, the sign
   convention, the same bits on a second call, and each row against the
   plain version's where its singular value is separated; a zero row, a
   zero matrix and orthonormal rows (fully degenerate) by the invariants,
   a NaN entry NaN out; timed at 5 x 100; lorenz's kernel against the
   CPU's loop bit for bit over 20,000 steps in float64 and float32, timed
   at 101,000 steps against one call of the plain loop on the card;
   (6c, run after phase 8, whose last default fit gives it a real state)
   mstep_stats and mstep_update (csrc/mstep.cu) against their plain
   versions at the flagship segments (Z5 S2000 T50 Y100 X1, the fit's
   state), X3 (history 2), Z1 S300, Z12 S200 X2, Z 1, 5 and 8 by X 1 and
   2 and Z12 X2 in the Newton and the gradient mode with two inert
   channels, a ragged mask,
   inert channels, the gradient mode and a NaN in one channel's y (which
   must stay in that channel), in float32 and float64: each statistic and
   output within MSTEP_TOL, the whole iteration within MSTEP_ITER_TOL, the
   update's four squared norms (the M-step exit test's) within NORMS_TOL
   of torch.sum of its own outputs, both routes (the update reducing the
   partial sums, and the reduce launch of a sharded fit) and a second
   call bit for bit; hstep_search (csrc/hstep.cu, one
   thread-block cluster per latent) on the flagship C recorded from one
   H-step of the fit, polish and the profiled sigma on and off, grid 20
   with 7 shrinks and polish, Z12 at T50 and T200 (more blocks than the
   card has SMs), at T = 1, 17 and 128 in shared memory and on the wide
   path (a group of blocks to an evaluation, global scratch) at T = 139,
   150, 200, 257 and 1000 (float32) or 98, 100 and 200 (float64), with
   failing Cholesky candidates and an all-NaN latent at T50 and T200: the
   kernel's x as good as the plain version's under the plain objective
   (HSTEP_FTOL), in the same grid cell where that cell is determined, and
   the same bits in every plan the kernel can run (search_plans: cluster
   size, blocks per evaluation, the nb = 1 chain); timed at the flagship
   (the cluster, the chain and the plain version), at Z12, and at T150,
   T200 and T1000 (window=None) beside the plain version, the library's
   evaluation (cholesky_ex and two solve_triangular) times the
   evaluations, and the bound;
   (6d, after 6c on the same state) hstep_stat (csrc/hstep_stat.cu, the
   H-step's statistic) against its plain version on the first refinement
   of one H-step on the fit's segments (Z5 S2000 T50 R40), at T1000 R50
   S100 (window=None), T1 R1, T17 R17, T65 R40 and T130 R50 (ragged tiles
   of the T > 64 route), T200 R128, a ragged S301 with
   valid-0 segments and one whose w~ is 0, a NaN segment (valid 0)
   whose latent alone must come out NaN, and the T <= 64 kernel's edges
   (T 1, 13, 50, 64 by R 1, 5, 40, T; S 1, 7, 2000; Z 1, 5; a valid-0
   NaN segment), in float32 and float64: each sum
   within HSTAT_TOL of its largest |entry|, a second call bit for bit, and
   hstep_search on the kernel's C as good as on the plain C under the
   float64 objective (6c's rule); timed at the flagship (beside the plain
   version's sum_QP GEMM alone) and at T1000;
   (6e, after 6d on the same state) estep_project and estep_step
   (csrc/estep.cu, the E-step's per-sweep chain: stage a, then the Woodbury
   step and the weight refresh) against their plain versions on the first
   sweep of one E-step on the fit's segments (Z5 S2000 T50 Y100 R40) and of
   the final inference on its whole trials (Z5 S100 T1000 R50), at edge
   shapes (ESTEP_EDGES: T 1, 13, 64, 200; R 1 to 128; Z 1, 5, 8, 12, 40
   and 128; Y 37, 99, 100 and 300; X 1 and 2; a Gaussian half, a padded
   zero-noise channel and a NaN noise on a Poisson channel; a ragged mask)
   and with the clip engaged, in float32 and float64: s and w within
   ESTEP_TOL of their largest |entry|, mu and delta of the largest |mu|,
   each kernel's second call bit for bit, and bit for bit with the first
   design (the block path) wherever the launch plan streams, the plan's
   shared memory equal to the kernels' own layout; a NaN planted in one
   segment's y left in that segment alone; the first 37 segments of the
   fit's state and the first 3 trials of the final inference's, alone,
   bit for bit with the full calls (a segment's bits depend neither on S
   nor on the grid); both timed as graph replays at the flagship and at
   T1000, the plan against the first design in turns, beside the plain
   versions and the bounds; estep_step's cluster path (T1000's plan) with a
   NaN planted in the final inference and as a captured call's replay,
   equal to the eager call; ESTEP_LONG (T 100, 101, 1000, 1024 by R 1, 17,
   50, 128 by Z 1, 5, 12) and S2500 T1000 against the plain version and
   the block path bit for bit, S2500's first 37 segments alone bit for bit,
   S2500 timed against the block path in turns; the member axis at
   ESTEP_MEMBER_CASES (9c's chunk, B25 on S100 T1000, first): both kernels
   against their member plain versions, every member bit for bit with its
   own B = 1 call, B = 1 with all-ones cm bit for bit with the call
   without members, the chunk timed;
7. a small fit (4 trials x 120 bins x 10 neurons x 2 latents) on the card
   in float32 against the same fit on the CPU in float64 (exact route);
8. the main paths, each with the launch counters set to 0 just before it
   and read just after: vlgp_tpu_torch.fit on the 100 trials x 1000 bins x
   100 neurons x 5 latents workload (seed 0) by default and with the fused
   E-step sweep, in turns (default, fused, fused, default), with wall and
   E-step time, counters and the lstsq-aligned recovery R^2, the last fit
   with its ns_gram launches split by caller and mode; transform of 10
   fresh trials under the last fit's result; spd_solve at B10000 R40;
   every fit of phase 8 must launch mstep_stats, mstep_update,
   hstep_search and hstep_stat, the default fits and transform
   estep_project and estep_step, the default fits ns_gram's streaming path;
   inv_one_plus_psd from a drifted carry with the fused probe;
9. the model-selection path, each sub-phase with the counters set to 0
   just before it: (9a) fit with track_elbo=True, its ELBO series (first,
   last, decreases, where the relative change first falls under 1e-5 and
   1e-6) and the wall time of each record; (9b) elbo_terms of that fit's
   segments and full-length state on the card in float32 against the CPU
   in float64 (within ELBO_RTOL); (9c) leave_one_neuron_out over all 100
   neurons of the last default fit at batch 1, 25 and 7 (chunks of the
   held-out neurons folded into the segment axis), each with the counters
   and the peak memory statistic set to 0 just before: wall, launches, peak
   memory, each chunk's member sweeps and rounds; 100 finite scores that
   beat the latent-free baseline for most neurons, the batched scores
   within LONO_TOL of batch 1's, ns_gram and ns_packed launched,
   estep_project and estep_step once each a round, fewer ns_gram launches
   at batch 25 than at 1, peak memory rising with batch; then one batch-25
   call under torch.profiler (kernel time by kind, the elementwise share);
   (9d) sample_posterior, 1000 samples of trial 0; (9e) fastfit (GPFA warm
   start) and gmap_speckled_cv over 3, 5 and 7 factors; (9f)
   examples/tutorial_lorenz.py's recipe at the flagship widths with the
   port's lorenz (one kernel launch) and spike, fitted from factor
   analysis (R^2 >= R2_LORENZ_MIN);
10. save, load, checkpoint and the command line, each sub-phase with the
   counters set to 0 just before it: (10a) save the last default fit of
   phase 8, load it on the card (every tensor, the config and the runtime
   equal bit for bit), transform of phase 8's fresh trials under the
   loaded and the in-memory result (equal bit for bit) and resume of the
   loaded one; (10b) the default fit with path= and saving_interval=0 (one
   snapshot per EM iteration and one at the end, the file equal to
   save_params of the returned params) and a save_checkpoint /
   restore_checkpoint round trip; (10c) `python3 -m vlgp_tpu_torch fit` on
   the flagship workload and `transform` of the fresh trials as
   subprocesses, against an in-process fit with the CLI's settings (equal
   bit for bit, R^2 >= R2_CLI_MIN), with no kernel library rebuilt;
11. the sharded fit (vlgp_tpu_torch.parallel.driver.fit_sharded), each
   sub-phase with the counters set to 0 just before it: (11a) in process
   over an nccl group of one rank on the flagship workload, against fit
   with the same settings run just before, both with a callback recording
   the params at every EM iteration boundary: the params equal bit for bit
   at every boundary and converged_at equal; after the closing H-step (no
   inverse carry in fit_sharded), R^2 within R2_SHARD_GAP of fit's and the
   largest relative gap in omega and mu printed; (11b) two processes on
   the one card (this script run as `chip_smoke.py --rank R --world 2
   --port P --out F`) over a gloo group on CUDA tensors, each fitting its
   half of the segments: both ranks equal bit for bit, R^2 >= R2_MIN and
   within R2_SHARD_GAP of 11a, each rank's launches and collectives
   printed (gloo stages every collective through the host: a correctness
   check, not a multi-card speed); (11c) the same two processes on a (1, 2)
   mesh (`--mesh 1x2`): the channels split over the ranks, 50 each, all
   2000 segments on both, the fused sweep asked for (a model axis is never
   eligible for it): both ranks equal bit for bit (the replicated fields
   and the gathered channel fields), 100 channels in the result, R^2 >=
   R2_MIN and within R2_SHARD_GAP of 11a, ns_gram and ns_packed launched
   and sweep not, the all_reduces per EM iteration and the bytes by axis
   printed; (11d) the (1, 2) mesh on the first 99 of the 100 neurons
   (`--ydim 99`): rank 1 holds one padded channel, whose a, b, da and db
   stay exactly zero at every EM iteration boundary; 99 channels in the
   result and R^2 >= R2_MIN;
12. the fused and scanned EM drivers as CUDA graphs, each sub-phase with
   the counters set to 0 just before it: (12a) five EM iterations eagerly
   and with fit(fused=True), whose decision counts (sweeps, M-step
   iterations, every fallback key: host counters against the device
   counters of the replays) must be equal and whose params are compared at
   every boundary, then the 30-iteration eager and fused flagship fits
   (wall, EM loop, capture time, peak memory, R^2 within R2_GRAPH_GAP,
   ns_gram's streaming path launched),
   every replay under torch.cuda.set_sync_debug_mode("error"); (12b)
   fit(block=5) and fit(block=7) (a tail block of 2): one host read of the
   norms per block, the same converged_at; (12c) fit(fused=True) with the
   fused sweep, its cooperative launch captured; (12d) inv_one_plus_gram
   captured with a warm carry and replayed from a good and a NaN carry:
   equal to the eager call bit for bit, device fallbacks equal to the host
   ones (the NaN carry runs reject, refine and the cold restart in IF
   bodies); (12e) a small float64 fit(fused=True) on the card against the
   card's eager fit (bit for bit) and the CPU's (GRAPH64_RTOL); (12f)
   fit_sharded(block=3) over an nccl group of one rank against block=1,
   and fit_sharded(block=2) over a gloo group on CUDA tensors, which must
   raise a ValueError naming nccl; (12g) the flagship fit with
   constrain_loading="svd" eagerly, with fused=True and with block=5
   (replays under set_sync_debug_mode("error")): params equal bit for bit
   at every boundary, the same decision counts, R^2 >= R2_MIN, the EM loop
   beside the "fro" fit's; and fit_sharded(block=3) with "svd" over nccl
   at world 1 against block=1, bit for bit; then one eager and one fused fit under
   torch.profiler (kernels, busy and idle share, launch calls and host
   syncs, for the fit and its EM loop);
13. window=None (whole 1000-bin trials, so the H-step searches on the
   wide path of hstep_search): the flagship fit eagerly and with
   fit(fused=True), each with the counters set to 0 just before it: wall,
   EM loop, the H-step's share, the eager fit's searches' device time
   (each call between CUDA events), capture time, R^2 and launches; the
   fused fit's decision counts and params at every EM iteration boundary
   equal the eager fit's bit for bit.

Times are per call, each between its own pair of CUDA events, over 10
calls after a warm-up, printed as median [min-max] (mstep_update and its
plain version as replays of a captured call, whose device time is shorter
than a launch's host cost, and mstep_update's device time a launch from a
trace of 20 calls).  Ends with one JSON
line of per-kernel results (launches on their path, the worst |kernel -
plain|, the median kernel, plain and library times, and the bound computed
from this run's shapes and counts; ns_gram's streaming path in the
E-step's three modes; ns_gram and ns_packed also at 9c's
chunk shapes, with 9c's launches at batch 25; hstep_search also on its
wide path at T1000, with phase 13's launches; estep_project and estep_step
at the flagship, at T1000 (estep_step's cluster path) and at 9c's chunk
with members, with 9c's launches at batch 25) and, last, one JSON line
naming the device.  Imports nothing of JAX.
"""
import collections
import itertools
import json
import os
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RESID_TOL = 1e-2
AGREE_TOL = 1e-4  # kernel vs plain, relative to max|X|, for lambda <= 1e2
R2_MIN = 0.93
R2_FUSED_GAP = 0.01  # the fused-sweep fit's R^2 against the default fit's
EXACT_SHARE_MAX = 0.10
CORE_SHARE_MAX = 0.10  # sweep_core fallbacks per sweep route call

# NVIDIA H100 SXM peaks (data sheet, 700 W): fp32 outside the tensor cores
# and HBM3 bandwidth; a bound is the larger of FLOPs / PEAK_FLOPS and bytes
# / PEAK_BYTES
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

NTRIAL, LENGTH, YDIM, ZDIM = 100, 1000, 100, 5
# the flagship fit's settings besides the loading (bench.py's workload)
FLAGSHIP_KW = dict(b=np.full((1, YDIM), -2.0), omega=np.full(ZDIM, 1e-2), max_iter=30)

# 9b: |elbo(card, float32) - elbo(CPU, float64)| / |elbo| on one state.  The
# prior's logdet enters gp_prior_ll and the entropy with opposite signs from
# one computation, so it cancels; what is left is dominated by the float32
# Cholesky solves K^-1 C of gp_prior_ll's trace.  Their first-order error per
# (latent, trial) is ~ u T lambda_max(K) / eps_K: u = 6e-8, T = 50, lambda_max
# ~ sqrt(pi / omega) ~ 17 at omega 1e-2, eps_K = gp_noise + 1e-6 ~ 1e-4, so
# ~0.5, or ~5e3 over 5 latents x 2000 segments (100 trials at T = 1000 give
# the same): ~1e-3 of |ELBO| ~ 4.3e6.
ELBO_RTOL = 1e-3
# 9f: floor of the Lorenz fit's R^2.  vlgp_tpu in float32 on the CPU gave
# 0.881 with this recipe at these widths (0.844 at the tutorial's 10 x 500 x
# 50); the port's draws differ from JAX's, so the floor keeps a margin.
R2_LORENZ_MIN = 0.80
# 10c: floor of the command-line fit's R^2 (5 factors, no a, b or mu, so
# factor analysis starts it; the CLI's defaults: float32, 20 EM
# iterations).  tools/cli_r2_floor.py, vlgp_tpu's CLI in float32 on the CPU:
# 0.9656 on the first 20 trials at the flagship widths (1000 bins x 100
# neurons), 0.8722 on 10 trials x 500 bins x 50 neurons; the port's CLI on
# the CPU gave 0.9657 and 0.8653.  The card fits all 100 trials, so its R^2
# should not fall below the 20-trial figure; the floor keeps 0.035 under it
# for the port's draws, which differ from JAX's, and float32 on the card.
R2_CLI_MIN = 0.93
# 11: the sharded fit's R^2 against the single-device fit's.  A different
# reduction order moves the H-step's omega basin choice, and with it R^2 by
# about +-0.004 under float noise (vlgp_tpu/config.py:64-73)
R2_SHARD_GAP = 0.004
# 9c: leave_one_neuron_out's batches (the default 25, one at a time, and an
# uneven 7: 14 chunks and one of 2), and the largest |score(batch) -
# score(batch=1)| allowed, in float32 on the card.  Measured on the NVIDIA
# H100 80GB HBM3 / 700 W card: 8.94e-8 per bin at batch 25 and 7 (2.1e-7
# relative, scores ~0.45), in two runs, every neuron sweeping as often as
# alone; a member stopping one sweep apart from its count alone moved a
# float32 score by up to ~1e-4 relative on the CPU (tests/
# test_torch_lono_batched.py's state), so this bound also holds the exits
LONO_BATCHES = (1, 25, 7)
LONO_TOL = 1e-5
# 9c's trace: kernel names by kind (a name goes to the first kind it matches)
LONO_KERNEL_KINDS = (("ns_gram", ("ns_gram", "pairs_gemm")), ("ns_packed", ("ns_packed_kernel",)),
                     ("estep", ("estep_",)), ("mstep", ("mstep_",)),
                     ("hstep_search", ("hstep_search",)),
                     ("gemm", ("gemm", "Kernel2")), ("elementwise", ("elementwise", "reduce")))
ROOT = pathlib.Path(__file__).resolve().parent


def log(msg=""):
    print(msg, flush=True)


def time_ms(fn, reps=10):
    """Device time of fn() in ms over `reps` calls after one warm-up, each
    call between its own pair of CUDA events: (median, min, max)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(start.elapsed_time(end) for start, end in pairs)
    return statistics.median(ms), ms[0], ms[-1]


def graph_ms(fn, reps=10):
    """Device time of fn() in ms without the host's launch cost: fn captured
    once in a CUDA graph, the graph replayed `reps` times, each replay
    between its own pair of CUDA events (time_ms): (median, min, max)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, reps)


def fmt_ms(t):
    """'median ms [min-max]' of a time_ms result."""
    return f"{t[0]:.3f} ms [{t[1]:.3f}-{t[2]:.3f}]"


def bound(fma, nbytes):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = 2.0 * fma / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ns_gram_bound(Z, S, T, R, mode):
    """(ms, binds) of one ns_gram call in `mode` (a key of GRAM_MODES, or
    "cold", "cold+v", "warm+v": cold 16, cold 16+v, warm 4+v), FMAs
    counted as the least work of the function per matrix, in either design:
    the Gram's T P over the P = R (R + 1) / 2 pairs of its upper triangle,
    2 R^3 per iteration, R^3 for the residual, T P for v (sum over the
    pairs of Xp[p] G[t, i] G[t, j]); bytes of G, w and the residuals, x0
    read in warm and probe modes, X written except in probe mode, v written
    with +v."""
    iters, has_x0, resid_only, want_v = GRAM_MODES[_GRAM_ALIAS.get(mode, mode)]
    P = R * (R + 1) // 2
    fma = T * P + (2 * (0 if resid_only else iters) + 1) * R ** 3 + (T * P if want_v else 0)
    n_x = int(has_x0) + int(not resid_only)
    nbytes = 4 * (Z * T * R + Z * S * T + Z * S + n_x * Z * S * R * R
                  + (Z * S * T if want_v else 0))
    return bound(Z * S * fma, nbytes)


_GRAM_ALIAS = {"cold": "cold 16", "cold+v": "cold 16+v", "warm+v": "warm 4+v"}


def realistic_factor(Z, T, R, device):
    """SE prior factors as the fit builds them (Nystrom for segments,
    pivoted ichol for full-length trials) at staggered omegas."""
    from vlgp_tpu_torch.models.gp import _se_factor

    omega = torch.logspace(np.log10(6e-4), np.log10(2e-3), Z, dtype=torch.float32,
                           device=device)
    return _se_factor(T, omega, R, 1.0, torch.float32).contiguous()


def lambda_max(G, w):
    A = torch.einsum("ztr,zst,ztq->zsrq", G.double(), w.double(), G.double())
    return float(torch.linalg.eigvalsh(A).amax())


def resid64(G, w, X):
    """max|(I+A)X - I| in float64 from the float32 inputs."""
    A = torch.einsum("ztr,zst,ztq->zsrq", G.double(), w.double(), G.double())
    eye = torch.eye(A.shape[-1], dtype=torch.float64, device=A.device)
    return float(((A + eye) @ X.double() - eye).abs().amax())


# ns_gram's modes in the flagship fit (models/vlgp.py, models/gp.py):
# (iters, x0, resid_only, want_v).  The E-step's cold start, probe and warm
# refine (4 rounds, v), the H-step's cold start (18 rounds), probe and warm
# refine (8 rounds), the final inference's cold start with v, and iters = 0
# with x0 (x0 written back).
GRAM_MODES = {"cold 16": (16, False, False, False), "cold 16+v": (16, False, False, True),
              "cold 18": (18, False, False, False), "warm 4+v": (4, True, False, True),
              "warm 8": (8, True, False, False), "probe+v": (0, True, True, True),
              "probe": (0, True, True, False), "iters=0": (0, True, False, True)}


def gram_case(Z, S, T, R, device, gen):
    """ns_gram's inputs at one shape: G the fit's prior factors, w (Z, S, T)
    scaled so that lambda_max is 1e2, a warm w 2% off it, and the plain
    version's cold X of w as the carry: (G, w, w_warm, X_cold)."""
    from vlgp_tpu_torch.ops import spd

    G = realistic_factor(Z, T, R, device)
    w0 = torch.rand((Z, S, T), generator=gen, device=device, dtype=torch.float32)
    w = (w0 * (1e2 / lambda_max(G, w0))).contiguous()
    w_warm = (w * (1 + 0.02 * torch.rand(w.shape, generator=gen, device=device))).contiguous()
    return G, w, w_warm, spd._ns_gram_plain(G, w, 16)[0].contiguous()


def check_ns_gram(Z, S, T, R, device, gen):
    from vlgp_tpu_torch.ops import spd

    # the weights scaled so the well-conditioned set has lambda_max ~ 1e2
    G, w, w_warm, _ = gram_case(Z, S, T, R, device, gen)
    lam = lambda_max(G, w)
    rows, worst = [], 0.0

    def compare(mode, k, p):
        nonlocal worst
        Xk, rk, vk = k
        Xp, rp, vp = p
        torch.cuda.synchronize()
        rk = float(rk.amax())
        if not rk < RESID_TOL:
            raise AssertionError(f"ns_gram {mode} at {(Z, S, T, R)}: kernel residual {rk}")
        scale = float(Xp.abs().amax()) if Xp is not None else 1.0
        errs = []
        if Xk is not None:
            errs.append(float((Xk - Xp).abs().amax()))
        if vk is not None:
            errs.append(float((vk - vp).abs().amax()))
        err = max(errs)
        if not err <= AGREE_TOL * scale:
            raise AssertionError(f"ns_gram {mode} at {(Z, S, T, R)}: |kernel - plain| "
                                 f"{err} > {AGREE_TOL} * {scale}")
        worst = max(worst, err)
        return rk, err

    # cold (E-step first sweep / H-step cold: 16 and 18 iterations)
    cold_k = spd._ns_gram_cuda(G, w, 16, want_v=True)
    cold_p = spd._ns_gram_plain(G, w, 16, want_v=True)
    rk, err = compare("cold+v", cold_k, cold_p)
    ms = time_ms(lambda: spd._ns_gram_cuda(G, w, 16))
    pms = time_ms(lambda: spd._ns_gram_plain(G, w, 16))
    rows.append(("cold", rk, err, ms, pms))
    msv = time_ms(lambda: spd._ns_gram_cuda(G, w, 16, want_v=True))
    pmsv = time_ms(lambda: spd._ns_gram_plain(G, w, 16, want_v=True))
    rows.append(("cold+v", rk, err, msv, pmsv))

    X_cold = cold_p[0].contiguous()
    # warm refine (4 iterations, the E-step's ns_warm_iters)
    rk, err = compare("warm+v", spd._ns_gram_cuda(G, w_warm, 4, x0=X_cold, want_v=True),
                      spd._ns_gram_plain(G, w_warm, 4, x0=X_cold, want_v=True))
    rows.append(("warm+v", rk, err,
                 time_ms(lambda: spd._ns_gram_cuda(G, w_warm, 4, x0=X_cold, want_v=True)),
                 time_ms(lambda: spd._ns_gram_plain(G, w_warm, 4, x0=X_cold, want_v=True))))
    # probe: one product, no X written, v from x0
    pk = spd._ns_gram_cuda(G, w, 0, x0=X_cold, resid_only=True, want_v=True)
    if pk[0] is not None:
        raise AssertionError("probe wrote X")
    rk, err = compare("probe+v", pk,
                      spd._ns_gram_plain(G, w, 0, x0=X_cold, resid_only=True, want_v=True))
    rows.append(("probe+v", rk, err,
                 time_ms(lambda: spd._ns_gram_cuda(G, w, 0, x0=X_cold, resid_only=True, want_v=True)),
                 time_ms(lambda: spd._ns_gram_plain(G, w, 0, x0=X_cold, resid_only=True, want_v=True))))

    # NaN and garbage warm starts (the card's twin of tests/test_spd.py:195):
    # the kernel's residual for NaN must be NaN; the route must reject both
    # and land on the cold result
    x_nan = torch.full_like(X_cold, float("nan"))
    _, r_nan, _ = spd._ns_gram_cuda(G, w, 4, x0=x_nan)
    if torch.isfinite(r_nan.amax()):
        raise AssertionError(f"NaN warm start gave a finite residual {float(r_nan.amax())}")
    for name, bad in (("NaN", x_nan), ("garbage", torch.full_like(X_cold, 50.0))):
        before = dict(spd.FALLBACKS)
        Xr, vr = spd.inv_one_plus_gram(G, w, iters=16, warm=bad, warm_iters=4, want_v=True)
        if (spd.FALLBACKS["gram_probe_reject"] != before["gram_probe_reject"] + 1
                or spd.FALLBACKS["gram_refine_fail"] != before["gram_refine_fail"] + 1):
            raise AssertionError(f"{name} warm start did not reach the cold route")
        if not (torch.isfinite(Xr).all() and torch.isfinite(vr).all()):
            raise AssertionError(f"{name} warm start leaked into the route's result")
        if resid64(G, w, Xr) >= RESID_TOL:
            raise AssertionError(f"{name} warm start: route result misses the residual contract")

    # ill-conditioned (lambda ~ 1e4): the route's residual contract only
    w_ill = (w * 1e2).contiguous()
    lam_ill = lambda_max(G, w_ill)
    X_ill = spd.inv_one_plus_gram(G, w_ill, iters=16)
    r_ill = resid64(G, w_ill, X_ill)
    if not r_ill < RESID_TOL:
        raise AssertionError(f"ill-conditioned (lambda {lam_ill:.3g}): residual {r_ill}")
    log(f"ns_gram Z={Z} S={S} T={T} R={R}, {spd._ns_gram_design(T, R)} design: "
        f"lambda_max {lam:.3g}; "
        f"ill-conditioned lambda_max {lam_ill:.3g} residual (f64) {r_ill:.3g}")
    for mode, rk, err, ms, pms in rows:
        b_ms, b_by = ns_gram_bound(Z, S, T, R, mode)
        log(f"  {mode:8s} resid {rk:.3e}  |k-p| {err:.3e}  kernel {fmt_ms(ms)}  "
            f"plain {fmt_ms(pms)}  bound {b_ms:.4f} ms ({b_by})")
    return worst, rows


def gram_args(G, w, w_warm, X0, mode):
    """_ns_gram_cuda's / _ns_gram_plain's arguments for a GRAM_MODES mode:
    warm refines of w_warm from X0, probes of w at X0, cold starts of w."""
    iters, has_x0, resid_only, want_v = GRAM_MODES[mode]
    return (G, w_warm if has_x0 and not resid_only else w, iters, X0 if has_x0 else None,
            resid_only, want_v)


def same_gram(a, b):
    """ns_gram outputs (X, residuals, v) equal bit for bit, None for None."""
    return all((p is None and q is None) or (p is not None and q is not None and same_bits(p, q))
               for p, q in zip(a, b))


def check_gram_smem(lib, T, R):
    """The launch plan's shared memory (ops/spd.py) against the kernel's
    own layout (ns_gram_smem) at every warp count at (T, R)."""
    from vlgp_tpu_torch.ops import spd

    for warps in range(1, spd._GS_WARPS_MAX + 1):
        want = spd._gram_stream_smem(T, R, warps)
        got = lib.ns_gram_smem(T, R, warps)
        if got != want:
            raise AssertionError(f"ns_gram streaming layout at T={T} R={R} warps {warps}: "
                                 f"plan {want} bytes, kernel {got}")


def gram_paths_equal(G, w, w_warm, X0, tag):
    """Every GRAM_MODES mode on the streaming path (``stream_plan``, where
    the rule would stream this shape or not) and on the block path, bit for
    bit (X, residuals, v).  Returns the streaming plan."""
    from vlgp_tpu_torch.ops import spd

    Z, T, R = G.shape
    nsm = torch.cuda.get_device_properties(G.device).multi_processor_count
    plan = spd.stream_plan(T, R, Z, nsm)
    for mode in GRAM_MODES:
        args = gram_args(G, w, w_warm, X0, mode)
        if not same_gram(spd._ns_gram_cuda(*args, plan=plan),
                         spd._ns_gram_cuda(*args, plan=spd.BLOCK_PLAN)):
            raise AssertionError(f"{tag} {mode}: the streaming path ({plan}) differs from the "
                                 f"block path")
    return plan


def check_ns_gram_paths(device, gen, shape=(ZDIM, 2000, 50, 40)):
    """The per-matrix design's two paths at the flagship's segments in every
    mode of GRAM_MODES: the launch plan's streaming path against the block
    path bit for bit (X, the residuals, v), both against the plain version
    (AGREE_TOL), the plan's shared memory against the kernel's, and each
    timed as replays of a captured call, in turns (block, stream, stream,
    block), beside the plain version (replays too) and the bound.  Returns
    {mode: (block, stream, plain) graph_ms results, bound ms, binds} and
    the worst |stream - plain|."""
    from vlgp_tpu_torch.ops import _build, spd

    Z, S, T, R = shape
    G, w, w_warm, X0 = gram_case(Z, S, T, R, device, gen)
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    check_gram_smem(_build.load_library("ns_inverse"), T, R)
    rows, worst = {}, 0.0
    plan = spd.gram_plan(T, R, Z, nsm)
    if plan.path != "stream":
        raise AssertionError(f"ns_gram at {shape}: the plan {plan} does not stream")
    for mode in GRAM_MODES:
        args = gram_args(G, w, w_warm, X0, mode)
        before = spd.KERNEL_LAUNCHES["ns_gram_stream"]
        stream = spd._ns_gram_cuda(*args)
        if spd.KERNEL_LAUNCHES["ns_gram_stream"] != before + 1:
            raise AssertionError(f"ns_gram {mode}: the streaming path's count did not move")
        block = spd._ns_gram_cuda(*args, plan=spd.BLOCK_PLAN)
        plain = spd._ns_gram_plain(*args)
        torch.cuda.synchronize()
        if not same_gram(stream, block):
            raise AssertionError(f"ns_gram {mode} at {shape}: the streaming path's X, residuals "
                                 f"or v differ from the block path's")
        scale = float(X0.abs().amax())
        # X and v, and the residuals (iters = 0 leaves them above tolerance)
        err = max((float((a - b).abs().amax()) for a, b in zip(stream, plain)
                   if a is not None and a.ndim > 1), default=0.0)
        r_err = float((stream[1] - plain[1]).abs().amax())
        if not (err <= AGREE_TOL * scale and r_err <= AGREE_TOL):
            raise AssertionError(f"ns_gram {mode} at {shape}: |stream - plain| {err} (X, v), "
                                 f"{r_err} (residuals)")
        worst = max(worst, err)
        t_block = [graph_ms(lambda a=args: spd._ns_gram_cuda(*a, plan=spd.BLOCK_PLAN))]
        t_stream = [graph_ms(lambda a=args: spd._ns_gram_cuda(*a)) for _ in range(2)]
        t_block.append(graph_ms(lambda a=args: spd._ns_gram_cuda(*a, plan=spd.BLOCK_PLAN)))
        t_plain = graph_ms(lambda a=args: spd._ns_gram_plain(*a))
        b_ms, b_by = ns_gram_bound(Z, S, T, R, mode)
        rows[mode] = (t_block, t_stream, t_plain, b_ms, b_by)
        log(f"  {mode:9s} stream {plan.warps} warps {plan.per} blocks a "
            f"latent: bits as block; stream {fmt_ms(t_stream[0])} / {fmt_ms(t_stream[1])}  "
            f"block {fmt_ms(t_block[0])} / {fmt_ms(t_block[1])}  plain {fmt_ms(t_plain)}  "
            f"bound {b_ms:.4f} ms ({b_by})")
    return rows, worst


def check_ns_packed(B, R, device, gen, T=LENGTH):
    """ns_packed against its plain version at B R: the Gram matrices of Z*N =
    B (latent, trial) systems of length T, as update_v (full-length trials)
    and elbo_terms (segments) build them."""
    from vlgp_tpu_torch.ops import spd

    Z = ZDIM
    N = B // Z
    G = realistic_factor(Z, T, R, device)
    w0 = torch.rand((Z, N, T), generator=gen, device=device, dtype=torch.float32)
    w = w0 * (1e2 / lambda_max(G, w0))
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G).reshape(B, R, R).contiguous()
    A_warm = (A * 1.02).contiguous()
    rows, worst = [], 0.0

    def compare(mode, k, p):
        nonlocal worst
        torch.cuda.synchronize()
        rk = float(k[1].amax())
        if not rk < RESID_TOL:
            raise AssertionError(f"ns_packed {mode}: kernel residual {rk}")
        scale = float(p[0].abs().amax()) if p[0] is not None else 1.0
        err = float((k[0] - p[0]).abs().amax()) if k[0] is not None else \
            abs(rk - float(p[1].amax()))
        if not err <= AGREE_TOL * scale:
            raise AssertionError(f"ns_packed {mode}: |kernel - plain| {err} > {AGREE_TOL} * {scale}")
        worst = max(worst, err)
        return rk, err

    rk, err = compare("cold", spd._ns_packed_cuda(A, 16), spd._ns_packed_plain(A, 16))
    rows.append(("cold", rk, err, time_ms(lambda: spd._ns_packed_cuda(A, 16)),
                 time_ms(lambda: spd._ns_packed_plain(A, 16))))
    X_cold = spd._ns_packed_plain(A, 16)[0].contiguous()
    rk, err = compare("warm", spd._ns_packed_cuda(A_warm, 4, x0=X_cold),
                      spd._ns_packed_plain(A_warm, 4, x0=X_cold))
    rows.append(("warm", rk, err, time_ms(lambda: spd._ns_packed_cuda(A_warm, 4, x0=X_cold)),
                 time_ms(lambda: spd._ns_packed_plain(A_warm, 4, x0=X_cold))))
    pk = spd._ns_packed_cuda(A, 0, x0=X_cold, resid_only=True)
    if pk[0] is not None:
        raise AssertionError("probe wrote X")
    rk, err = compare("probe", pk, spd._ns_packed_plain(A, 0, x0=X_cold, resid_only=True))
    rows.append(("probe", rk, err,
                 time_ms(lambda: spd._ns_packed_cuda(A, 0, x0=X_cold, resid_only=True)),
                 time_ms(lambda: spd._ns_packed_plain(A, 0, x0=X_cold, resid_only=True))))
    _, r_nan = spd._ns_packed_cuda(A, 4, x0=torch.full_like(X_cold, float("nan")))
    if torch.isfinite(r_nan.amax()):
        raise AssertionError("ns_packed: NaN warm start gave a finite residual")
    # ill-conditioned (lambda ~ 1e4): the route's residual contract only
    A_ill = (A * 1e2).contiguous()
    X_ill = spd.inv_one_plus_psd(A_ill, iters=16)
    eye = torch.eye(R, dtype=torch.float64, device=device)
    r_ill = float(((A_ill.double() + eye) @ X_ill.double() - eye).abs().amax())
    if not r_ill < RESID_TOL:
        raise AssertionError(f"ns_packed route, ill-conditioned: residual {r_ill}")
    lms = time_ms(lambda: torch.linalg.inv_ex(torch.eye(R, device=device) + A))
    b_ms, b_by = bound(B * 33 * R ** 3, 4 * (2 * B * R * R + B))
    log(f"ns_packed B={B} R={R} (T={T}): ill-conditioned (lambda ~1e4) residual (f64) "
        f"{r_ill:.3g}; torch.linalg.inv_ex(I + A) {fmt_ms(lms)}; cold 16 bound {b_ms:.4f} ms "
        f"({b_by})")
    for mode, rk, err, ms, pms in rows:
        log(f"  {mode:8s} resid {rk:.3e}  |k-p| {err:.3e}  kernel {fmt_ms(ms)}  "
            f"plain {fmt_ms(pms)}")
    return worst, rows, lms


# (R, T) of the edge checks: R % 4 != 0 (1, 3, 17, 37, 39, 127), R = 8 and
# 100, the main-path widths, the 128 limit (the largest shared-memory
# footprint), T off the 32-row chunk of the streamed G, and the ends of the
# streaming path's R and T (37 with T13, 39 with T99)
EDGE_SHAPES = ((1, 1), (3, 45), (8, 33), (17, 70), (37, 13), (39, 99), (40, 50), (50, 33),
               (100, 150), (127, 150), (128, 300))


def check_edge_shapes(device, gen):
    """Both kernels at every R of EDGE_SHAPES, kernel against plain, in every
    mode: ns_gram cold+v, warm+v, probe+v and iters = 0 with x0 (X = x0
    written back bit for bit); ns_packed cold, warm and probe.  Where the
    launch plan streams ns_gram, its streaming path against the block path
    bit for bit in every mode of GRAM_MODES."""
    from vlgp_tpu_torch.ops import spd

    worst, streamed = 0.0, []
    Z, S = 2, 5
    for R, T in EDGE_SHAPES:
        G = (torch.randn((Z, T, R), generator=gen, device=device) * 0.3).contiguous()
        w0 = torch.rand((Z, S, T), generator=gen, device=device)
        w = (w0 * (1e2 / max(lambda_max(G, w0), 1.0))).contiguous()
        w_warm = (w * (1 + 0.02 * torch.rand(w.shape, generator=gen, device=device))).contiguous()
        A, A_warm = (torch.einsum("ztr,zst,ztq->zsrq", G, ww, G).reshape(Z * S, R, R).contiguous()
                     for ww in (w, w_warm))
        x0 = spd._ns_gram_plain(G, w, 16)[0].contiguous()
        xf = x0.reshape(Z * S, R, R)
        runs = [
            ("gram cold+v", spd._ns_gram_cuda(G, w, 16, want_v=True),
             spd._ns_gram_plain(G, w, 16, want_v=True)),
            ("gram warm+v", spd._ns_gram_cuda(G, w_warm, 4, x0=x0, want_v=True),
             spd._ns_gram_plain(G, w_warm, 4, x0=x0, want_v=True)),
            ("gram probe+v", spd._ns_gram_cuda(G, w, 0, x0=x0, resid_only=True, want_v=True),
             spd._ns_gram_plain(G, w, 0, x0=x0, resid_only=True, want_v=True)),
            ("gram iters=0", spd._ns_gram_cuda(G, w, 0, x0=x0, want_v=True),
             spd._ns_gram_plain(G, w, 0, x0=x0, want_v=True)),
            ("packed cold", spd._ns_packed_cuda(A, 16), spd._ns_packed_plain(A, 16)),
            ("packed warm", spd._ns_packed_cuda(A_warm, 4, x0=xf),
             spd._ns_packed_plain(A_warm, 4, x0=xf)),
            ("packed probe", spd._ns_packed_cuda(A, 0, x0=xf, resid_only=True),
             spd._ns_packed_plain(A, 0, x0=xf, resid_only=True)),
        ]
        torch.cuda.synchronize()
        scale = float(x0.abs().amax())
        for mode, k, p in runs:
            rk = float(k[1].amax())
            # X and v; a probe of ns_packed has only its residual
            errs = [float((a - b).abs().amax()) for a, b in zip(k, p)
                    if a is not None and a.ndim > 1]
            err = max(errs) if errs else abs(rk - float(p[1].amax()))
            tol = AGREE_TOL * (scale if errs else 1.0)
            if not (rk < RESID_TOL and err <= tol):
                raise AssertionError(f"{mode} at Z={Z} S={S} T={T} R={R}: residual {rk}, "
                                     f"|kernel - plain| {err} (limit {tol})")
            worst = max(worst, err)
        if not torch.equal(runs[3][1][0], x0):
            raise AssertionError(f"iters=0 did not write x0 back at R={R}")
        if spd._ns_gram_design(T, R) == "per_matrix" and spd.stream_plan(T, R, Z) is not None:
            gram_paths_equal(G, w, w_warm, x0, f"ns_gram Z={Z} S={S} T={T} R={R}")
            streamed.append((R, T))
    log(f"edge shapes (R, T) {EDGE_SHAPES}, ns_gram cold+v/warm+v/probe+v/iters=0 and "
        f"ns_packed cold/warm/probe: max |kernel - plain| {worst:.3e}; ns_gram's streaming "
        f"path bit for bit with the block path in {len(GRAM_MODES)} modes at (R, T) "
        f"{streamed}")
    return worst


# ns_gram's designs at the crossover: S one past the long-T design's 128-row
# GEMM tile plus 3 (a ragged last tile), the R that the GEMM's pair map and
# tiles meet (1, odd, the fit's, the 128 limit)
CROSS_S, CROSS_R = 131, (1, 17, 50, 127, 128)


def check_ns_gram_crossover(device, gen):
    """Both designs of ns_gram (whichever the rule picks and the other) at
    T = _PAIRS_MIN_T - 1 and _PAIRS_MIN_T, S = CROSS_S, every R of CROSS_R,
    against the plain version in cold+v, warm+v, probe+v and iters = 0 with
    x0 (x0 written back bit for bit)."""
    from vlgp_tpu_torch.ops import spd

    worst, Z, streamed = 0.0, 2, []
    T_star = spd._PAIRS_MIN_T
    for R in CROSS_R:
        for T in (T_star - 1, T_star):
            G = (torch.randn((Z, T, R), generator=gen, device=device) * 0.3).contiguous()
            w0 = torch.rand((Z, CROSS_S, T), generator=gen, device=device)
            w = (w0 * (1e2 / max(lambda_max(G, w0), 1.0))).contiguous()
            w_warm = (w * (1 + 0.02 * torch.rand(w.shape, generator=gen, device=device))
                      ).contiguous()
            x0 = spd._ns_gram_plain(G, w, 16)[0].contiguous()
            scale = float(x0.abs().amax())
            plain = {"cold+v": spd._ns_gram_plain(G, w, 16, want_v=True),
                     "warm+v": spd._ns_gram_plain(G, w_warm, 4, x0=x0, want_v=True),
                     "probe+v": spd._ns_gram_plain(G, w, 0, x0=x0, resid_only=True, want_v=True),
                     "iters=0": spd._ns_gram_plain(G, w, 0, x0=x0, want_v=True)}
            for design in ("per_matrix", "pairs"):
                kern = {"cold+v": spd._ns_gram_cuda(G, w, 16, want_v=True, design=design),
                        "warm+v": spd._ns_gram_cuda(G, w_warm, 4, x0=x0, want_v=True,
                                                    design=design),
                        "probe+v": spd._ns_gram_cuda(G, w, 0, x0=x0, resid_only=True,
                                                     want_v=True, design=design),
                        "iters=0": spd._ns_gram_cuda(G, w, 0, x0=x0, want_v=True,
                                                     design=design)}
                torch.cuda.synchronize()
                for mode, k in kern.items():
                    p = plain[mode]
                    rk = float(k[1].amax())
                    err = max(float((a - b).abs().amax()) for a, b in zip(k, p)
                              if a is not None and a.ndim > 1)
                    if not (rk < RESID_TOL and err <= AGREE_TOL * scale):
                        raise AssertionError(
                            f"ns_gram {design} {mode} at Z={Z} S={CROSS_S} T={T} R={R}: "
                            f"residual {rk}, |kernel - plain| {err} (limit {AGREE_TOL * scale})")
                    worst = max(worst, err)
                if kern["probe+v"][0] is not None:
                    raise AssertionError(f"ns_gram {design} probe wrote X")
                if not torch.equal(kern["iters=0"][0], x0):
                    raise AssertionError(f"ns_gram {design} iters=0 did not write x0 back at "
                                         f"T={T} R={R}")
            if T < T_star and spd.stream_plan(T, R, Z) is not None:
                gram_paths_equal(G, w, w_warm, x0, f"ns_gram Z={Z} S={CROSS_S} T={T} R={R}")
                streamed.append(R)
    log(f"ns_gram crossover, T {T_star - 1} ({spd._ns_gram_design(T_star - 1, 50)} by the rule) "
        f"and {T_star} ({spd._ns_gram_design(T_star, 50)}), S={CROSS_S}, R {CROSS_R}, both "
        f"designs cold+v/warm+v/probe+v/iters=0: max |kernel - plain| {worst:.3e}; at T "
        f"{T_star - 1} the streaming path bit for bit with the block path in "
        f"{len(GRAM_MODES)} modes at R {streamed}")
    return worst


def check_ns_gram_invariance(device, gen):
    """Bit for bit: the first 100 segments of an ns_gram call at the 9c
    chunk's shapes (Z5 S2500 T1000 R50) and at the segments' (Z5 S2000 T50
    R40), each in the design the rule picks, against a call on those 100
    rows alone, for X, the residual and v in cold+v, warm+v and probe+v.
    Then a NaN in one segment's w at Z5 S100 T1000 R50 in both designs and
    at Z5 S2000 T50 R40 on both paths of the per-matrix design (the
    streaming path and the block path, bit for bit): its residual NaN (and X
    and v, but a probe's v, which comes from x0), every other segment's
    finite."""
    from vlgp_tpu_torch.ops import spd

    n = NTRIAL
    for S, T, R in ((25 * NTRIAL, LENGTH, 50), (2000, 50, 40)):
        Z = ZDIM
        G = realistic_factor(Z, T, R, device)
        w0 = torch.rand((Z, S, T), generator=gen, device=device)
        w = (w0 * (1e2 / lambda_max(G, w0))).contiguous()
        x0 = spd._ns_gram_plain(G, w, 16)[0].contiguous()
        w_h, x0_h = w[:, :n].contiguous(), x0[:, :n].contiguous()
        calls = {"cold+v": lambda ww, xx: spd._ns_gram_cuda(G, ww, 16, want_v=True),
                 "warm+v": lambda ww, xx: spd._ns_gram_cuda(G, ww, 4, x0=xx, want_v=True),
                 "probe+v": lambda ww, xx: spd._ns_gram_cuda(G, ww, 0, x0=xx, resid_only=True,
                                                             want_v=True)}
        for mode, call in calls.items():
            full, head = call(w, x0), call(w_h, x0_h)
            torch.cuda.synchronize()
            same = [torch.equal(full[1].view(Z, S)[:, :n], head[1].view(Z, n)),
                    torch.equal(full[2][:, :n], head[2])]
            if full[0] is not None:
                same.append(torch.equal(full[0][:, :n], head[0]))
            if not all(same):
                raise AssertionError(f"ns_gram {mode} at Z={Z} S={S} T={T} R={R}: the first "
                                     f"{n} segments differ from a call on them alone "
                                     f"(resid, v, X equal: {same})")
        log(f"ns_gram Z={Z} S={S} T={T} R={R} ({spd._ns_gram_design(T, R)} design): the first "
            f"{n} segments equal an S={n} call bit for bit (X, residual, v) in cold+v, warm+v "
            f"and probe+v")

    # both designs at the final inference's shape, both paths of the
    # per-matrix design at the segments'
    for S, T, R, kinds in ((NTRIAL, LENGTH, 50, (dict(design="per_matrix"), dict(design="pairs"))),
                           (2000, 50, 40, (dict(), dict(plan=spd.BLOCK_PLAN)))):
        Z = ZDIM
        G = realistic_factor(Z, T, R, device)
        w0 = torch.rand((Z, S, T), generator=gen, device=device)
        w = (w0 * (1e2 / lambda_max(G, w0))).contiguous()
        x0 = spd._ns_gram_plain(G, w, 16)[0].contiguous()
        w[1, 7, 3] = float("nan")
        bad = torch.zeros((Z, S), dtype=torch.bool, device=device)
        bad[1, 7] = True
        outs = []
        for kw in kinds:
            for mode, (X, r, v) in (
                    ("cold+v", spd._ns_gram_cuda(G, w, 16, want_v=True, **kw)),
                    ("warm+v", spd._ns_gram_cuda(G, w, 4, x0=x0, want_v=True, **kw)),
                    ("probe+v", spd._ns_gram_cuda(G, w, 0, x0=x0, resid_only=True, want_v=True,
                                                  **kw))):
                torch.cuda.synchronize()
                outs.append((X, r, v))
                r = r.view(Z, S)
                # a probe's v comes from x0, which holds no NaN
                ok = (bool(torch.isnan(r[bad]).all()) and bool(torch.isfinite(r[~bad]).all())
                      and bool(torch.isfinite(v[~bad]).all())
                      and (mode == "probe+v" or bool(torch.isnan(v[bad]).all()))
                      and (X is None or (bool(torch.isnan(X[bad]).all())
                                         and bool(torch.isfinite(X[~bad]).all()))))
                if not ok:
                    raise AssertionError(f"ns_gram {kw} {mode} at T={T}: a NaN in w[1, 7] did "
                                         f"not stay in segment (1, 7)")
        if "plan" in kinds[1] and not all(same_gram(a, b) for a, b in zip(outs[:3], outs[3:])):
            raise AssertionError("ns_gram with a NaN in w[1, 7]: the streaming path differs from "
                                 "the block path")
        log(f"ns_gram Z={Z} S={S} T={T} R={R}, NaN in w[1, 7, 3]: residual NaN in segment "
            f"(1, 7) only, {' and '.join(str(kw or 'the plan') for kw in kinds)}, "
            f"cold+v/warm+v/probe+v")


def check_ns_gram_pairs_capture(device, gen):
    """ns_gram inside a CUDA graph: inv_one_plus_gram with a warm carry and v
    (its probe and checks as IF nodes) at Z5 S100 T1000 R50 (the final
    inference's route, the long-T design) and at Z5 S2000 T50 R40 (the
    E-step's, the streaming path), captured once and replayed from a good
    and a NaN carry, each replay equal bit for bit to the eager call."""
    from vlgp_tpu_torch.ops import control, spd

    for S, T, R in ((NTRIAL, LENGTH, 50), (2000, 50, 40)):
        G = realistic_factor(ZDIM, T, R, device)
        w0 = torch.rand((ZDIM, S, T), generator=gen, device=device)
        w = (w0 * (1e2 / lambda_max(G, w0))).contiguous()
        X0 = spd.inv_one_plus_gram(G, w, iters=16)
        warm = X0.clone()
        cap = control.Capturer(device)

        def f():
            return spd.inv_one_plus_gram(G, w, iters=16, warm=warm, warm_iters=4, want_v=True)

        cap.warmup(f)
        before = dict(spd.KERNEL_LAUNCHES)
        graph, out = cap.capture(f)
        captured = {k: spd.KERNEL_LAUNCHES[k] - before[k] for k in ("ns_gram", "ns_gram_stream")}
        for case, carry in (("good carry", X0), ("NaN carry", torch.full_like(X0, float("nan")))):
            warm.copy_(carry)
            graph.replay()
            X, v = f()
            if not (torch.equal(out[0], X) and torch.equal(out[1], v)):
                raise AssertionError(f"ns_gram at T={T} captured, {case}: the replay differs "
                                     f"from the eager call")
        cap.close()
        path = spd._ns_gram_design(T, R)
        if path == "per_matrix":
            nsm = torch.cuda.get_device_properties(device).multi_processor_count
            path = f"per_matrix design, {spd.gram_plan(T, R, ZDIM, nsm).path} path"
            if captured["ns_gram_stream"] == 0:
                raise AssertionError("the captured E-step route never took the streaming path")
        log(f"ns_gram Z={ZDIM} S={S} T={T} R={R} ({path}) in inv_one_plus_gram, captured "
            f"({captured} launches) and replayed from a good and a NaN carry: equal to the "
            f"eager call bit for bit")


# ns_gram's long-T design, its streaming GEMM against the tiled GEMMs:
# (Z, S, T, R) of a leave-one-neuron-out chunk, the final inference, a
# 200-bin trial set, and the crossover's edges (T 100, 101 and 1023 with
# S = CROSS_S: w's rows aligned or not, ragged tiles; R of CROSS_R: P odd,
# even and the largest)
PAIRS_SHAPES = ((ZDIM, 25 * NTRIAL, LENGTH, 50), (ZDIM, NTRIAL, LENGTH, 50), (ZDIM, 500, 200, 50),
                *((2, CROSS_S, T, R) for T in (100, 101, 1023) for R in CROSS_R))
# the GEMMs' kernels by name in a trace: (the streaming GEMM's, the tiled kernels')
PAIRS_KERNELS = {"gram": ("pairs_gemm_kernel<0", "ns_gram_pairs_kernel"),
                 "v": ("pairs_gemm_kernel<1", "ns_gram_v_kernel")}


def pairs_gemm_ms(G, w, x0, plan, calls=10):
    """Device ms a call of each GEMM of ns_gram's long-T design, warm 4 + v,
    under `plan`: {"gram": ms, "v": ms} from a trace of `calls` calls."""
    from vlgp_tpu_torch.ops import spd

    spd._ns_gram_cuda(G, w, 4, x0=x0, want_v=True, plan=plan)
    _, _, by_name = trace_kernels(lambda: [spd._ns_gram_cuda(G, w, 4, x0=x0, want_v=True,
                                                             plan=plan) for _ in range(calls)])
    col = 0 if plan.path == "stream" else 1
    return {gemm: 1e3 * sum(t for name, t in by_name.items() if names[col] in name) / calls
            for gemm, names in PAIRS_KERNELS.items()}


def check_ns_gram_pairs_paths(device, gen):
    """ns_gram's long-T design with both GEMMs on the streaming GEMM
    (pairs_stream_plan, forced at every shape) against the tiled GEMMs
    (TILED_PLAN) bit for bit, X, residual and v in cold+v, warm+v, probe+v
    and iters = 0 with x0, at every shape of PAIRS_SHAPES, and once with w
    at an address 4 bytes past a 16-byte word (the Gram's 4-byte copies);
    each plan's shared memory equal to the kernel's layout (ns_pairs_smem);
    the default plan (pairs_plan) logged at each shape.  Then each GEMM
    timed at the chunk and at S100 from traces of warm 4 + v in turns
    (tiled, stream, stream, tiled), beside torch.matmul on the same operands
    (w @ K and Xp @ K', K the pairs' products, precomputed) and the plain
    version's products (K formed, then the matmul).  Returns {shape tag:
    {gemm: row}}."""
    from vlgp_tpu_torch.ops import _build, spd

    lib = _build.load_library("ns_inverse")
    nsm = torch.cuda.get_device_properties(device).multi_processor_count
    rows = {}
    for Z, S, T, R in PAIRS_SHAPES:
        tag = f"Z{Z} S{S} T{T} R{R}"
        plan = spd.pairs_stream_plan(Z, S, T, R, nsm)
        for kind, gemm in ((0, plan.gram), (1, plan.v)):
            got = lib.ns_pairs_smem(kind, gemm.shape, R, gemm.stages)
            if got != gemm.smem:
                raise AssertionError(f"ns_gram_pairs {tag} GEMM {kind}: the plan's "
                                     f"{gemm.smem} bytes, the kernel's {got}")
        if Z == ZDIM:
            G = realistic_factor(Z, T, R, device)
        else:
            G = (torch.randn((Z, T, R), generator=gen, device=device) * 0.3).contiguous()
        w0 = torch.rand((Z, S, T), generator=gen, device=device)
        w = (w0 * (1e2 / max(lambda_max(G, w0), 1.0))).contiguous()
        w_warm = (w * (1 + 0.02 * torch.rand(w.shape, generator=gen, device=device))).contiguous()
        x0 = spd._ns_gram_plain(G, w, 16)[0].contiguous()
        cases = [("", w, w_warm)]
        if (Z, T, R) == (2, 100, 17):  # w 4 bytes past a 16-byte word
            odd = torch.empty(w.numel() + w_warm.numel() + 2, device=device)
            cases.append((" (w unaligned)", odd[1:1 + w.numel()].view_as(w).copy_(w),
                          odd[2 + w.numel():].view_as(w_warm).copy_(w_warm)))
        before = spd.KERNEL_LAUNCHES["ns_gram_pairs_stream"]
        for note, ww, wwarm in cases:
            calls = {"cold+v": lambda p: spd._ns_gram_cuda(G, ww, 16, want_v=True, plan=p),
                     "warm+v": lambda p: spd._ns_gram_cuda(G, wwarm, 4, x0=x0, want_v=True, plan=p),
                     "probe+v": lambda p: spd._ns_gram_cuda(G, ww, 0, x0=x0, resid_only=True,
                                                            want_v=True, plan=p),
                     "iters=0": lambda p: spd._ns_gram_cuda(G, ww, 0, x0=x0, want_v=True, plan=p)}
            for mode, call in calls.items():
                new, old = call(plan), call(spd.TILED_PLAN)
                torch.cuda.synchronize()
                if not same_gram(new, old):
                    raise AssertionError(f"ns_gram_pairs {tag}{note} {mode}: the streaming GEMM "
                                         f"differs from the tiled path ({plan})")
        if spd.KERNEL_LAUNCHES["ns_gram_pairs_stream"] != before + 4 * len(cases):
            raise AssertionError(f"ns_gram_pairs {tag}: the forced plan's calls did not all take "
                                 f"the streaming GEMM")
        default = spd.pairs_plan(Z, S, T, R, nsm)
        log(f"ns_gram_pairs {tag}: by default "
            + ", ".join(f"{name} on the {'streaming' if g else 'tiled'} GEMM"
                        for name, g in (("Gram", default.gram), ("v", default.v))))
        if (Z, T) != (ZDIM, LENGTH):
            continue
        i, j = torch.triu_indices(R, R, device=device)
        K = (G[:, :, i] * G[:, :, j]).contiguous()
        Xp = torch.randn((Z, S, R * (R + 1) // 2), generator=gen, device=device)
        library = {"gram": time_ms(lambda: torch.matmul(w, K)),
                   "v": time_ms(lambda: torch.matmul(Xp, K.mT))}
        plain = {"gram": time_ms(lambda: w @ (G[:, :, i] * G[:, :, j])),
                 "v": time_ms(lambda: Xp @ (G[:, :, i] * G[:, :, j]).mT)}
        turns = [pairs_gemm_ms(G, w, x0, p) for p in (spd.TILED_PLAN, plan, plan, spd.TILED_PLAN)]
        P = R * (R + 1) // 2
        rows[tag] = {}
        for name, gemm, N in (("gram", plan.gram, P), ("v", plan.v, T)):
            b_ms, b_by = bound(Z * S * T * P, 4 * (Z * T * R + Z * S * (T + P)))
            stream = [t[name] for t in turns[1:3]]
            tiled = [turns[0][name], turns[3][name]]
            rows[tag][name] = dict(ms=min(stream), tiled_ms=min(tiled), plain_ms=plain[name][0],
                                   library_ms=library[name][0], bound_ms=b_ms, bound_by=b_by,
                                   gemm=gemm)
            log(f"ns_gram_pairs {tag} {name} GEMM (M {S}, N {N}, K {(T, P)[name == 'v']}): "
                f"streaming {gemm.bm}x{gemm.bn} tiles, {gemm.grid} blocks, {gemm.stages} "
                f"stages, {gemm.copy} copies {' / '.join(f'{t:.4f}' for t in stream)} ms; "
                f"tiled {' / '.join(f'{t:.4f}' for t in tiled)} ms (in turns, warm 4 + v, "
                f"device time a call); torch.matmul {fmt_ms(library[name])}; plain (K formed, "
                f"then matmul) {fmt_ms(plain[name])}; bound {b_ms:.4f} ms ({b_by})")
    log(f"ns_gram_pairs: the streaming GEMM bit for bit with the tiled path (X, residual, v) "
        f"in cold+v/warm+v/probe+v/iters=0 at {len(PAIRS_SHAPES)} shapes "
        f"({', '.join(f'Z{z} S{s} T{t} R{r}' for z, s, t, r in PAIRS_SHAPES[:3])}, and S"
        f"{CROSS_S} at T 100/101/1023 by R {CROSS_R}; w unaligned at T100 R17); each plan's "
        f"bytes equal to the kernel's")
    return rows


def sweep_inputs(Z, S, T, Y, R, device, gen, ragged=False):
    """E-step operands as the fit hands them to the sweep: SE prior factors,
    Poisson counts of smooth latents, a -2 bias, a small initial posterior
    and the weights update_w gives it.  ``ragged`` ends a third of the
    segments early (mask 0)."""
    G = realistic_factor(Z, T, R, device)
    a = torch.randn((Z, Y), generator=gen, device=device) * 0.3
    t = torch.linspace(0, 1, T, device=device)
    phase = torch.rand((S, 1, Z), generator=gen, device=device) * 6.283
    freq = torch.arange(1, Z + 1, device=device, dtype=torch.float32)
    lat = torch.sin(phase + 6.283 * freq * t[None, :, None])
    mask = torch.ones((S, T), device=device)
    if ragged:
        mask[S // 3:, T // 2:] = 0.0
    y = torch.poisson(torch.exp(lat @ a - 2.0), generator=gen) * mask[..., None]
    xb = torch.full((S, T, Y), -2.0, device=device)
    muz = 0.1 * torch.randn((Z, S, T), generator=gen, device=device) * mask
    vz = torch.full((Z, S, T), 0.05, device=device) * mask
    eta = torch.einsum("zst,zy->sty", muz, a) + xb
    r = torch.exp(torch.clamp(eta + torch.einsum("zst,zy->sty", vz, 0.5 * a * a), max=10.0))
    wz = torch.einsum("sty,zy->zst", r, a * a) * mask
    noise = torch.ones(Y, device=device)
    poisson = torch.ones(Y, dtype=torch.bool, device=device)
    return [y, xb, mask, a, noise, poisson, G, muz, wz, vz]


def sweep_work(args, counts, bs, vb, carry):
    """FMAs and bytes this run's sweep needed, from its per-group counts."""
    y, Z, T, R = args[0], args[6].shape[0], args[6].shape[1], args[6].shape[2]
    S, Y = y.shape[0], y.shape[2]
    sweeps, passes, rounds = (float(c) for c in counts.double().sum(0))
    per = Z * bs  # matrices per group
    fma = per * (passes * (T * R * R + R ** 3) + rounds * 2 * R ** 3)
    fma += sweeps * per * (4 * T * R + R * R + (T * R * R + T * R if vb else 0))
    fma += sweeps * bs * T * Y * 5 * Z  # both row stages: eta, arg, projections
    nbytes = 4 * (2 * S * T * Y + S * T + 3 * Z * S * T + Z * T * R + 2 * Z * Y)
    nbytes += 4 * (4 * Z * S * T + Z * S * R * R) + (4 * Z * S * R * R if carry else 0)
    return fma, nbytes


def check_sweep(device, gen, shape=(ZDIM, 2000, 50, YDIM, 40)):
    """The sweep kernel against its plain version: the flagship E-step shape
    in four modes, the mode the fit runs (real carry, adaptive) also on input
    draws 1 and 2, then edge shapes; each call with its cooperative grid and
    grid syncs.  Returns (worst error, ms, plain ms, bound ms, bound_by) of
    the mode the fit runs on draw 0."""
    from vlgp_tpu_torch.config import Config
    from vlgp_tpu_torch.ops import sweep as sw

    cfg = Config()
    worst = 0.0

    def run(tag, args, xinv, niter, tol, vb=True):
        nonlocal worst
        Z, T, R = args[6].shape
        bs = sw._pick_bs(Z, T, args[0].shape[-1], R)
        kw = dict(niter=niter, tol=tol, dmu_bound=cfg.dmu_bound, ns_iters=cfg.ns_iters,
                  ns_warm_iters=cfg.ns_warm_iters, vb=vb, bs=bs)
        grid = {}
        k = sw._sweep_cuda(*args, xinv, **kw, grid=grid)
        p = sw._sweep_plain(*args, xinv, **kw)
        torch.cuda.synchronize()
        rk = float(k[5].amax())
        if not rk < RESID_TOL:
            raise AssertionError(f"sweep {tag}: kernel residual {rk}")
        if not torch.equal(k[6], p[6]):
            raise AssertionError(f"sweep {tag}: counts differ, kernel {k[6].tolist()} "
                                 f"plain {p[6].tolist()}")
        mu_scale = float(p[0].abs().amax())
        errs = {}
        for i, name in enumerate(("mu", "w", "v", "dmu", "X")):
            scale = mu_scale if name in ("mu", "dmu") else float(p[i].abs().amax())
            err = float((k[i] - p[i]).abs().amax())
            if not err <= AGREE_TOL * max(scale, 1e-30):
                raise AssertionError(f"sweep {tag}: |kernel - plain| of {name} {err} > "
                                     f"{AGREE_TOL} * {scale}")
            worst = max(worst, err)
            errs[name] = err
        c = k[6].double()
        grid = {name: int(t) for name, t in grid.items()}
        log(f"  sweep {tag}: resid {rk:.3e}, sweeps per group {int(c[:, 0].min())}-"
            f"{int(c[:, 0].max())}, passes {int(c[:, 1].sum())} (slowest group "
            f"{int(c[:, 1].max())}), NS rounds {int(c[:, 2].sum())} (slowest group "
            f"{int(c[:, 2].max())}); max |k-p| {max(errs.values()):.3e}; grid "
            f"{grid['blocks']} blocks ({grid['blocks_per_sm']} per SM), "
            f"{grid['syncs']} grid syncs")
        return k, p, kw

    # the flagship E-step on three input draws: the time should follow the
    # draw's total passes, not its slowest group's
    Z, S, T, Y, R = shape
    draws = []
    for seed in (0, 1, 2):
        args = sweep_inputs(Z, S, T, Y, R, device, gen.manual_seed(seed))
        log(f"sweep Z={Z} S={S} T={T} Y={Y} R={R}, exit groups of "
            f"{sw._pick_bs(Z, T, Y, R)}, input draw {seed}:")
        k, _, _ = run("cold, 4 sweeps", args, None, 4, 0.0)
        carry = k[4].contiguous()
        if seed == 0:
            run("zeros carry, 4 sweeps", args, torch.zeros_like(carry), 4, 0.0)
            run("real carry, 4 sweeps", args, carry, 4, 0.0)
        k, _, kw = run(f"real carry, tol {cfg.estep_tol}", args, carry, cfg.Eniter,
                       cfg.estep_tol)
        ms = time_ms(lambda: sw._sweep_cuda(*args, carry, **kw))
        pms = time_ms(lambda: sw._sweep_plain(*args, carry, **kw))
        b_ms, b_by = bound(*sweep_work(args, k[6], kw["bs"], True, True))
        passes = k[6][:, 1]
        log(f"  sweep real carry, tol {cfg.estep_tol}, draw {seed}: kernel {fmt_ms(ms)}, "
            f"plain {fmt_ms(pms)}, bound {b_ms:.4f} ms ({b_by}); passes {int(passes.sum())}, "
            f"slowest group {int(passes.max())}")
        draws.append((ms, pms, b_ms, b_by))
        if seed == 0:
            cold_kw = dict(kw, niter=4, tol=0.0)
            log(f"  sweep cold, 4 sweeps: kernel "
                f"{fmt_ms(time_ms(lambda: sw._sweep_cuda(*args, None, **cold_kw)))}, plain "
                f"{fmt_ms(time_ms(lambda: sw._sweep_plain(*args, None, **cold_kw)))}")
    ms, pms, b_ms, b_by = draws[0]
    for shape, ragged in (((2, 37, 64, 7, 50), False), ((3, 45, 33, 11, 16), True),
                          ((1, 30, 130, 5, 128), False), ((1, 10, 60, 3, 1), False)):
        eargs = sweep_inputs(*shape, device, gen, ragged=ragged)
        tag = "Z{} S{} T{} Y{} R{}".format(*shape) + (" ragged" if ragged else "")
        k, _, _ = run(tag + ", MAP", eargs, None, 3, 0.0, vb=False)
        run(tag + ", carry, adaptive", eargs, k[4].contiguous(), 12, 1e-3)
    return worst, ms, pms, b_ms, b_by


def spd_batch(B, R, device, gen):
    """B SPD matrices with eigenvalues in [1, ~1e2]."""
    Gm = torch.randn((B, R, R), generator=gen, device=device)
    return (Gm @ Gm.mT * (1e2 / (4 * R)) + torch.eye(R, device=device)).contiguous()


def spd_inverse_bound(B, R):
    """The spd_inverse bound at (B, R): FMAs of the TPU kernel's algorithm
    (Cholesky sum_j (R-1-j)^2, substitution sum_j j R, product R^3) against
    A read and A^-1 written once."""
    fma = B * (sum((R - 1 - j) ** 2 for j in range(R)) + R * R * (R - 1) / 2 + R ** 3)
    return bound(fma, 2 * 4 * B * R * R)


# (B, R) of the spd_inverse checks: odd R (the 4-byte loads), the team
# boundaries at 32, 64 and 65, the 128 limit, and a batch that is a multiple
# of neither the teams per block nor the team count (B10001 at R40)
SPD_SHAPES = ((10000, 40), (10001, 40), (203, 1), (203, 3), (203, 17), (203, 33),
              (203, 63), (2000, 64), (61, 65), (61, 100), (61, 127), (61, 128))


def check_spd_inverse(device, gen):
    """spd_inverse kernel against its plain version at every (B, R) of
    SPD_SHAPES, a NaN matrix among finite ones at R40 and R100, and the
    negative-pivot matrix; timed with its bound at B10000 R40, B10000 R64
    and B2000 R128.  Returns (worst error, ms, plain ms, library ms, bound
    ms, bound_by) at B10000 R40."""
    from vlgp_tpu_torch.ops import spd

    worst = 0.0

    def compare(A, tag, finite=None):
        """kernel against plain; `finite` (a bool mask over the batch) picks
        the matrices held to the contract, the others must be NaN-bearing in
        both."""
        nonlocal worst
        R = A.shape[-1]
        k = spd._spd_inverse_cuda(A)
        p = spd._spd_inverse_plain(A)
        torch.cuda.synchronize()
        if finite is not None:
            for name, out in (("kernel", k), ("plain", p)):
                bad = torch.isnan(out).flatten(1).any(1)
                if not torch.equal(bad, ~finite):
                    raise AssertionError(f"spd_inverse {tag}: {name} NaN in matrices "
                                         f"{bad.nonzero().flatten().tolist()}")
            A, k, p = A[finite], k[finite], p[finite]
        scale = float(p.abs().amax())
        err = float((k - p).abs().amax())
        eye = torch.eye(R, dtype=torch.float64, device=device)
        r64 = float((A.double() @ k.double() - eye).abs().amax())
        if not (err <= AGREE_TOL * scale and r64 < RESID_TOL and torch.isfinite(k).all()):
            raise AssertionError(f"spd_inverse {tag}: |kernel - plain| {err} "
                                 f"(max|X| {scale}), residual {r64}")
        worst = max(worst, err)
        return err, r64

    for B, R in SPD_SHAPES:
        err, r64 = compare(spd_batch(B, R, device, gen), f"B={B} R={R}")
        log(f"spd_inverse B={B} R={R}: |k-p| {err:.3e}, residual (f64) {r64:.3e}")
    for B, R in ((9, 40), (9, 100)):
        A = spd_batch(B, R, device, gen)
        A[4, R // 2, R // 3] = A[4, R // 3, R // 2] = float("nan")
        finite = torch.arange(B, device=device) != 4
        err, _ = compare(A, f"B={B} R={R}, NaN in matrix 4", finite)
        log(f"spd_inverse B={B} R={R}, NaN in matrix 4: NaN there only, |k-p| {err:.3e} "
            f"on the others")
    # a negative pivot is clamped at 1e-30, not a NaN (tests/test_torch_spd.py)
    A = torch.diag(torch.tensor([2.0, -1.0, 3.0], device=device))[None].contiguous()
    k, p = spd._spd_inverse_cuda(A), spd._spd_inverse_plain(A)
    if not (torch.isfinite(k).all() and torch.allclose(k, p, rtol=1e-5, atol=0.0)):
        raise AssertionError(f"spd_inverse negative pivot: kernel {k.tolist()}, "
                             f"plain {p.tolist()}")
    log(f"spd_inverse negative pivot diag(2, -1, 3): kernel diagonal "
        f"{torch.diagonal(k[0]).tolist()}, as the plain version")

    timed = {}
    for B, R in ((10000, 40), (10000, 64), (2000, 128)):
        A = spd_batch(B, R, device, gen)
        ms = time_ms(lambda: spd._spd_inverse_cuda(A))
        pms = time_ms(lambda: spd._spd_inverse_plain(A))
        lms = time_ms(lambda: torch.linalg.inv_ex(A))
        b_ms, b_by = spd_inverse_bound(B, R)
        log(f"  spd_inverse B={B} R={R}: kernel {fmt_ms(ms)}, plain {fmt_ms(pms)}, "
            f"torch.linalg.inv_ex {fmt_ms(lms)}, bound {b_ms:.4f} ms ({b_by})")
        timed[R] = (ms, pms, lms, b_ms, b_by)
    return (worst,) + timed[40]


def probe_skip_case(A, X, drifted, nan_at, iters, tag):
    """probe_skip from x0 = X (converged) in the groups where `drifted` is
    false and 0.97 X elsewhere, with one NaN matrix at `nan_at` (or none);
    kernel against plain.  A converged group must return x0 bit for bit, NaN
    residuals must sit where the plain version's do, and every group without
    a NaN must agree within AGREE_TOL.  Returns the worst error."""
    from vlgp_tpu_torch.ops import spd

    B, R = A.shape[0], A.shape[-1]
    group = torch.arange(B, device=A.device) // spd._probe_skip_groups(R)
    move = drifted[group]
    x0 = torch.where(move[:, None, None], X * 0.97, X).contiguous()
    if nan_at is not None:
        x0[nan_at] = float("nan")
        move = move | (group == group[nan_at])
    k = spd._ns_packed_cuda(A, iters, x0=x0, probe_skip=True)
    p = spd._ns_packed_plain(A, iters, x0=x0, probe_skip=True)
    torch.cuda.synchronize()
    if not torch.equal(k[0][~move], x0[~move]):
        raise AssertionError(f"probe_skip {tag}: a converged group did not return x0 bit for bit")
    nan_k, nan_p = torch.isnan(k[1]), torch.isnan(p[1])
    if not torch.equal(nan_k, nan_p) or (nan_at is not None and not bool(nan_k[nan_at])):
        raise AssertionError(f"probe_skip {tag}: NaN residuals differ from the plain version")
    fin = torch.ones(B, dtype=torch.bool, device=A.device) if nan_at is None else \
        group != group[nan_at]
    scale = float(p[0][fin].abs().amax())
    err = max(float((k[0][fin] - p[0][fin]).abs().amax()),
              float((k[1][fin] - p[1][fin]).abs().amax()))
    if not (err <= AGREE_TOL * scale and float(k[1][fin].amax()) < RESID_TOL):
        raise AssertionError(f"probe_skip {tag}: |kernel - plain| {err} (max|X| {scale})")
    log(f"  probe_skip {tag}: {int(move.sum())} of {B} matrices refined, |k-p| {err:.3e}")
    return err


def check_probe_skip(device, gen):
    """probe_skip kernel against its plain version at B500 R50 (21 groups of
    24, the last ragged with 20): even groups converged and odd drifted with
    one NaN matrix in group 3, every group converged, every group drifted;
    then R17 B200 (groups of 84, the last ragged with 32) with only the
    ragged group drifted.  Returns (worst error, ms, plain ms, library ms,
    bound ms, bound_by) of the first case."""
    from vlgp_tpu_torch.ops import spd

    B, R, iters = ZDIM * NTRIAL, 50, 4
    Z, N = ZDIM, NTRIAL
    G = realistic_factor(Z, LENGTH, R, device)
    w0 = torch.rand((Z, N, LENGTH), generator=gen, device=device)
    w = w0 * (1e2 / lambda_max(G, w0))
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G).reshape(B, R, R).contiguous()
    X = spd._ns_packed_plain(A, 16)[0]
    per = spd._probe_skip_groups(R)
    ngroup = -(-B // per)
    odd = torch.arange(ngroup, device=device) % 2 == 1
    log(f"probe_skip B={B} R={R}, groups of {per}:")
    err = probe_skip_case(A, X, odd, 3 * per + 1, iters, "odd groups drifted, one NaN")
    err = max(err, probe_skip_case(A, X, torch.zeros_like(odd), None, iters, "all converged"))
    err = max(err, probe_skip_case(A, X, torch.ones_like(odd), None, iters, "all drifted"))
    B17, R17 = 200, 17
    Gm = torch.randn((B17, R17, R17), generator=gen, device=device)
    A17 = (Gm @ Gm.mT * (1e2 / (4 * R17))).contiguous()
    X17 = spd._ns_packed_plain(A17, 16)[0]
    last = torch.arange(-(-B17 // spd._probe_skip_groups(R17)), device=device)
    err = max(err, probe_skip_case(A17, X17, last == last[-1], None, iters,
                                   f"B={B17} R={R17}, ragged last group drifted"))

    group = torch.arange(B, device=device) // per
    x0c = torch.where((group % 2 == 1)[:, None, None], X * 0.97, X).contiguous()
    ms = time_ms(lambda: spd._ns_packed_cuda(A, iters, x0=x0c, probe_skip=True))
    pms = time_ms(lambda: spd._ns_packed_plain(A, iters, x0=x0c, probe_skip=True))
    eye = torch.eye(R, device=device)
    lms = time_ms(lambda: torch.linalg.inv_ex(eye + A))
    drifted = int((group % 2 == 1).sum())
    fma = (B - drifted) * R ** 3 + drifted * (2 * iters + 1) * R ** 3
    b_ms, b_by = bound(fma, 4 * (3 * B * R * R + B))
    log(f"  probe_skip B={B} R={R} ({drifted} drifted matrices): kernel {fmt_ms(ms)}, "
        f"plain {fmt_ms(pms)}, torch.linalg.inv_ex(I + A) {fmt_ms(lms)}, "
        f"bound {b_ms:.4f} ms ({b_by})")
    return err, ms, pms, lms, b_ms, b_by


# svd_loading's edge shapes (Z, Y) beside the flagship loading: one entry,
# Y just above Z, an odd Z with long rows, a square matrix (its smallest
# singular values near 0), and the Z limit with long rows
SVD_SHAPES = ((ZDIM, YDIM), (1, 1), (2, 3), (17, 1000), (64, 64), (128, 10000))
# the kernel's rows: max |vh vh' - I| and max |a vh' vh - a| / max |a|, by
# dtype (the kernel works in float64 and rounds its rows once or twice)
SVD_ORTH_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}
# the kernel against torch.linalg.svd row by row only where a row's singular
# value stands more than SVD_GAP_MIN of the largest from its neighbours (a
# singular vector moves by ~ eps s_max / gap); both within SVD_DIRECT_TOL
SVD_GAP_MIN = 1e-2
SVD_DIRECT_TOL = {torch.float32: 1e-4, torch.float64: 1e-9}
# NVIDIA H100 SXM float64 outside the tensor cores (data sheet, 700 W): the
# svd_loading kernel computes in float64
PEAK_FLOPS64 = 34e12


def svd_invariants(a, vh, tag):
    """Raise unless the kernel's vh holds its invariants for a: shape,
    dtype, finite, orthonormal rows, a vh' vh = a, descending |a vh_k'|, the
    largest entry of each row positive.  Returns (orthonormality,
    projection) errors."""
    Z, Y = a.shape
    K = min(Z, Y)
    tol = SVD_ORTH_TOL[a.dtype]
    if tuple(vh.shape) != (K, Y) or vh.dtype != a.dtype or not bool(torch.isfinite(vh).all()):
        raise AssertionError(f"svd_loading {tag}: {tuple(vh.shape)} {vh.dtype}, or not finite")
    v, a64 = vh.double(), a.double()
    orth = float((v @ v.T - torch.eye(K, dtype=torch.float64, device=v.device)).abs().max())
    proj = float((a64 @ v.T @ v - a64).abs().max() / a64.abs().max().clamp_min(1e-300))
    s = torch.linalg.norm(a64 @ v.T, dim=0)
    desc = bool((s[:-1] >= s[1:] - tol * s[0]).all())
    pos = bool((v[torch.arange(K, device=v.device), v.abs().argmax(dim=1)] > 0).all())
    if not (orth <= tol and proj <= tol and desc and pos):
        raise AssertionError(f"svd_loading {tag}: orthonormality {orth:.2e}, projection "
                             f"{proj:.2e} (tol {tol:.0e}), descending {desc}, sign "
                             f"convention {pos}")
    return orth, proj


def svd_direct(a, vh, ref):
    """(max |kernel - plain| over the rows whose singular value is
    separated, number of such rows)."""
    sv = torch.linalg.svdvals(a.double()).tolist()
    K, floor = len(sv), SVD_GAP_MIN * sv[0]
    rows = [k for k in range(K) if sv[k] > floor
            and (k == 0 or sv[k - 1] - sv[k] > floor) and (k == K - 1 or sv[k] - sv[k + 1] > floor)]
    if not rows:
        return 0.0, 0
    return float((vh[rows].double() - ref[rows].double()).abs().max()), len(rows)


def check_svd_loading(device, gen):
    """svd_loading (the kernel) against its plain version (torch.linalg.svd
    with the same order and sign convention) at the flagship loading and
    the edge shapes in float32 and float64, random normal entries; then a
    zero row, a zero matrix, orthonormal rows (fully degenerate singular
    values) and a NaN entry.  Times the flagship shape.  Returns (max
    |kernel - plain| over the direct comparisons, kernel, plain and
    torch.linalg.svd times, bound ms, what binds)."""
    from vlgp_tpu_torch.ops.linalg import _svd_loading_plain, svd_loading

    err = 0.0
    for dtype in (torch.float32, torch.float64):
        for Z, Y in SVD_SHAPES:
            a = torch.randn((Z, Y), generator=gen, device=device, dtype=dtype)
            vh = svd_loading(a)
            torch.cuda.synchronize()
            orth, proj = svd_invariants(a, vh, f"{Z}x{Y} {dtype}")
            d, nrows = svd_direct(a, vh, _svd_loading_plain(a))
            if d > SVD_DIRECT_TOL[dtype]:
                raise AssertionError(f"svd_loading {Z}x{Y} {dtype}: {d:.2e} from the plain "
                                     f"version over {nrows} separated rows")
            if not torch.equal(svd_loading(a), vh):
                raise AssertionError(f"svd_loading {Z}x{Y} {dtype}: two calls differ")
            err = max(err, d)
            log(f"  svd_loading {Z}x{Y} {str(dtype)[6:]}: orthonormality {orth:.2e}, "
                f"projection {proj:.2e}, |kernel - plain| {d:.2e} over {nrows} of "
                f"{vh.shape[0]} rows (separated), repeat bit for bit")
        special = {}
        a = torch.randn((ZDIM, YDIM), generator=gen, device=device, dtype=dtype)
        a[2] = 0.0
        special["zero row 2 of 5x100"] = a
        a = torch.randn((2, 3), generator=gen, device=device, dtype=dtype)
        a[0] = 0.0
        special["zero row 0 of 2x3"] = a
        special["zero 3x7"] = torch.zeros((3, 7), device=device, dtype=dtype)
        q, _ = torch.linalg.qr(torch.randn((YDIM, ZDIM), generator=gen, device=device,
                                           dtype=torch.float64))
        special["orthonormal rows 5x100"] = q.T.contiguous().to(dtype)
        for tag, a in special.items():
            vh = svd_loading(a)
            torch.cuda.synchronize()
            orth, proj = svd_invariants(a, vh, f"{tag} {dtype}")
            log(f"  svd_loading {tag} {str(dtype)[6:]}: finite, orthonormality {orth:.2e}, "
                f"projection {proj:.2e}")
        a = torch.randn((ZDIM, YDIM), generator=gen, device=device, dtype=dtype)
        a[1, 3] = float("nan")
        vh = svd_loading(a)
        torch.cuda.synchronize()
        if not bool(torch.isnan(vh).all()):
            raise AssertionError(f"svd_loading: a NaN entry did not give a NaN vh ({dtype})")
        log(f"  svd_loading NaN at (1, 3) {str(dtype)[6:]}: returned, vh all NaN")
    a = torch.randn((ZDIM, YDIM), generator=gen, device=device)
    ms = time_ms(lambda: svd_loading(a))
    pms = time_ms(lambda: _svd_loading_plain(a))
    lms = time_ms(lambda: torch.linalg.svd(a, full_matrices=False))
    # the work every route needs, float64 FMAs: the Gram, the rows V' a and
    # their norms; bytes: a read once, vh written once
    fma = ZDIM * (ZDIM + 1) // 2 * YDIM + ZDIM * ZDIM * YDIM + ZDIM * YDIM
    t_ops, t_bytes = 2.0 * fma / PEAK_FLOPS64, 4 * 2 * ZDIM * YDIM / PEAK_BYTES
    b_ms, b_by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    log(f"  svd_loading {ZDIM}x{YDIM} float32: kernel {fmt_ms(ms)}, plain {fmt_ms(pms)}, "
        f"torch.linalg.svd {fmt_ms(lms)}, bound {b_ms:.2e} ms ({b_by})")
    return err, ms, pms, lms, b_ms, b_by


# lorenz: steps held bit for bit against the CPU's loop, and the steps of
# phase 9f's trajectory (examples/tutorial_lorenz.py's recipe)
LORENZ_CHECK_STEPS = 20000
LORENZ_STEPS = NTRIAL * LENGTH + 1000
# dependent rounded operations per Euler step: r x, - y, - x z, dt *, x +
LORENZ_CHAIN = 5


def check_lorenz(device):
    """The lorenz kernel against the CPU's loop, bit for bit, over
    LORENZ_CHECK_STEPS steps in float64 and float32 (and 1000 steps from a
    given start, and n = 1); then the kernel's time at LORENZ_STEPS in
    float64 (median of 10) and one call of the plain loop on the card.
    Returns (max |kernel - plain|, kernel ms, plain ms, bound ms, what
    binds)."""
    from vlgp_tpu_torch.simulation import _lorenz_cuda, _lorenz_plain, lorenz

    err = 0.0
    for dtype in (torch.float64, torch.float32):
        for n, x0 in ((LORENZ_CHECK_STEPS, None), (1000, (1.0, -2.0, 20.0)), (1, None)):
            got = lorenz(n, x0=x0, dtype=dtype, device=device).cpu()
            ref = lorenz(n, x0=x0, dtype=dtype, device="cpu")
            err = max(err, float((got - ref).abs().max()))
            if not torch.equal(got, ref):
                bad = int((got != ref).any(dim=1).nonzero()[0])
                raise AssertionError(f"lorenz {dtype} n={n} x0={x0}: the kernel leaves the "
                                     f"CPU's loop at step {bad}")
        log(f"  lorenz {str(dtype)[6:]}: the kernel equals the CPU's loop bit for bit over "
            f"{LORENZ_CHECK_STEPS} steps, 1000 steps from (1, -2, 20), and n = 1")
    n = LORENZ_STEPS
    xs = torch.empty((n, 3), dtype=torch.float64, device=device)
    xs[0] = torch.tensor((0.0, 1.0, 1.05), dtype=torch.float64)
    consts = (0.01, 10.0, 28.0, 2.667)
    ms = time_ms(lambda: _lorenz_cuda(xs, *consts))
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.strip().splitlines()[0]
    _lorenz_plain(xs[:100].clone(), *consts)  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    plain = xs.clone()
    start.record()
    _lorenz_plain(plain, *consts)
    end.record()
    torch.cuda.synchronize()
    pms = start.elapsed_time(end)
    if not torch.equal(plain, xs):
        raise AssertionError("lorenz: the plain loop on the card differs from the kernel")
    # bytes: the trajectory written once; operations: 15 float64 flops a step
    t_ops, t_bytes = 15.0 * (n - 1) / PEAK_FLOPS64, 24.0 * n / PEAK_BYTES
    b_ms, b_by = 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
    chain = LORENZ_CHAIN * (n - 1)
    ns_op = ms[0] * 1e6 / chain
    log(f"  lorenz {n} steps float64: kernel {fmt_ms(ms)}, plain loop on the card (one call) "
        f"{pms:.1f} ms, equal bit for bit; bound {b_ms:.2e} ms ({b_by}: {24 * n} bytes); "
        f"the chain of {chain} dependent operations takes {ns_op:.2f} ns each, "
        f"{ns_op * float(clock) * 1e-3:.1f} cycles at the SM clock of {clock} MHz")
    return err, ms, pms, b_ms, b_by


# ---------------------------------------------------------------------------
# 6c: the M-step's Newton iteration and the H-step's search
# ---------------------------------------------------------------------------

# mstep_stats / mstep_update against their plain versions: each statistic
# and each output within MSTEP_TOL of the plain version's, relative to the
# largest |value| of its tensor.  Both sum the same terms in other orders
# (the kernel per channel over chunks of rows, the plain version in GEMMs
# and pairwise sums) over ~1e5 rows, and the update's solve carries that
# into da by the Hessian's condition
MSTEP_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
# the whole iteration (the kernels' statistics into the kernel's update)
# against the plain one: the statistics' gap times the Newton system's
# condition, relative to each output's largest |value|
MSTEP_ITER_TOL = {torch.float32: 1e-3, torch.float64: 1e-8}
# mstep_update's four squared norms (the exit test's) against torch.sum of
# squares of its own outputs, relative: the same terms, summed by channel
# and then over channels in a fixed order by the kernel, pairwise by torch
NORMS_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# hstep_search against its plain version: judged by the objective in
# float64 (the plain gp_elbo_stats on C in float64), since in float32 the
# objective's own rounding (tr(K^-1 C) carries ~cond(K) eps) is larger
# than its differences near the minimum, where the golden search follows
# that rounding.  The kernel's x must be as good as the plain version's,
# f64(x_kernel) <= f64(x_plain) + 2 noise + HSTEP_FTOL |f64|, noise the
# plain objective's largest |f - f64| over the grid and both x; and where
# no grid candidate's f64 lies within 2 noise + HSTEP_FTOL |f64| of the tie
# threshold, x must lie in the bracket of the plain rule's grid cell
HSTEP_FTOL = {torch.float32: 1e-7, torch.float64: 1e-10}


def fit_segments(result):
    """The flagship fit's state cut into its 2000 window-50 segments, as the
    EM loop sees them: (segments, params, config)."""
    from vlgp_tpu_torch.data import cut_trials

    cfg = result.config
    return cut_trials(result.data, cfg.window, seed=cfg.seed), result.params, cfg


def mstep_case(S, T, Y, Z, X, dtype, device, gen, ragged=False):
    """Synthetic M-step inputs: latents and counts drawn from gen, x the bias
    and X - 1 lags of y (history), a ragged mask on request."""
    mu = 0.5 * torch.randn((S, T, Z), generator=gen, device=device, dtype=dtype)
    v = 0.01 + 0.09 * torch.rand((S, T, Z), generator=gen, device=device, dtype=dtype)
    a = 0.3 * torch.randn((Z, Y), generator=gen, device=device, dtype=dtype)
    b = torch.zeros((X, Y), device=device, dtype=dtype)
    b[0] = -1.0
    if X > 1:
        b[1:] = 0.05 * torch.randn((X - 1, Y), generator=gen, device=device, dtype=dtype)
    y = torch.poisson(torch.exp(mu @ a + b[0]), generator=gen)
    x = torch.ones((S, T, X, Y), device=device, dtype=dtype)
    for q in range(1, X):
        x[:, q:, q] = y[:, :-q]
        x[:, :q, q] = 0.0
    mask = torch.ones((S, T), device=device, dtype=dtype)
    if ragged:
        ends = torch.randint(1, T + 1, (S,), generator=gen, device=device)
        mask = (torch.arange(T, device=device)[None] < ends[:, None]).to(dtype)
        y, x, mu, v = y * mask[..., None], x * mask[..., None, None], mu * mask[..., None], \
            v * mask[..., None]
    return [y, x, mask, mu, v, a, b]


def same_bits(p, q):
    """Equal bit for bit, NaNs in the same places."""
    return torch.equal(torch.isnan(p), torch.isnan(q)) and torch.equal(
        torch.nan_to_num(p), torch.nan_to_num(q))


def _rel(got, ref, scale=None):
    """max |got - ref| over the finite entries of ref, divided by ``scale``
    (default: their max |ref|), and whether the NaNs sit in the same
    places."""
    fin = torch.isfinite(ref)
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(ref)))
    if not bool(fin.any()):
        return 0.0, same_nan
    if scale is None:
        scale = float(ref[fin].abs().max())
    return float((got[fin] - ref[fin]).abs().max()) / max(scale, 1e-30), same_nan


def mstep_compare(tag, args, active=None, use_hessian=True, eps=1e-8):
    """One case: the kernels' statistics, update (from the plain version's
    statistics) and whole iteration against the plain versions; both kernel
    routes (partials reduced by the update, and the reduce launch) give the
    same bits, twice.  Returns the worst relative gap."""
    from vlgp_tpu_torch.ops import mstep as om

    y, x, mask, mu, v, a, b = args
    dtype = y.dtype
    tol = MSTEP_TOL[dtype]
    kw = dict(use_hessian=use_hessian, eps=eps, learning_rate=1e-3, da_bound=5.0,
              db_bound=5.0)
    n = torch.sum(mask)
    noise_prev = torch.full((y.shape[2],), 0.5, dtype=dtype, device=y.device)
    plain = om._mstep_stats_plain(y, x, mask, mu, v, a, b, use_hessian)
    got = om.mstep_stats(y, x, mask, mu, v, a, b, use_hessian)
    worst = worst_it = 0.0
    names = ("s1", "s2", "C1", "C2", "grad_b", "E1", "E2", "E3", "nhess_b")
    for name, g, p in zip(names, got, plain):
        d, same = _rel(g, p)
        if d > tol or not same:
            raise AssertionError(f"6c mstep_stats {tag}: {name} {d:.2e} from the plain version "
                                 f"(tolerance {tol:.0e}), NaNs in the same places: {same}")
        worst = max(worst, d)
    ref_u = om._mstep_update_plain(plain, n, a, b, noise_prev, active, **kw)
    got_u = om.mstep_update(plain, n, a, b, noise_prev, active, **kw)
    outs = ("a", "b", "noise", "da", "db")
    for name, g, p in zip(outs, got_u, ref_u):
        d, same = _rel(g, p)
        if d > tol or not same:
            raise AssertionError(f"6c mstep_update {tag}: {name} {d:.2e} from the plain "
                                 f"version (tolerance {tol:.0e}), NaNs alike: {same}")
        worst = max(worst, d)
    # the whole iteration, both routes of the kernels, twice
    one = om.mstep_update(om.mstep_stats(y, x, mask, mu, v, a, b, use_hessian, partial=True),
                          n, a, b, noise_prev, active, **kw)
    two = om.mstep_update(got, n, a, b, noise_prev, active, **kw)
    again = om.mstep_update(om.mstep_stats(y, x, mask, mu, v, a, b, use_hessian, partial=True),
                            n, a, b, noise_prev, active, **kw)
    itol = MSTEP_ITER_TOL[dtype]
    for name, g1, g2, g3, p in zip(outs + ("norms",), one, two, again, ref_u):
        if not (same_bits(g1, g2) and same_bits(g1, g3)):
            raise AssertionError(f"6c mstep {tag}: {name} differs between the two routes or "
                                 f"two calls")
        if name == "norms":
            continue
        d, _ = _rel(g1, p)
        if d > itol:
            raise AssertionError(f"6c mstep iteration {tag}: {name} {d:.2e} from the plain "
                                 f"version (tolerance {itol:.0e})")
        worst_it = max(worst_it, d)
    # the exit test's squared norms against torch.sum of the kernel's own
    # outputs, both routes
    ntol = NORMS_TOL[dtype]
    for route, out in (("partials", one), ("flat", two)):
        d, same = _rel(out[5], om.squared_norms(out[3], out[0], out[4], out[1]))
        if d > ntol or not same:
            raise AssertionError(f"6c mstep_update {tag} ({route}): norms {out[5].tolist()} "
                                 f"{d:.2e} from torch.sum of its outputs (tolerance {ntol:.0e})")
    if active is not None:
        off = ~active
        for name, g, carried in (("a", one[0], a), ("b", one[1], b),
                                 ("noise", one[2], noise_prev)):
            if not torch.equal(g[..., off], carried[..., off]):
                raise AssertionError(f"6c mstep {tag}: an inert channel's {name} moved")
        if bool(one[3][:, off].any()) or bool(one[4][:, off].any()):
            raise AssertionError(f"6c mstep {tag}: an inert channel's da or db is not 0")
    log(f"  mstep {tag} {str(dtype)[6:]}: statistics and update worst {worst:.2e} relative "
        f"(tolerance {tol:.0e}), whole iteration {worst_it:.2e} ({itol:.0e}); routes and "
        f"repeat bit for bit")
    return max(worst, worst_it)


def check_mstep(device, gen, result):
    """6c, first part: mstep_stats and mstep_update at the flagship shape
    from phase 8's fit (Z5 S2000 T50 Y100 X1), at X3 (history 2), Z1 S300,
    Z12 S200 X2 (the update's block path, every channel active), Z 1, 5
    and 8 by X 1 and 2 (the update's warp path) and Z12 X2 in the Newton
    and the gradient mode with two inert channels, a ragged
    mask, inert channels, the gradient mode and a NaN in one channel's y, in
    float32 and float64, with the exit test's norms; times the flagship.
    Returns (worst gap, stats ms, stats plain ms, update ms, update plain
    ms, their bounds and what binds them)."""
    from vlgp_tpu_torch.ops import mstep as om

    seg, params, cfg = fit_segments(result)
    flagship = [seg.y, seg.x, seg.mask, seg.mu, seg.v, params.a, params.b]
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        base = [t.to(dtype) for t in flagship]
        worst = max(worst, mstep_compare("flagship Z5 S2000 T50 Y100 X1 (fit state)", base))
        for tag, shape, kw in (("X3 (history 2) Z5 S200 T50 Y40", (200, 50, 40, 5, 3), {}),
                               ("Z1 S300 T50 Y30", (300, 50, 30, 1, 1), {}),
                               ("Z12 S200 T50 Y30 X2", (200, 50, 30, 12, 2), {}),
                               ("ragged mask Z5 S300 T50 Y37", (300, 50, 37, 5, 1),
                                dict(ragged=True))):
            args = mstep_case(*shape, dtype, device, gen, **kw)
            worst = max(worst, mstep_compare(tag, args))
        # the update's warp path (Z <= 8, X <= 2) at its edges, both modes,
        # channels 0 and 29 inert; Z12 X2 above takes the block path
        for Z, X in ((1, 1), (1, 2), (5, 1), (5, 2), (8, 1), (8, 2), (12, 2)):
            args = mstep_case(200, 50, 30, Z, X, dtype, device, gen)
            active = torch.ones(30, dtype=torch.bool, device=device)
            active[[0, 29]] = False
            for hess in (True, False):
                worst = max(worst, mstep_compare(
                    f"Z{Z} X{X} S200 T50 Y30 {'Newton' if hess else 'gradient'}, channels 0, "
                    f"29 inert", args, active=active, use_hessian=hess))
        args = mstep_case(300, 50, 37, 5, 2, dtype, device, gen)
        active = torch.ones(37, dtype=torch.bool, device=device)
        active[[3, 36]] = False
        worst = max(worst, mstep_compare("inert channels 3, 36", args, active=active))
        worst = max(worst, mstep_compare("use_hessian=False", args, use_hessian=False))
        args[0] = args[0].clone()
        args[0][7, 11, 5] = float("nan")
        worst = max(worst, mstep_compare("NaN in channel 5's y", args))
        got = om.mstep_update(om.mstep_stats(*args, partial=True), torch.sum(args[2]),
                              args[5], args[6], torch.ones(37, dtype=dtype, device=device))
        bad = torch.isnan(got[0]).any(0) | torch.isnan(got[2])
        if not bool(bad[5]) or bool(bad[torch.arange(37, device=device) != 5].any()):
            raise AssertionError("6c mstep: the NaN in channel 5's y did not stay in channel 5")
    # time the flagship, float32
    y, x, mask, mu, v, a, b = flagship
    n = torch.sum(mask)
    noise = params.noise
    part = om.mstep_stats(y, x, mask, mu, v, a, b, partial=True)
    # the last block's ticket counter is kept per (device, stream): a launch
    # on a side stream takes a counter of its own and gives the same bits
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        got = om.mstep_update(part, n, a, b, noise)
    cur.wait_stream(side)
    ref = om.mstep_update(part, n, a, b, noise)
    if (om._ticket(a.device, side.cuda_stream).data_ptr()
            == om._ticket(a.device, cur.cuda_stream).data_ptr()):
        raise AssertionError("6c mstep_update: two streams share a ticket counter")
    if not all(same_bits(g, r) for g, r in zip(got, ref)):
        raise AssertionError("6c mstep_update: a side stream's launch differs from the default "
                             "stream's")
    log("  mstep_update on a side stream: its own ticket counter, the default stream's bits")
    s_ms = time_ms(lambda: om.mstep_stats(y, x, mask, mu, v, a, b, partial=True))
    s_pms = time_ms(lambda: om._mstep_stats_plain(y, x, mask, mu, v, a, b, True))
    # the update takes less device time than its launch costs the host:
    # both versions timed as replays of a captured call, and the kernel's
    # device time a launch from the trace of 20 eager calls
    u_ms = graph_ms(lambda: om.mstep_update(part, n, a, b, noise))
    _, _, by_name = trace_kernels(lambda: [om.mstep_update(part, n, a, b, noise)
                                           for _ in range(20)])
    u_dev_us = 1e6 * sum(t for k, t in by_name.items() if "mstep_update" in k) / 20
    plain = om._mstep_stats_plain(y, x, mask, mu, v, a, b, True)
    u_pms = graph_ms(lambda: om._mstep_update_plain(plain, n, a, b, noise, None, True, 1e-8,
                                                    1.0, 5.0, 5.0))
    S, T, Y = y.shape
    Z, X = a.shape[0], b.shape[0]
    ne = 2 + 2 * Z + X + Z * (Z + 1) + Z * Z + X * (X + 1) // 2
    # bytes: y, x, mask, mu, v, a, b read once, the statistics written once;
    # FMAs: eta, the variance term and the regressors, one per statistic
    s_bms, s_by = bound(S * T * Y * (2 * Z + X + ne),
                        4 * (S * T * Y * (1 + X) + S * T * (1 + 2 * Z) + (Z + X) * Y + Y * ne))
    # the update reads the partial sums (Y, chunks, ne), a, b and the noise
    # and writes a, b, da, db, the noise and the four norms
    chunks = part.part.shape[1]
    u_bms, u_by = bound(Y * (Z ** 3 // 3 + X ** 3 // 3 + 4 * Z * Z),
                        4 * (Y * chunks * ne + 2 * (Z + X) * Y + 2 * (Z + X) * Y + 2 * Y + 4))
    log(f"  mstep_stats Z{Z} S{S} T{T} Y{Y} X{X} float32: kernel {fmt_ms(s_ms)} "
        f"({chunks} chunks), plain {fmt_ms(s_pms)}, bound {s_bms:.4f} ms ({s_by})")
    log(f"  mstep_update Z{Z} Y{Y} X{X} float32 (prologue reduces the partials, norms "
        f"included), graph replays: kernel {fmt_ms(u_ms)}, plain {fmt_ms(u_pms)}, bound "
        f"{u_bms:.2e} ms ({u_by}); device time a launch {u_dev_us:.2f} us (trace of 20 calls)")
    return worst, s_ms, s_pms, s_bms, s_by, u_ms, u_pms, u_bms, u_by


def record_hstep(seg, params, cfg, stat=None):
    """The arguments of the hstep_stat and hstep_search calls of one H-step
    on the fit's segments (models/gp.py:hstep with recorders in place of
    both): {name: [(args, kw), ...]}.  ``stat`` given, it computes the
    statistic in place of hstep_stat (the plain version, for 6d)."""
    from vlgp_tpu_torch.models import gp

    calls = {"hstep_stat": [], "hstep_search": []}
    real = {name: getattr(gp, name) for name in calls}
    run = dict(real, hstep_stat=stat or real["hstep_stat"])

    def recorder(name):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return run[name](*args, **kw)
        return record

    for name in calls:
        setattr(gp, name, recorder(name))
    try:
        gp.hstep(seg, params, cfg, rank=40)
    finally:
        for name, fn in real.items():
            setattr(gp, name, fn)
    return calls


def search_plans(T, dtype):
    """Every (nb, per) plan hstep_search can run at T: clusters of 16, 8, 4,
    2 and 1 blocks, per = 1 in shared memory and any power of two dividing
    nb on the wide path (T > 138 float32, T > 97 float64)."""
    from vlgp_tpu_torch.ops._build import load_library

    wide = load_library("hstep").hstep_search_scratch(T, int(dtype == torch.float64)) != 0
    nbs = (16, 8, 4, 2, 1)
    return [(nb, per) for nb in nbs for per in nbs if per <= nb and (wide or per == 1)]


def hstep_compare(tag, args, kw, C_kernel=None, determined=False):
    """One search, kernel against plain (HSTEP_FTOL above); two calls of the
    kernel, and every plan it can run (search_plans: the cluster's size,
    the blocks that share an evaluation, the nb = 1 chain of single
    evaluations), equal bit for bit.  With ``C_kernel`` the kernel searches
    that statistic (6d: hstep_stat's) and the plain version, and the
    objective in float64, args' C.  ``determined``: a well-conditioned case,
    which fails unless every latent's grid cell is determined (the grid's
    f64 objectives apart by more than the noise and the tolerance).
    Returns (max |dx| / (hi - lo), the largest float64 objective gap
    relative to |f64|)."""
    from vlgp_tpu_torch.ops import golden as og

    C, nseg, sigsq, gp_noise, dt, lo, hi, iters = args
    dtype = C.dtype
    kargs = list(args) if C_kernel is None else [C_kernel, *args[1:]]
    x_k = og.hstep_search(*kargs, **kw)
    x_p = og._hstep_search_plain(*args, kw["polish"], kw["grid"], kw["tiebreak"],
                                 kw["profile_sigma"])
    if not torch.equal(og.hstep_search(*kargs, **kw), x_k):
        raise AssertionError(f"6c hstep_search {tag}: two calls differ")
    plans = search_plans(C.shape[1], dtype)
    for nb, per in plans:
        x_n = og._hstep_search_cuda(*kargs, kw["polish"], kw["grid"], kw["tiebreak"],
                                    kw["profile_sigma"], nb=nb, per=per)
        if not same_bits(x_k, x_n):
            raise AssertionError(f"6c hstep_search {tag}: the plan's x {x_k.tolist()} is not "
                                 f"plan (nb {nb}, per {per})'s {x_n.tolist()} bit for bit")
    plan = og.cluster_plan(C.shape[0], C.shape[1], dtype, kw["grid"], iters, kw["polish"],
                           C.device)
    if not torch.equal(torch.isnan(x_k), torch.isnan(x_p)):
        raise AssertionError(f"6c hstep_search {tag}: NaN x differ: {x_k} vs {x_p}")
    f = og._objective(C, nseg, sigsq, gp_noise, dt, kw["profile_sigma"])
    d64 = dict(dtype=torch.float64)
    f64 = og._objective(C.to(**d64), nseg.to(**d64), sigsq.to(**d64), gp_noise, dt,
                        kw["profile_sigma"])
    grid = kw["grid"]
    frac = torch.arange(max(grid, 1), dtype=dtype, device=C.device) / max(grid - 1, 1)
    cand = lo[None] + frac[:, None] * (hi - lo)[None]
    pts = torch.cat([cand, x_k[None], x_p[None]])
    noise = torch.nan_to_num((f(pts).double() - f64(pts.double())).abs(), nan=0.0).amax(0)
    fk, fp = f64(x_k.double()), f64(x_p.double())
    fin = torch.isfinite(fp)
    tol = 2 * noise + HSTEP_FTOL[dtype] * fp.abs()
    if bool((torch.isfinite(fk) != fin).any()) or bool(((fk - fp)[fin] > tol[fin]).any()):
        raise AssertionError(f"6c hstep_search {tag}: f64(x_kernel) - f64(x_plain) "
                             f"{(fk - fp).tolist()} above 2 noise + tolerance {tol.tolist()}; "
                             f"x {x_k.tolist()} vs {x_p.tolist()}")
    gap = float(((fk - fp)[fin] / fp[fin].abs()).max()) if bool(fin.any()) else 0.0
    cells = 0
    if grid >= 3:
        fc = torch.nan_to_num(f64(cand.double()), nan=float("inf"))
        fmin = fc.amin(0)
        thr = fmin + kw["tiebreak"] * fmin.abs()
        best = torch.argmax((fc <= thr).to(torch.int8), dim=0)
        margin = 2 * noise + HSTEP_FTOL[dtype] * fmin.abs()
        apart = ((fc - thr).abs() > margin).all(0) & torch.isfinite(fmin)
        step = (hi - lo) / (grid - 1)
        lo_b = cand.gather(0, (best - 1).clamp(min=0)[None])[0] - 1e-6 * step
        hi_b = cand.gather(0, (best + 1).clamp(max=grid - 1)[None])[0] + 1e-6 * step
        inside = (x_k >= lo_b) & (x_k <= hi_b)
        if bool((apart & ~inside).any()):
            raise AssertionError(f"6c hstep_search {tag}: another grid cell than the plain "
                                 f"rule's ({x_k.tolist()} vs {x_p.tolist()})")
        cells = int(apart.sum())
    if determined and cells != C.shape[0]:
        raise AssertionError(f"6c hstep_search {tag}: the grid cell is determined in {cells} "
                             f"of {C.shape[0]} latents")
    span = (hi - lo).abs().clamp_min(1e-30)
    dx = float(torch.nan_to_num((x_k - x_p).abs() / span).max())
    rel_noise = float((noise / fp.abs().clamp_min(1e-30))[fin].max()) if bool(fin.any()) else 0.0
    log(f"  hstep_search {tag} {str(dtype)[6:]}: max |dx| {dx:.2e} of the box, f64 gap "
        f"{gap:.2e} relative (objective noise {rel_noise:.1e}, HSTEP_FTOL "
        f"{HSTEP_FTOL[dtype]:.0e}), same grid cell in {cells} determined latents, repeat bit "
        f"for bit; plan nb {plan['nb']} per {plan['per']} ({plan['rounds']} rounds), the "
        f"same x bit for bit in all {len(plans)} plans")
    return dx, gap


def hstep_search_bound(Z, T, evals):
    """(ms, what binds) of a search's evaluations, each the least work of
    gp_elbo_stats: the Cholesky ((T^3 - T) / 6 FMAs), K^-1 = L^-T L^-1 from
    L (trtri and lauum, (T^3 - T) / 3) and tr(K^-1 C) as the sum of K^-1 (.)
    C (T^2); C read once and x written once (float32)."""
    fma = (T ** 3 - T) // 2 + T * T
    return bound(Z * evals * fma, 4 * (Z * T * T + 5 * Z))


def library_chain_ms(C, nseg, sigsq, gp_noise, dt, lo, hi, evals):
    """The library's evaluation (cholesky_ex and two solve_triangular on the
    Z candidate kernels at the box's middle, the plain version's calls)
    timed, times the search's evaluations: (median, min, max) ms."""
    from vlgp_tpu_torch.ops import golden as og

    T = C.shape[-1]
    t = torch.arange(T, dtype=C.dtype, device=C.device) * dt
    om = torch.exp(0.5 * (lo + hi))[:, None, None]
    K = sigsq[:, None, None] * torch.exp(-om * (t[:, None] - t[None]) ** 2) + gp_noise * torch.eye(
        T, dtype=C.dtype, device=C.device)

    def chain():
        L, _ = torch.linalg.cholesky_ex(K)
        half = torch.linalg.solve_triangular(L, C, upper=False)
        return torch.linalg.solve_triangular(L.mT, half, upper=True)

    return tuple(evals * v for v in time_ms(chain))


def gp_statistic(Z, T, nseg, dtype, device, gen, log_omega=(-6.0, -1.0)):
    """A C like the H-step's: nseg times the covariance of SE draws at each
    latent's omega (log omega uniform on ``log_omega``) plus a posterior
    term."""
    t = torch.arange(T, dtype=torch.float64, device=device)
    dsq = (t[:, None] - t[None]) ** 2
    om = torch.exp(torch.empty(Z, dtype=torch.float64, device=device).uniform_(
        *log_omega, generator=gen))
    K = torch.exp(-om[:, None, None] * dsq) + 1e-3 * torch.eye(T, dtype=torch.float64,
                                                               device=device)
    L = torch.linalg.cholesky(K)
    draws = L @ torch.randn((Z, T, 64), dtype=torch.float64, device=device, generator=gen)
    C = nseg * (draws @ draws.mT / 64 + 0.05 * K)
    return C.to(dtype)


def check_hstep(device, gen, result):
    """6c, second part: hstep_search against its plain version and every
    plan the kernel can run on the flagship C (Z5 T50) recorded from one
    H-step on phase 8's fit, with and without polish and the profiled
    sigma, with grid 20 and 7 shrinks, at Z12, then at T = 1, 17, 128 in
    shared memory and on the wide path (one evaluation on a group of
    blocks over global scratch, above T 138 in float32 and T 97 in
    float64) at T = 139, 150, 200, 257 and 1000 (float32) or 98, 100 and
    200 (float64), in float32 at T257 and T1000 a well-conditioned C (a
    rough box, gp_noise 0.1) whose every grid cell is determined, Z12 at
    T200 (clusters in waves), a C whose candidates fail Cholesky at the smooth end of the box (gp_noise -1e-3) and an
    all-NaN column, at T50 and T200, in float32 and float64; times the
    flagship search, Z12, and T150, T200 and T1000 (window=None) beside
    the plain version, the library's evaluation times the evaluations and
    the bound.  Returns (worst objective gap, kernel ms, plain ms, bound
    ms, what binds, the launch's cluster_plan, {T: the wide path's row})."""
    from vlgp_tpu_torch.ops import golden as og

    seg, params, cfg = fit_segments(result)
    calls = record_hstep(seg, params, cfg)["hstep_search"]
    args0, kw0 = calls[-1]
    worst = 0.0
    for dtype in (torch.float32, torch.float64):
        args = [a.to(dtype) if torch.is_tensor(a) else a for a in args0]
        for polish in (False, True):
            for profile in (True, False):
                kw = dict(kw0, polish=polish, profile_sigma=profile)
                worst = max(worst, hstep_compare(
                    f"flagship C Z5 T50 (fit state), polish {polish}, profiled sigma {profile}",
                    args, kw)[1])
        C, nseg, sigsq, gp_noise, dt, lo, hi, iters = args
        # more grid candidates than a cluster has blocks, a short last round
        worst = max(worst, hstep_compare("flagship C, grid 20, 7 shrinks, polish",
                                         [*args[:7], 7], dict(kw0, grid=20, polish=True))[1])
        # more blocks than the card has SMs
        for T in (50, 200):
            Cz = gp_statistic(12, T, 100.0, dtype, device, gen)
            a = [Cz, nseg.new_tensor(100.0), sigsq[:1].repeat(12), gp_noise, dt,
                 lo[:1].repeat(12), hi[:1].repeat(12), iters]
            worst = max(worst, hstep_compare(f"Z12 T{T}", a, dict(kw0))[1])
        # the wide path from T = 139 (float32) and T = 98 (float64), a
        # partial last panel at all but T1000's 1024 - 24
        wide = (139, 150, 200, 257, 1000) if dtype == torch.float32 else (98, 100, 200)
        for T in (1, 17, 128) + wide:
            Z = ZDIM if T == 1000 else 3
            Cs = gp_statistic(Z, T, 100.0, dtype, device, gen)
            a = [Cs, nseg.new_tensor(100.0), sigsq[:Z], gp_noise, dt, lo[:Z], hi[:Z], iters]
            worst = max(worst, hstep_compare(f"Z{Z} T{T}", a, dict(kw0, polish=True))[1])
        if dtype == torch.float32:
            # the float32 cases above carry ~cond(K) eps of objective noise
            # (the smooth end of the box at gp_noise 1e-4), which the rule
            # allows twice over; here a rough box and gp_noise 0.1 keep it
            # near 1e-6 of |f|, so every grid cell is determined and a
            # fault of the float32 update (two column tiles a task, a
            # row's short last task) cannot hide in it
            for T in (257, 1000):
                Z = ZDIM if T == 1000 else 3
                Cs = gp_statistic(Z, T, 100.0, dtype, device, gen, log_omega=(-1.0, 1.0))
                lo_r = torch.full((Z,), -2.0, dtype=dtype, device=device)
                hi_r = torch.full((Z,), 2.0, dtype=dtype, device=device)
                a = [Cs, nseg.new_tensor(100.0), sigsq[:Z], 0.1, dt, lo_r, hi_r, iters]
                worst = max(worst, hstep_compare(f"Z{Z} T{T}, rough box, gp_noise 0.1", a,
                                                 dict(kw0), determined=True)[1])
        for T in (50, 200):
            # gp_noise -1e-3: the smooth candidates' kernels (omega below
            # ~e^-1) have eigenvalues under 1e-3 and fail Cholesky, the
            # rough ones not
            Cs = gp_statistic(3, T, 100.0, dtype, device, gen)
            lo_s = torch.full((3,), -6.0, dtype=dtype, device=device)
            hi_s = torch.full((3,), 2.0, dtype=dtype, device=device)
            a = [Cs, nseg.new_tensor(100.0), sigsq[:3], -1e-3, dt, lo_s, hi_s, iters]
            fcand = og._objective(Cs, a[1], a[2], -1e-3, dt, True)(
                lo_s[None] + torch.linspace(0, 1, kw0["grid"], dtype=dtype,
                                            device=device)[:, None] * (hi_s - lo_s)[None])
            nbad = int(torch.isnan(fcand).sum())
            if nbad == 0 or bool(torch.isnan(fcand).all()):
                raise AssertionError(f"6c hstep_search: the failing-Cholesky case at T{T} has "
                                     f"{nbad} NaN candidates of {fcand.numel()}")
            worst = max(worst, hstep_compare(
                f"T{T}, Cholesky failing at {nbad} smooth candidates", a, dict(kw0))[1])
            Cn = gp_statistic(3, T, 100.0, dtype, device, gen)
            Cn[1] = float("nan")
            a = [Cn, nseg.new_tensor(100.0), sigsq[:3], gp_noise, dt, lo[:3], hi[:3], iters]
            x_k = og.hstep_search(*a, **kw0)
            if float(x_k[1]) != float(lo[1]):
                raise AssertionError(f"6c hstep_search: the all-NaN latent at T{T} gave "
                                     f"{float(x_k[1])}, not lo {float(lo[1])}")
            worst = max(worst, hstep_compare(f"T{T}, all-NaN column (latent 1)", a, kw0)[1])
    args = [a.to(torch.float32) if torch.is_tensor(a) else a for a in args0]
    pol, grid, tb, prof = kw0["polish"], kw0["grid"], kw0["tiebreak"], kw0["profile_sigma"]
    ms = time_ms(lambda: og.hstep_search(*args, **kw0))
    chain_ms = time_ms(lambda: og._hstep_search_cuda(*args, pol, grid, tb, prof, nb=1))
    pms = time_ms(lambda: og._hstep_search_plain(*args, pol, grid, tb, prof))
    C = args[0]
    Z, T = C.shape[0], C.shape[1]
    evals = grid + 2 + args[7] + int(pol)
    plan = og.cluster_plan(Z, T, C.dtype, grid, args[7], pol, device)
    b_ms, b_by = hstep_search_bound(Z, T, evals)
    log(f"  hstep_search flagship Z{Z} T{T} float32: clusters of {plan['nb']} blocks "
        f"({plan['resident']} resident at once), {plan['rounds']} rounds of "
        f"{evals} chained evaluations ({evals * T} dependent column steps), scratch "
        f"{plan['scratch_bytes']} bytes: kernel {fmt_ms(ms)}, nb = 1 chain {fmt_ms(chain_ms)}, "
        f"plain {fmt_ms(pms)}, bound {b_ms:.2e} ms ({b_by})")
    # Z12: more blocks than SMs (clusters of 16 share SMs)
    Cz = gp_statistic(12, T, 100.0, torch.float32, device, gen)
    az = [Cz, args[1], args[2][:1].repeat(12), args[3], args[4], args[5][:1].repeat(12),
          args[6][:1].repeat(12), args[7]]
    zplan = og.cluster_plan(12, T, Cz.dtype, grid, args[7], pol, device)
    z_ms = time_ms(lambda: og.hstep_search(*az, **kw0))
    log(f"  hstep_search Z12 T{T} float32: clusters of {zplan['nb']} ({zplan['resident']} "
        f"resident at once, {12 * zplan['nb']} blocks): kernel {fmt_ms(z_ms)}")
    # the wide path: window=None's whole trials (T1000) and two lengths
    # just above shared memory's
    rows = {}
    for Tw in (150, 200, LENGTH):
        Cw = gp_statistic(Z, Tw, 100.0, torch.float32, device, gen)
        aw = [Cw, *args[1:]]
        wplan = og.cluster_plan(Z, Tw, Cw.dtype, grid, args[7], pol, device)
        w_ms = time_ms(lambda: og.hstep_search(*aw, **kw0))
        w_pms = time_ms(lambda: og._hstep_search_plain(*aw, pol, grid, tb, prof))
        w_lms = library_chain_ms(Cw, *args[1:7], evals)
        w_bms, w_by = hstep_search_bound(Z, Tw, evals)
        log(f"  hstep_search Z{Z} T{Tw} float32 (wide path): clusters of {wplan['nb']} "
            f"({wplan['resident']} resident at once), {wplan['per']} blocks an evaluation, "
            f"{wplan['points']} points a round, {wplan['rounds']} rounds, scratch "
            f"{wplan['scratch_bytes']} bytes: kernel {fmt_ms(w_ms)}, plain {fmt_ms(w_pms)}, "
            f"library chain (cholesky_ex + 2 solve_triangular, x {evals}) {fmt_ms(w_lms)}, "
            f"bound {w_bms:.3f} ms ({w_by})")
        rows[Tw] = dict(ms=w_ms, plain_ms=w_pms, library_ms=w_lms, bound_ms=w_bms,
                        bound_by=w_by, plan=wplan)
    return worst, ms, pms, b_ms, b_by, plan, rows


# ---------------------------------------------------------------------------
# 6d: the H-step's statistic C
# ---------------------------------------------------------------------------

# hstep_stat against its plain version: each of sum_QP, sum_X and sum_QA
# within HSTAT_TOL of the plain version's, relative to its own largest
# |entry| (sum_QP enters C scaled by eps^2, the other two at O(1) and eps,
# so each is judged on its own scale).  Both sum the same products in other
# orders: the kernel per chunk of segments and then over the chunks, the
# plain version in cuBLAS's GEMMs and reductions.  Measured on the NVIDIA
# H100 80GB HBM3 / 700 W card (tools/torch_variant_ab.py, 6d): at the
# flagship the float32 sum_QP's gap is 5.8e-5 to 6.5e-5, and it is the
# plain version's: its cuBLAS GEMM over S R = 80,000 terms lies 5.2e-5 from
# the float64 sums of the same inputs, the kernel 9.4e-7; elsewhere the
# gaps are below 6e-6.  1e-4 holds that GEMM's rounding with a margin of
# 1.5; float64's gaps are below 2e-14.
HSTAT_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
HSTAT_NAMES = ("sum_QP", "sum_X", "sum_QA")


def _on(obj, dtype):
    """A TrialSet or Params with every float tensor in ``dtype``, on its device."""
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: t.to(dtype) for f in dataclasses.fields(obj)
        if isinstance(t := getattr(obj, f.name), torch.Tensor) and t.is_floating_point()})


def hstat_case(Z, S, T, R, dtype, device, gen):
    """Synthetic hstep_stat inputs: SE factors as the fit builds them, w~
    drawn from gen, X from inv_one_plus_gram (Newton-Schulz in float32, the
    exact route in float64), every segment valid."""
    from vlgp_tpu_torch.ops.spd import inv_one_plus_gram

    G = realistic_factor(Z, T, R, device).to(dtype)
    w = 0.1 + 2.0 * torch.rand((Z, S, T), generator=gen, device=device, dtype=dtype)
    wt2 = (w / (1.0 + 1e-3 * w)).contiguous()
    X = inv_one_plus_gram(G, wt2, iters=16)
    return [G, wt2, X, torch.ones(S, dtype=dtype, device=device)]


def hstat_compare(tag, args, quiet=False):
    """One case: the kernel's three sums against the plain version's
    (HSTAT_TOL, NaNs in the same places) and a second call bit for bit.
    Returns the worst relative gap; logs it unless ``quiet``."""
    from vlgp_tpu_torch.ops import hstat as oh

    dtype = args[0].dtype
    tol = HSTAT_TOL[dtype]
    plain = oh._hstep_stat_plain(*args)
    got = oh.hstep_stat(*args)
    again = oh.hstep_stat(*args)
    gaps = []
    for name, g, a, p in zip(HSTAT_NAMES, got, again, plain):
        if not same_bits(g, a):
            raise AssertionError(f"6d hstep_stat {tag}: {name} differs between two calls")
        d, same = _rel(g, p)
        if d > tol or not same:
            raise AssertionError(f"6d hstep_stat {tag}: {name} {d:.2e} from the plain version "
                                 f"(tolerance {tol:.0e}), NaNs in the same places: {same}")
        gaps.append(d)
    if quiet:
        return max(gaps)
    log(f"  hstep_stat {tag} {str(dtype)[6:]}: "
        + ", ".join(f"{n} {d:.2e}" for n, d in zip(HSTAT_NAMES, gaps))
        + f" relative to each sum's largest |entry| (tolerance {tol:.0e}); repeat bit for bit")
    return max(gaps)


def check_hstat_edges(device, gen, dtype):
    """6d: the T <= 64 kernel at its edges, T 1, 13, 50 and 64 by R 1, 5,
    40 and T (R <= T), each at S 1, 7 and 2000 and Z 1 and 5; at S7 Z5
    segment 3 has valid 0 and NaN w~ and X in latent 0, which must fill
    latent 0's sums alone.  One log line per (T, R); returns the worst gap."""
    from vlgp_tpu_torch.ops import hstat as oh

    worst = 0.0
    for T in (1, 13, 50, 64):
        for R in sorted({r for r in (1, 5, 40, T) if r <= T}):
            gaps = []
            for S in (1, 7, 2000):
                for Z in (1, 5):
                    args = hstat_case(Z, S, T, R, dtype, device, gen)
                    nan = S == 7 and Z == 5
                    if nan:
                        args[3][3] = 0.0
                        args[1], args[2] = args[1].clone(), args[2].clone()
                        args[1][0, 3] = float("nan")
                        args[2][0, 3] = float("nan")
                    gaps.append(hstat_compare(f"Z{Z} S{S} T{T} R{R}", args, quiet=True))
                    if nan:
                        for name, t in zip(HSTAT_NAMES, oh.hstep_stat(*args)):
                            if not (bool(torch.isnan(t[0]).all())
                                    and bool(torch.isfinite(t[1:]).all())):
                                raise AssertionError(f"6d hstep_stat Z5 S7 T{T} R{R}: the NaN of "
                                                     f"latent 0 did not fill latent 0's {name} "
                                                     f"alone")
            log(f"  hstep_stat T{T} R{R} {str(dtype)[6:]}, S 1 / 7 / 2000 by Z 1 / 5: worst "
                f"{max(gaps):.2e} relative (tolerance {HSTAT_TOL[dtype]:.0e}); repeat bit for "
                f"bit; the valid-0 NaN segment in its latent alone")
            worst = max(worst, max(gaps))
    return worst


def check_hstep_stat(device, gen, result):
    """6d: hstep_stat against its plain version on the first refinement of
    one H-step on phase 8's fit (Z5 S2000 T50 R40), the search on its C
    against the search on the plain C (6c's rule), then at T1000 R50 S100
    (window=None), T1 R1, T17 R17, T200 R128, a ragged S301 with valid-0
    segments and one whose w~ is 0, a NaN segment (valid 0) of latent 1,
    and the T <= 64 kernel's edges (check_hstat_edges), in float32 and
    float64; times the flagship and T1000.  Returns (worst
    gap, worst search gap, kernel ms, plain ms, bound ms, what binds,
    sum_QP GEMM ms)."""
    from vlgp_tpu_torch.ops import hstat as oh

    seg, params, cfg = fit_segments(result)
    worst = search = 0.0
    for dtype in (torch.float32, torch.float64):
        s_d, p_d = _on(seg, dtype), _on(params, dtype)
        calls = record_hstep(s_d, p_d, cfg)
        plain = record_hstep(s_d, p_d, cfg, stat=oh._hstep_stat_plain)
        args = list(calls["hstep_stat"][0][0])
        if dtype == torch.float32:
            flagship = args
        worst = max(worst, hstat_compare("flagship Z5 S2000 T50 R40 (fit state)", args))
        # the first refinement's search: the same omega and X on both runs,
        # so the two C differ by the statistic alone
        a_p, kw = plain["hstep_search"][0]
        search = max(search, hstep_compare("on hstep_stat's C (flagship, first refinement)",
                                           list(a_p), kw,
                                           C_kernel=calls["hstep_search"][0][0][0])[1])
        for Z, S, T, R in ((5, 100, 1000, 50), (3, 40, 1, 1), (3, 60, 17, 17), (3, 40, 65, 40),
                           (3, 30, 130, 50), (2, 50, 200, 128)):
            args = hstat_case(Z, S, T, R, dtype, device, gen)
            worst = max(worst, hstat_compare(f"Z{Z} S{S} T{T} R{R}", args))
            if T == 1000 and dtype == torch.float32:
                long_args = args
        # a ragged segment count, two valid-0 segments and one whose w~ is 0
        args = hstat_case(5, 301, 50, 40, dtype, device, gen)
        args[3][[3, 150]] = 0.0
        args[1][:, 200] = 0.0
        worst = max(worst, hstat_compare("Z5 S301 T50 R40, segments 3 and 150 valid 0, "
                                         "segment 200's w~ zero", args))
        # a NaN segment with valid 0: its latent's sums NaN, the others finite
        args[1] = args[1].clone()
        args[2] = args[2].clone()
        args[1][1, 150] = float("nan")
        args[2][1, 150] = float("nan")
        worst = max(worst, hstat_compare("NaN in latent 1's segment 150 (valid 0)", args))
        got = oh.hstep_stat(*args)
        for name, t in zip(HSTAT_NAMES, got):
            if not bool(torch.isnan(t[1]).all()) or not bool(
                    torch.isfinite(t[torch.arange(5, device=device) != 1]).all()):
                raise AssertionError(f"6d hstep_stat: the NaN of latent 1 did not fill latent "
                                     f"1's {name} alone")
        worst = max(worst, check_hstat_edges(device, gen, dtype))
    # time the flagship and T1000, float32
    G, wt2, X, valid = flagship
    Z, T, R = G.shape
    S = wt2.shape[1]
    ms = time_ms(lambda: oh.hstep_stat(*flagship))
    pms = time_ms(lambda: oh._hstep_stat_plain(*flagship))
    # the plain version's sum_QP GEMM alone (cuBLAS), on its own operands
    P = wt2[..., None] * G[:, None]
    Q = valid[None, :, None, None] * (P @ X)
    a = Q.permute(0, 2, 1, 3).reshape(Z, T, S * R)
    b = P.permute(0, 2, 1, 3).reshape(Z, T, S * R).mT
    gemm_ms = time_ms(lambda: a @ b)
    del P, Q, a, b
    b_ms, b_by = hstat_bound(Z, S, T, R)
    log(f"  hstep_stat Z{Z} S{S} T{T} R{R} float32: kernel {fmt_ms(ms)}, plain {fmt_ms(pms)} "
        f"(its sum_QP GEMM alone {fmt_ms(gemm_ms)}), bound {b_ms:.4f} ms ({b_by})")
    Zl, Tl, Rl = long_args[0].shape
    Sl = long_args[1].shape[1]
    lms = time_ms(lambda: oh.hstep_stat(*long_args))
    lpms = time_ms(lambda: oh._hstep_stat_plain(*long_args))
    lb_ms, lb_by = hstat_bound(Zl, Sl, Tl, Rl)
    log(f"  hstep_stat Z{Zl} S{Sl} T{Tl} R{Rl} float32 (window=None): kernel {fmt_ms(lms)}, "
        f"plain {fmt_ms(lpms)}, bound {lb_ms:.4f} ms ({lb_by})")
    return worst, search, ms, pms, b_ms, b_by, gemm_ms


def hstat_bound(Z, S, T, R):
    """(ms, what binds) of one float32 hstep_stat call: FLOPs of Q = P X and
    Q P' per segment; bytes of G, w~, X and valid read once and the three
    sums written once."""
    return bound(Z * S * T * R * (R + T),
                 4 * (Z * T * R + Z * S * T + Z * S * R * R + S + Z * (T * T + T * R + R * R)))


# ---------------------------------------------------------------------------
# 6e: the E-step's per-sweep chain
# ---------------------------------------------------------------------------

# estep_project and estep_step against their plain versions.  s and w are
# judged relative to their own largest |entry|; mu and delta relative to
# the largest |mu|: delta = u - G X G'(w u) is a difference of terms of
# mu's scale, so near convergence it is small beside the rounding of its
# terms.  Both sides sum the same products in other orders (the kernels per
# lane and through a butterfly of shuffles, the plain version in cuBLAS's
# GEMMs), and exp(min(., 10)) carries the predictor's rounding into the
# rates: 1e-4 in float32 (the fit's own float32 tolerances are of that
# order: MSTEP_TOL, HSTAT_TOL); float64 1e-10.  The Woodbury step's float32
# rounding grows with R and the conditioning of I + G'WG (on the NVIDIA H100
# 80GB HBM3 / 700 W card: 2e-5 at T64 R64, 1.4e-4 at T130 R128 between the
# two sides), so a float32 gap above 1e-4 passes where the kernel lies no
# farther than ESTEP_REF_FACTOR times the plain version from a float64
# evaluation of the same float32 inputs.
ESTEP_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
ESTEP_REF_FACTOR = 4.0
ESTEP_NAMES = ("s", "mu", "delta", "w")


def record_estep(seg, params, G, cfg):
    """The arguments of the first estep_project and estep_step calls of one
    sweep of models/vlgp.estep on ``seg``: (project args, step args)."""
    from vlgp_tpu_torch.models import vlgp as tv

    calls = {}
    real = {name: getattr(tv, name) for name in ("estep_project", "estep_step")}

    def recorder(name):
        def record(*args):
            calls.setdefault(name, args)
            return real[name](*args)
        return record

    for name in real:
        setattr(tv, name, recorder(name))
    try:
        tv.estep(seg, params, G, cfg, niter=1)
    finally:
        for name, fn in real.items():
            setattr(tv, name, fn)
    return list(calls["estep_project"]), list(calls["estep_step"])


def estep_case(S, T, Y, Z, R, X, dtype, device, gen, mixed=False, ragged=False,
               dmu_bound=5.0):
    """Synthetic inputs of one sweep (tests/test_torch_estep_kernels.py's
    cases on the card): SE factors as the fit builds them, mu, v and w drawn
    from gen, counts from the rates, x the bias and X - 1 lags of y, X the
    Woodbury inverses at the masked w; ``mixed`` makes the second half of
    the channels Gaussian, the last one padded (zero loading, data and
    noise) and channel 0's unused noise NaN; ``ragged`` ends each segment
    at a random bin and masks segment 0 whole.  (project args, step args)
    with s left as None."""
    from vlgp_tpu_torch.models.vlgp import _xb

    kw = dict(device=device, dtype=dtype)
    G = realistic_factor(Z, T, R, device).to(dtype)
    mu = 0.5 * torch.randn((Z, S, T), generator=gen, **kw)
    v = 0.01 + 0.09 * torch.rand((Z, S, T), generator=gen, **kw)
    w = 0.1 + 2.9 * torch.rand((Z, S, T), generator=gen, **kw)
    a = 0.4 * torch.randn((Z, Y), generator=gen, **kw)
    b = torch.zeros((X, Y), **kw)
    b[0] = -0.5
    if X > 1:
        b[1:] = 0.05 * torch.randn((X - 1, Y), generator=gen, **kw)
    eta = torch.einsum("zst,zy->sty", mu, a) + b[0]
    y = torch.poisson(torch.exp(eta), generator=gen)
    poisson = torch.ones(Y, dtype=torch.bool, device=device)
    noise = torch.ones(Y, **kw)
    if mixed:
        gauss = torch.arange(Y, device=device) >= Y // 2
        poisson[gauss] = False
        noise[gauss] = 0.5 + 1.5 * torch.rand((int(gauss.sum()),), generator=gen, **kw)
        y[..., gauss] = eta[..., gauss] + torch.randn((S, T, int(gauss.sum())), generator=gen,
                                                      **kw)
        a[:, -1] = 0.0
        b[:, -1] = 0.0
        y[..., -1] = 0.0
        noise[-1] = 0.0
        noise[0] = float("nan")
    x = torch.ones((S, T, X, Y), **kw)
    for q in range(1, X):
        x[:, q:, q] = y[:, :-q]
        x[:, :q, q] = 0.0
    mask = torch.ones((S, T), **kw)
    if ragged:
        ends = torch.randint(1, T + 1, (S,), generator=gen, device=device)
        mask = (torch.arange(T, device=device)[None] < ends[:, None]).to(dtype)
        mask[0] = 0.0
    wm = w * mask[None]
    eye = torch.eye(R, **kw)
    Xinv = torch.linalg.inv(eye + torch.einsum("ztr,zst,ztq->zsrq", G, wm, G))
    xb = _xb(x, b)
    return ([y, xb, mask, a, mu, v, poisson, noise],
            [G, None, mu, wm, Xinv, mask, a, xb, v, poisson, noise, dmu_bound])


def estep_gaps(s, out, ref_s, ref_out):
    """[(gap, NaNs in the same places)] of s, mu, delta and w against a
    reference: s and w relative to their largest |entry|, mu and delta to
    the reference's largest |mu|."""
    fin = ref_out[0][torch.isfinite(ref_out[0])]
    mu_scale = float(fin.abs().max()) if fin.numel() else 1.0
    return [_rel(s, ref_s), _rel(out[0], ref_out[0], mu_scale),
            _rel(out[1], ref_out[1], mu_scale), _rel(out[2], ref_out[2])]


def estep_plans(project, step, cm=None):
    """(plan, first design's plan) of estep_project and of estep_step at
    the inputs' shape (B members with ``cm``); the streaming and cluster
    plans' shared memory held against the kernels' own layout
    (``estep_smem``)."""
    from vlgp_tpu_torch.ops import _build
    from vlgp_tpu_torch.ops import estep as oe

    (S, T, Y), dtype = project[0].shape, project[0].dtype
    Z, R = project[3].shape[0], step[0].shape[2]
    B = 1 if cm is None else cm.shape[0]
    plans = oe.project_plan(S, T, Y, Z, dtype, B), oe.step_plan(S, T, Y, Z, R, dtype, B)
    lib = _build.load_library("estep")
    for kind, plan in enumerate(plans):
        if plan.path != "block":
            got = lib.estep_smem(2 if plan.path == "cluster" else kind, T, Y, Z, R, B,
                                 int(dtype == torch.float64), plan.units, plan.stages)
            if got != plan.smem:
                raise AssertionError(f"6e estep: the kernels lay out {got} bytes of shared "
                                     f"memory where ops/estep.py plans {plan}")
    return tuple(zip(plans, oe.block_plans(S, T, Y, Z, R, dtype, B)))


def estep_compare(tag, project, step, quiet=False, cm=None):
    """One case: estep_project's s against the plain version's, then
    estep_step from the plain s against its plain version (ESTEP_TOL, NaNs
    in the same places; a float32 gap above it against the float64
    evaluation, ESTEP_REF_FACTOR), each kernel's second call bit for bit
    and the first design's (the block path) bit for bit with the plan's;
    with ``cm`` (B, Y) B members on the same base rows.  Returns the worst
    gap; logs the gaps unless ``quiet``."""
    from vlgp_tpu_torch.ops import estep as oe

    dtype = project[0].dtype
    tol = ESTEP_TOL[dtype]
    (pp, pb), (sp, sb) = estep_plans(project, step, cm)
    s_p = oe._estep_project_plain(*project, cm)
    s_k = oe.estep_project(*project, cm)
    if not same_bits(s_k, oe.estep_project(*project, cm)):
        raise AssertionError(f"6e estep_project {tag}: two calls differ")
    if not same_bits(s_k, oe._estep_project_cuda(*project, cm, plan=pb)):
        raise AssertionError(f"6e estep_project {tag}: the {pp.path} path's s differs from the "
                             f"block path's")
    step = [step[0], s_p] + list(step[2:12])
    plain = oe._estep_step_plain(*step, cm)
    got = oe.estep_step(*step, cm)
    for name, g, h, b in zip(ESTEP_NAMES[1:], got, oe.estep_step(*step, cm),
                             oe._estep_step_cuda(*step, cm, plan=sb)):
        if not same_bits(g, h):
            raise AssertionError(f"6e estep_step {tag}: {name} differs between two calls")
        if not same_bits(g, b):
            raise AssertionError(f"6e estep_step {tag}: the {sp.path} path's {name} differs "
                                 f"from the block path's")
    gaps = estep_gaps(s_k, got, s_p, plain)
    notes = ""
    if dtype == torch.float32 and max(d for d, _ in gaps) > tol:
        def up(args):
            return [t.double() if torch.is_tensor(t) and t.is_floating_point() else t
                    for t in args]
        ref_s = oe._estep_project_plain(*up(project), None if cm is None else cm.double())
        ref = oe._estep_step_plain(*up(step), None if cm is None else cm.double())
        by_k, by_p = estep_gaps(s_k, got, ref_s, ref), estep_gaps(s_p, plain, ref_s, ref)
        notes = "; from float64: kernel " + ", ".join(
            f"{n} {k:.2e}" for n, (k, _) in zip(ESTEP_NAMES, by_k)) + ", plain " + ", ".join(
            f"{n} {q:.2e}" for n, (q, _) in zip(ESTEP_NAMES, by_p))
    for i, (name, (d, same)) in enumerate(zip(ESTEP_NAMES, gaps)):
        if not same or (d > tol and not (
                notes and by_k[i][0] <= ESTEP_REF_FACTOR * by_p[i][0])):
            raise AssertionError(f"6e estep {tag}: {name} {d:.2e} from the plain version "
                                 f"(tolerance {tol:.0e}), NaNs in the same places: {same}"
                                 f"{notes}")
    worst = max(d for d, _ in gaps)
    if not quiet or notes:
        log(f"  estep {tag} {str(dtype)[6:]} ({pp.path} / {sp.path}): "
            + ", ".join(f"{n} {d:.2e}" for n, (d, _) in zip(ESTEP_NAMES, gaps))
            + f" (s, w of their largest |entry|, mu and delta of the largest |mu|; tolerance "
              f"{tol:.0e}){notes}; repeat bit for bit")
    return worst


# 6e's check that a segment's bits do not depend on S: the first segments
# of the fit's state and the first trials of the final inference's, alone
ESTEP_PREFIX = {"flagship": 37, "final": 3}
# the edge shapes of 6e: (S, T, Y, Z, R, X); every one with mixed channels
# (a Gaussian half, a padded zero-noise channel) and a ragged mask
ESTEP_EDGES = ((37, 1, 37, 1, 1, 1), (37, 1, 37, 8, 1, 2), (37, 13, 37, 1, 1, 1),
               (37, 13, 37, 8, 13, 2), (37, 13, 37, 5, 1, 1), (37, 64, 37, 1, 17, 2),
               (37, 64, 37, 8, 64, 1), (37, 64, 37, 5, 17, 1), (11, 200, 37, 5, 128, 2),
               (53, 50, 99, 5, 40, 1), (29, 50, 100, 12, 40, 2), (5, 130, 30, 40, 128, 1),
               (3, 20, 300, 128, 10, 1))


def estep_bounds(Z, S, T, Y, R, nbytes=4):
    """((ms, binds) of estep_project, (ms, binds) of estep_step) at one
    shape: bytes of each input read once and each output written once (the
    channel flags as bytes), FMAs of the predictor, the rates' argument and
    the channel sums (3 Z a row and channel) and of the Woodbury step (4 Z T
    R + Z R^2 a segment)."""
    N = S * T
    rows = 3 * Z * N * Y
    proj = bound(rows, nbytes * (2 * N * Y + N + 2 * Z * N + Z * Y + Y + Z * N) + Y)
    step = bound(rows + Z * S * (4 * T * R + R * R),
                 nbytes * (Z * T * R + 4 * Z * N + Z * S * R * R + N + Z * Y + N * Y + Y
                           + 3 * Z * N) + Y)
    return proj, step


def check_estep(device, gen, result):
    """6e: estep_project and estep_step against their plain versions on the
    first sweep of one E-step on phase 8's fit (Z5 S2000 T50 Y100 R40, the
    fit's segments) and of the final inference (Z5 S100 T1000 R50, the
    fit's whole trials), then at the edge shapes (ESTEP_EDGES: T 1, 13, 64,
    200; R 1, 13, 17, 64, 128; Z 1, 5, 8, 12, 40 (two latent groups) and 128;
    Y 37, 99, 100, 300; X 1 and 2; mixed channels, a ragged mask) and a
    Poisson-only case with the clip engaged, in float32 and float64, each
    case's outputs bit for bit between the launch plan and the first design
    (estep_compare); a NaN planted in one segment's y must stay in that
    segment; the first segments alone (ESTEP_PREFIX) bit for bit with the
    full call; times both kernels at the flagship and at T1000 (graph
    replays, the plan and the first design in turns) beside the plain
    versions and the bounds.  Returns {"flagship"/"final": (project (ms,
    plain ms, bound ms, binds), step (...)), "err": worst gap}."""
    from vlgp_tpu_torch.models.gp import make_cholesky
    from vlgp_tpu_torch.ops import estep as oe

    seg, params, cfg = fit_segments(result)
    worst = 0.0
    recorded = {}
    for dtype in (torch.float32, torch.float64):
        p_d = _on(params, dtype)
        for tag, data, rank in (("flagship", _on(seg, dtype), 40),
                                ("final inference", _on(result.data, dtype), None)):
            G = make_cholesky(data.nbin, p_d, rank=rank)
            project, step = record_estep(data, p_d, G, cfg)
            (Z, T, R), S = G.shape, data.y.shape[0]
            worst = max(worst, estep_compare(f"{tag} Z{Z} S{S} T{T} R{R} (fit state)", project,
                                             step))
            if dtype == torch.float32:
                recorded["flagship" if rank else "final"] = (project, step)
        gaps = []
        for S, T, Y, Z, R, X in ESTEP_EDGES:
            project, step = estep_case(S, T, Y, Z, R, X, dtype, device, gen, mixed=True,
                                       ragged=True)
            gaps.append(estep_compare(f"S{S} T{T} Y{Y} Z{Z} R{R} X{X}", project, step,
                                      quiet=True))
        log(f"  estep at {len(ESTEP_EDGES)} edge shapes {str(dtype)[6:]} (mixed channels with "
            f"a padded zero-noise one and a NaN noise on a Poisson channel, ragged mask): worst "
            f"{max(gaps):.2e} (tolerance {ESTEP_TOL[dtype]:.0e}); repeat bit for bit")
        worst = max(worst, max(gaps))
        project, step = estep_case(64, 50, 100, 5, 40, 1, dtype, device, gen, dmu_bound=0.05)
        worst = max(worst, estep_compare("Poisson only, dmu_bound 0.05", project, step))
        if float(oe._estep_step_plain(*step[:1], oe._estep_project_plain(*project),
                                      *step[2:])[1].abs().max()) != float(torch.tensor(0.05,
                                                                                      dtype=dtype)):
            raise AssertionError("6e estep: the clip case does not reach dmu_bound")
    # a NaN in one segment's y stays in that segment (the streaming paths at
    # the flagship, the cluster path in the final inference)
    for key in ("flagship", "final"):
        project, step = [list(t) for t in recorded[key]]
        project[0] = project[0].clone()
        project[0][7, 3, 5] = float("nan")
        worst = max(worst, estep_compare(f"{key}, NaN in segment 7's y", project, step))
        s = oe.estep_project(*project)
        step[1] = s
        out = (s,) + tuple(oe.estep_step(*step))
        other = torch.arange(s.shape[1], device=device) != 7
        for name, t in zip(ESTEP_NAMES, out):
            if bool(torch.isfinite(t[:, 7]).all()) or not bool(torch.isfinite(t[:, other]).all()):
                raise AssertionError(f"6e estep ({key}): the NaN in segment 7's y did not stay "
                                     f"in segment 7's {name}")
        log(f"  estep ({key}): a NaN in segment 7's y: s, mu, delta and w NaN in segment 7, "
            f"every other segment finite")
    # a captured call replays the eager call's bits (the final inference's
    # plan: the cluster path, its grid read from the card before the capture)
    project, step = recorded["final"]
    args = [step[0], oe.estep_project(*project)] + list(step[2:])
    eager = oe.estep_step(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = oe.estep_step(*args)
    graph.replay()
    torch.cuda.synchronize()
    for name, g, e in zip(ESTEP_NAMES[1:], captured, eager):
        if not same_bits(g, e):
            raise AssertionError(f"6e estep_step (final): the captured call's {name} differs "
                                 f"from the eager call's")
    log(f"  estep_step (final, {estep_plans(project, args)[1][0].path} path): a captured call's "
        f"replay gives the eager call's mu, delta and w bit for bit")
    # a segment's bits depend neither on S nor on the grid: the first
    # ESTEP_PREFIX[key] segments alone against the full call's
    for key, n in ESTEP_PREFIX.items():
        project, step = recorded[key]
        s = oe.estep_project(*project)
        full = (s,) + tuple(oe.estep_step(step[0], s, *step[2:]))
        y, xb, mask, a, mu, v, poisson, noise = project
        cut = [y[:n], xb[:n], mask[:n], a, mu[:, :n], v[:, :n], poisson, noise]
        s_n = oe.estep_project(*cut)
        zst = [t[:, :n] for t in (s, step[2], step[3], step[4], step[8])]
        out_n = (s_n,) + tuple(oe.estep_step(step[0], zst[0], zst[1], zst[2], zst[3],
                                             step[5][:n], step[6], step[7][:n], zst[4],
                                             *step[9:]))
        for name, a, b in zip(ESTEP_NAMES, out_n, full):
            if not same_bits(a, b[:, :n]):
                raise AssertionError(f"6e estep ({key}): {name} of the first {n} segments "
                                     f"alone differs from the full call's")
        Z, S, T = step[2].shape
        R = step[0].shape[2]
        log(f"  estep ({key}, Z{Z} S{S} T{T} R{R}): the first {n} segments alone give the full "
            f"call's s, mu, delta and w bit for bit (plans "
            f"{'/'.join(pl.path for pl, _ in estep_plans(cut, [step[0]] + zst))} against "
            f"{'/'.join(pl.path for pl, _ in estep_plans(project, step))})")
    times = {}
    for key in ("flagship", "final"):
        # contiguous inputs, as every sweep but an E-step's first passes them
        # (its mu is a transposed view, which the wrapper copies)
        project, step = ([t.contiguous() if torch.is_tensor(t) else t for t in args]
                         for args in recorded[key])
        step = [step[0], oe._estep_project_plain(*project)] + list(step[2:])
        Z, S, T = step[2].shape
        Y, R = project[0].shape[2], step[0].shape[2]
        (pk, pb), (sk, sb) = estep_plans(project, step)
        # device time a launch (replays of a captured call: these calls are
        # short enough for the host's launch cost to show in eager timing);
        # the plan against the first design in turns, plan first and last
        fns = {"kp": lambda: oe.estep_project(*project),
               "kb": lambda: oe._estep_project_cuda(*project, plan=pb),
               "ks": lambda: oe.estep_step(*step),
               "sb": lambda: oe._estep_step_cuda(*step, plan=sb)}
        turns = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                turns[k].append(graph_ms(fns[k]))
        kp, kb, ks, bb = (min(turns[k], key=lambda t: t[0]) for k in ("kp", "kb", "ks", "sb"))
        pp = graph_ms(lambda: oe._estep_project_plain(*project))
        ps = graph_ms(lambda: oe._estep_step_plain(*step))
        (bp, bp_by), (bs, bs_by) = estep_bounds(Z, S, T, Y, R)
        log(f"  estep_project Z{Z} S{S} T{T} Y{Y} float32 ({key}, {pk.path} path): kernel "
            f"{fmt_ms(kp)}; the first design in turns {fmt_ms(kb)} (medians "
            f"{', '.join(f'{t[0]:.4f}' for t in turns['kp'])} against "
            f"{', '.join(f'{t[0]:.4f}' for t in turns['kb'])}); plain {fmt_ms(pp)}; bound "
            f"{bp:.4f} ms ({bp_by}); graph replays")
        log(f"  estep_step Z{Z} S{S} T{T} Y{Y} R{R} float32 ({key}, {sk.path} path): kernel "
            f"{fmt_ms(ks)}; the first design in turns {fmt_ms(bb)} (medians "
            f"{', '.join(f'{t[0]:.4f}' for t in turns['ks'])} against "
            f"{', '.join(f'{t[0]:.4f}' for t in turns['sb'])}); plain {fmt_ms(ps)}; bound "
            f"{bs:.4f} ms ({bs_by}); the sweep's chain {kp[0] + ks[0]:.4f} ms in the kernels "
            f"({kb[0] + bb[0]:.4f} in the first design) against {pp[0] + ps[0]:.4f} ms plain")
        times[key] = ((kp, pp, bp, bp_by), (ks, ps, bs, bs_by))
        times[key + " paths"] = (pk.path, sk.path)
        # 20 launches of each kernel captured in one graph against the same
        # 20 launched eagerly, CUDA events around each batch
        batch = []
        for name, fn in (("estep_project", fns["kp"]), ("estep_step", fns["ks"])):
            eager, graphed = batch_launch_ms(fn, 20)
            batch.append(f"{name} {eager:.4f} eager, {graphed:.4f} in one graph")
        log(f"  estep ({key}) ms a launch over 20 launches: " + "; ".join(batch))
    times["err"] = worst
    return times


# 6e's shapes of estep_step's cluster path (T > 64 where G does not fit one
# block): T at a chunk's edges (100 and 101 in two chunks of t, 1000 and
# 1024 in 16), R 1 to the 128 limit (R <= T: G's rank), Z 1, 5 and 12, each
# case five segments with mixed channels and a ragged mask.  A shape whose
# stages fit one block streams, one whose cluster stages do not fit takes
# the block path; every case holds the plan's path against the block path
# bit for bit all the same
ESTEP_LONG = tuple((T, R, Z) for T, R, Z in itertools.product(
    (100, 101, 1000, 1024), (1, 17, 50, 128), (1, 5, 12)) if R <= T)
# 6e's member axis: (tag, S, T, Y, Z, R, B, mixed channels and a ragged
# mask); leave-one-neuron-out's chunk at its default batch (9c) first
ESTEP_MEMBER_CASES = (("9c chunk", 100, 1000, 100, 5, 50, 25, False),
                      ("segments", 200, 50, 100, 5, 40, 3, True),
                      ("T101", 7, 101, 37, 5, 17, 4, True),
                      ("Z12", 9, 64, 37, 12, 17, 2, True))


def check_estep_long(device, gen):
    """6e's cluster path: every shape of ESTEP_LONG and S2500 T1000 (the 9c
    chunk's segment count, no members) against the plain version, and the
    plan's path against the block path bit for bit (estep_compare); the
    first 37 segments of the S2500 call alone bit for bit with the full
    call; the S2500 call timed on the plan's path and the block path in
    turns.  Returns (worst gap, {path: cases}, (ms, block ms) at S2500)."""
    from vlgp_tpu_torch.ops import estep as oe

    worst, paths = 0.0, collections.Counter()
    for T, R, Z in ESTEP_LONG:
        project, step = estep_case(5, T, 100, Z, R, 1, torch.float32, device, gen, mixed=True,
                                   ragged=True)
        worst = max(worst, estep_compare(f"S5 T{T} Y100 Z{Z} R{R}", project, step, quiet=True))
        paths[estep_plans(project, step)[1][0].path] += 1
    log(f"  estep at {len(ESTEP_LONG)} shapes of T 100, 101, 1000, 1024 by R 1, 17, 50, 128 (R <= "
        f"T) by Z 1, 5, 12 (S5 Y100, mixed channels, ragged mask), estep_step's paths "
        f"{dict(paths)}: "
        f"worst {worst:.2e} (tolerance {ESTEP_TOL[torch.float32]:.0e}); each plan's path bit for "
        f"bit with the block path")
    project, step = estep_case(2500, 1000, 100, 5, 50, 1, torch.float32, device, gen)
    worst = max(worst, estep_compare("S2500 T1000 Y100 Z5 R50", project, step))
    n = 37
    s = oe.estep_project(*project)
    full = (s,) + tuple(oe.estep_step(step[0], s, *step[2:]))
    cut = [t[:n] for t in project[:3]] + [project[3], project[4][:, :n], project[5][:, :n],
                                          project[6], project[7]]
    zst = [t[:, :n] for t in (s, step[2], step[3], step[4], step[8])]
    out_n = (oe.estep_project(*cut),) + tuple(oe.estep_step(
        step[0], zst[0], zst[1], zst[2], zst[3], step[5][:n], step[6], step[7][:n], zst[4],
        *step[9:]))
    for name, a, b in zip(ESTEP_NAMES, out_n, full):
        if not same_bits(a, b[:, :n]):
            raise AssertionError(f"6e estep (S2500 T1000): {name} of the first {n} segments "
                                 f"alone differs from the full call's")
    step = [step[0], s] + list(step[2:])
    (_, _), (sk, sb) = estep_plans(project, step)
    turns = {"k": [], "b": []}
    for order in (("k", "b"), ("b", "k")):
        for key in order:
            turns[key].append(graph_ms(lambda: oe._estep_step_cuda(*step, plan=sb)) if key == "b"
                              else graph_ms(lambda: oe.estep_step(*step)))
    kms, bms = (min(turns[k], key=lambda t: t[0]) for k in ("k", "b"))
    grid = sk.grid
    if sk.path == "cluster":
        grid = sk.units * min(2500, oe._resident_clusters(sk, 1000, 100, 5, 50, torch.float32,
                                                          device))
    log(f"  estep_step Z5 S2500 T1000 Y100 R50 float32 ({sk.path} path, grid {grid} of "
        f"{sk.threads} threads): the first {n} segments alone bit for "
        f"bit with the full call; kernel {fmt_ms(kms)}, block path in turns {fmt_ms(bms)} "
        f"(medians {', '.join(f'{t[0]:.4f}' for t in turns['k'])} against "
        f"{', '.join(f'{t[0]:.4f}' for t in turns['b'])}); graph replays")
    return worst, dict(paths), (kms, bms)


def members_case(S, T, Y, Z, R, B, dtype, device, gen, mixed=False):
    """Inputs of one sweep of B members on S base segments (estep_case's
    y, xb, mask, loading, channels and G, ragged where ``mixed``), each
    member its own mu, v, w and X (Z, B S, ...), and the channel weights
    cm (B, Y): member b holds out channel b mod Y.  (project args, step
    args with s None, cm)."""
    project, step = estep_case(S, T, Y, Z, R, 1, dtype, device, gen, mixed=mixed, ragged=mixed)
    y, xb, mask, a, _, _, poisson, noise = project
    G, bound_ = step[0], step[11]
    kw = dict(device=device, dtype=dtype)
    mu = 0.5 * torch.randn((Z, B * S, T), generator=gen, **kw)
    v = 0.01 + 0.09 * torch.rand((Z, B * S, T), generator=gen, **kw)
    wm = (0.1 + 2.9 * torch.rand((Z, B * S, T), generator=gen, **kw)) * mask.repeat(B, 1)[None]
    Xinv = torch.linalg.inv(torch.eye(R, **kw) + torch.einsum("ztr,zst,ztq->zsrq", G, wm, G))
    cm = torch.ones((B, Y), **kw)
    cm[torch.arange(B), torch.arange(B) % Y] = 0.0
    return ([y, xb, mask, a, mu, v, poisson, noise],
            [G, None, mu, wm, Xinv, mask, a, xb, v, poisson, noise, bound_], cm)


def member_of(project, step, b, S):
    """Member b's arguments alone (its segments of mu, v, w, s and X)."""
    sl = slice(b * S, (b + 1) * S)
    pr = list(project)
    pr[4], pr[5] = project[4][:, sl], project[5][:, sl]
    st = list(step)
    for i in (1, 2, 3, 4, 8):
        st[i] = None if step[i] is None else step[i][:, sl]
    return pr, st


def estep_member_bounds(Z, S, T, Y, R, B, nbytes=4):
    """estep_bounds with B members on S base segments: y, xb and the mask
    read once, the members' vectors, X and outputs each once, cm once."""
    N, M = S * T, B * S * T
    proj = bound(3 * Z * M * Y, nbytes * (2 * N * Y + N + 2 * Z * M + Z * Y + Y + B * Y + Z * M)
                 + Y)
    step = bound(3 * Z * M * Y + Z * B * S * (4 * T * R + R * R),
                 nbytes * (Z * T * R + 4 * Z * M + Z * B * S * R * R + N + Z * Y + N * Y + Y
                           + B * Y + 3 * Z * M) + Y)
    return proj, step


def check_estep_members(device, gen):
    """6e's member axis (leave-one-neuron-out's chunks): at each of
    ESTEP_MEMBER_CASES both kernels against their member plain versions and
    the plans' paths against the block path bit for bit (estep_compare with
    cm); every member of the call bit for bit with its own B = 1 call; B =
    1 with all-ones cm bit for bit with the call without members; the 9c
    chunk timed (graph replays) beside the plain versions and the bounds.
    Returns {"chunk": (project (ms, plain ms, bound ms, binds), step (...),
    paths), "err": worst gap}."""
    from vlgp_tpu_torch.ops import estep as oe

    worst, out = 0.0, {}
    for tag, S, T, Y, Z, R, B, mixed in ESTEP_MEMBER_CASES:
        project, step, cm = members_case(S, T, Y, Z, R, B, torch.float32, device, gen, mixed)
        worst = max(worst, estep_compare(f"{tag} B{B} S{S} T{T} Y{Y} Z{Z} R{R}", project, step,
                                         cm=cm))
        s = oe.estep_project(*project, cm)
        step = [step[0], s] + list(step[2:])
        full = (s,) + tuple(oe.estep_step(*step, cm))
        for b in range(B):
            pb, sb_ = member_of(project, step, b, S)
            one = (oe.estep_project(*pb, cm[b:b + 1]),) + tuple(oe.estep_step(*sb_, cm[b:b + 1]))
            for name, g, f in zip(ESTEP_NAMES, one, full):
                if not same_bits(g, f[:, b * S:(b + 1) * S]):
                    raise AssertionError(f"6e estep members ({tag}): member {b}'s {name} alone "
                                         f"differs from the B{B} call's")
        p0, s0 = member_of(project, step, 0, S)
        ones = torch.ones_like(cm[:1])
        with_cm = (oe.estep_project(*p0, ones),) + tuple(oe.estep_step(*s0, ones))
        without = (oe.estep_project(*p0),) + tuple(oe.estep_step(*s0))
        for name, g, f in zip(ESTEP_NAMES, with_cm, without):
            if not same_bits(g, f):
                raise AssertionError(f"6e estep members ({tag}): B = 1 with all-ones cm gives "
                                     f"another {name} than the call without members")
        (pp, _), (sp, _) = estep_plans(project, step, cm)
        log(f"  estep members ({tag}, {pp.path} / {sp.path} paths): each of the {B} members "
            f"bit for bit with its own B = 1 call; B = 1 with all-ones cm bit for bit with the "
            f"call without members")
        if tag == "9c chunk":
            kp = graph_ms(lambda: oe.estep_project(*project, cm))
            ks = graph_ms(lambda: oe.estep_step(*step, cm))
            pl_p = graph_ms(lambda: oe._estep_project_plain(*project, cm))
            pl_s = graph_ms(lambda: oe._estep_step_plain(*step, cm))
            (bp, bp_by), (bs, bs_by) = estep_member_bounds(Z, S, T, Y, R, B)
            log(f"  estep members at the 9c chunk (B{B} S{S} T{T} Y{Y} Z{Z} R{R} float32): "
                f"estep_project {fmt_ms(kp)} ({pp.path} path), plain {fmt_ms(pl_p)}, bound "
                f"{bp:.4f} ms ({bp_by}); estep_step {fmt_ms(ks)} ({sp.path} path), plain "
                f"{fmt_ms(pl_s)}, bound {bs:.4f} ms ({bs_by}); a round's chain {kp[0] + ks[0]:.3f} "
                f"ms against {pl_p[0] + pl_s[0]:.3f} ms plain; graph replays")
            out["chunk"] = ((kp, pl_p, bp, bp_by), (ks, pl_s, bs, bs_by), (pp.path, sp.path))
    out["err"] = worst
    return out


def batch_launch_ms(fn, n):
    """(eager, graphed) ms a launch of ``n`` calls of fn: the calls launched
    back to back between one pair of CUDA events, and the same calls
    captured in one graph whose replay is timed the same way (median of 5
    batches each)."""
    def timed(run):
        out = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / n)
        return statistics.median(out)

    def eager():
        for _ in range(n):
            fn()

    eager()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    return timed(eager), timed(graph.replay)


def make_workload(seed=0, ntrial=NTRIAL, a=None, length=LENGTH, ydim=YDIM):
    """bench.py's flagship workload (seed 0): (trials, loading, true
    latents).  Another seed with the flagship's loading `a` gives fresh
    Poisson draws of the same latents; `length` and `ydim` cut it down."""
    rng = np.random.default_rng(seed)
    a_seed = (rng.normal(size=(ZDIM, ydim)) * 0.3).astype(np.float32)
    a = a_seed if a is None else a
    trials, zs = [], []
    for _ in range(ntrial):
        z = np.stack([np.sin(np.linspace(0, 20 + 3 * i, length)) for i in range(ZDIM)], 1)
        y = rng.poisson(np.exp(z @ a - 2.0)).astype(np.float32)
        trials.append({"y": y, "mu": (rng.normal(size=(length, ZDIM)) * 0.1).astype(np.float32)})
        zs.append(z)
    return trials, a, np.concatenate(zs)


def r2_aligned(mu, zt):
    X = np.column_stack([mu, np.ones(len(mu))])
    beta, *_ = np.linalg.lstsq(X, zt, rcond=None)
    return float(1 - np.sum((X @ beta - zt) ** 2) / np.sum((zt - zt.mean(0)) ** 2))


def check_small_fit_against_cpu():
    """The card's float32 fit (kernels) against the CPU's float64 fit (exact
    Cholesky route, the reference semantics) on a 4 x 120 x 10 x 2 input."""
    import vlgp_tpu_torch

    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 10)) * 0.5
    trials, zs = [], []
    for _ in range(4):
        z = np.column_stack((np.sin(np.linspace(0, 6, 120)), np.cos(np.linspace(0, 6, 120))))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.5)).astype(float),
                       "mu": rng.normal(size=(120, 2)) * 0.1})
        zs.append(z)
    zt = np.concatenate(zs)
    kw = dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), max_iter=10)
    gpu = vlgp_tpu_torch.fit(trials, 2, device="cuda", dtype="float32", **kw)
    cpu = vlgp_tpu_torch.fit(trials, 2, device="cpu", dtype="float64", **kw)
    mu_g = gpu.data.mu.cpu().double().numpy()
    mu_c = cpu.data.mu.numpy()
    rel = float(np.abs(mu_g - mu_c).max() / np.abs(mu_c).max())
    r2_g = r2_aligned(mu_g.reshape(-1, 2), zt)
    r2_c = r2_aligned(mu_c.reshape(-1, 2), zt)
    log(f"small fit: card f32 vs CPU f64: max|dmu|/max|mu| {rel:.3e}, "
        f"R^2 {r2_g:.4f} vs {r2_c:.4f}")
    # float32 Newton-Schulz rides its 1e-2 residual contract across ten EM
    # iterations (the CPU's plain versions land 3.4e-2 from float64 here),
    # so the posterior is held to 1e-1 and the recovery to 0.01
    if not (np.isfinite(mu_g).all() and rel < 1e-1 and abs(r2_g - r2_c) < 0.01):
        raise AssertionError("small fit on the card disagrees with the CPU float64 fit")


def run_fit(fused, **fit_kw):
    """One flagship fit with the counters set to 0 just before it, ``fit_kw``
    passed on to fit; returns (launches, route calls, fallbacks, wall s,
    E-step s, R^2, FitResult)."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.models import vlgp as tv
    from vlgp_tpu_torch.ops import spd

    trials, a, zt = make_workload()
    tv._SWEEP_FUSED = fused
    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    result = vlgp_tpu_torch.fit(trials, ZDIM, a=a, **FLAGSHIP_KW, **fit_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(spd.KERNEL_LAUNCHES)
    fallbacks = dict(spd.FALLBACKS)
    calls = dict(spd.ROUTE_CALLS)
    tv._SWEEP_FUSED = False

    d = result.data
    for name in ("mu", "v", "w"):
        t = getattr(d, name)
        if t.device.type != "cuda":
            raise AssertionError(f"posterior {name} is on {t.device}, not the card")
        if not torch.isfinite(t).all():
            raise AssertionError(f"posterior {name} has non-finite values")
    if tuple(d.mu.shape) != (NTRIAL, LENGTH, ZDIM):
        raise AssertionError(f"posterior mu has shape {tuple(d.mu.shape)}")
    r2 = r2_aligned(d.mu.cpu().numpy().reshape(-1, ZDIM), zt)
    rt = result.runtime
    e_s = sum(rt["e_elapsed"])
    tag = "fit (fused sweep)" if fused else "fit (default)"
    if fit_kw:
        tag = f"fit ({', '.join(f'{k}={v}' for k, v in fit_kw.items())})"
    log(f"{tag}: {wall:.2f} s wall, {rt['it']} EM iterations "
        f"(converged_at {rt.get('converged_at')}), final_hstep {rt.get('final_hstep', False)}")
    log(f"{tag}: E {e_s:.3f} s, M {sum(rt['m_elapsed']):.2f} s, "
        f"H {sum(rt['h_elapsed']):.2f} s over the EM loop")
    log(f"{tag}: recovery R^2 (lstsq-aligned) {r2:.4f}; reached 0.95: {r2 >= 0.95}")
    log(f"{tag}: kernel launches {launches}")
    log(f"{tag}: route calls {calls}")
    log(f"{tag}: fallback counters {fallbacks}")
    if r2 < R2_MIN:
        raise AssertionError(f"{tag}: recovery R^2 {r2:.4f} < {R2_MIN}")
    if fallbacks["gram_exact"] > EXACT_SHARE_MAX * calls["gram"]:
        raise AssertionError(f"{tag}: exact-Cholesky net took {fallbacks['gram_exact']} of "
                             f"{calls['gram']} ns_gram route calls")
    for name in ("mstep_stats", "mstep_update", "hstep_search", "hstep_stat"):
        if launches[name] == 0:
            raise AssertionError(f"{tag} never launched {name}")
    if fused:
        if launches["sweep"] == 0:
            raise AssertionError("the fused-sweep fit never launched sweep")
        if fallbacks["sweep_core"] > CORE_SHARE_MAX * calls["sweep"]:
            raise AssertionError(f"sweep_core took {fallbacks['sweep_core']} of "
                                 f"{calls['sweep']} sweep route calls")
    else:
        for name in ("ns_gram", "ns_gram_stream", "ns_packed", "estep_project", "estep_step"):
            if launches[name] == 0:
                raise AssertionError(f"the default fit never launched {name}")
    return launches, calls, fallbacks, wall, e_s, r2, result


def fresh_trials(ntrial=10):
    """`ntrial` fresh Poisson draws (seed 1) of the flagship's latents under
    its loading, without mu: (trials, true latents)."""
    a = make_workload(ntrial=1)[1]
    trials, _, zt = make_workload(seed=1, ntrial=ntrial, a=a)
    return [{"y": t["y"]} for t in trials], zt


def run_transform(result, ntrial=10):
    """vlgp_tpu_torch.transform of `ntrial` fresh Poisson draws (seed 1) of
    the flagship's latents under a fit's result, with no mu given (the fit's
    factor model starts them), counters set to 0 just before; returns
    (launches, wall s, R^2)."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import spd

    trials, zt = fresh_trials(ntrial)
    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = vlgp_tpu_torch.transform(trials, result)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(spd.KERNEL_LAUNCHES)
    mu = np.concatenate([t["mu"] for t in out])
    if mu.shape != (ntrial * LENGTH, ZDIM) or not all(
            np.isfinite(t[k]).all() for t in out for k in ("mu", "v", "w")):
        raise AssertionError(f"transform: posterior of shape {mu.shape} or not finite")
    r2 = r2_aligned(mu, zt)
    log(f"transform ({ntrial} new trials, seed 1): {wall:.3f} s wall, recovery R^2 "
        f"(lstsq-aligned) {r2:.4f}; kernel launches {launches}; fallback counters "
        f"{dict(spd.FALLBACKS)}")
    for name in ("ns_packed", "ns_gram", "estep_project", "estep_step"):
        if launches[name] == 0:
            raise AssertionError(f"transform never launched {name}")
    if r2 < R2_MIN:
        raise AssertionError(f"transform: recovery R^2 {r2:.4f} < {R2_MIN}")
    return launches, wall, r2


def run_fit_split(fused):
    """run_fit with every ns_gram launch tallied by caller (E-step, H-step,
    final inference) and mode (cold, warm, probe); the tally only reads the
    call stack and the arguments.  Returns (run_fit's result, tally)."""
    from vlgp_tpu_torch.ops import spd

    tally = collections.Counter()
    launch = spd._ns_gram_cuda

    def counted(G, w, iters=16, x0=None, resid_only=False, want_v=False):
        names, f = set(), sys._getframe(1)
        while f is not None:
            names.add(f.f_code.co_name)
            f = f.f_back
        caller = "H-step" if "hstep" in names else "final" if "infer" in names else "E-step"
        mode = "probe" if resid_only else "cold" if x0 is None else "warm"
        tally[f"{caller} {mode}"] += 1
        return launch(G, w, iters, x0, resid_only, want_v)

    spd._ns_gram_cuda = counted
    try:
        result = run_fit(fused)
    finally:
        spd._ns_gram_cuda = launch
    if sum(tally.values()) != result[0]["ns_gram"]:
        raise AssertionError(f"ns_gram tally {dict(tally)} misses launches {result[0]}")
    log(f"ns_gram launches by caller and mode: {dict(sorted(tally.items()))}")
    return result, tally


def run_spd_solve(device, gen, B=10000):
    """The public spd_solve at B10000 R40, counters set to 0 just before."""
    from vlgp_tpu_torch.ops import spd

    R = 40
    A = spd_batch(B, R, device, gen)
    b = torch.randn((B, R), generator=gen, device=device)
    spd.reset_counters()
    x = spd.spd_solve(A, b)
    torch.cuda.synchronize()
    n = spd.KERNEL_LAUNCHES["spd_inverse"]
    if n == 0:
        raise AssertionError("spd_solve never launched spd_inverse")
    err = float((A.double() @ x.double()[..., None] - b.double()[..., None]).abs().amax())
    if not err < 1e-3 * float(b.abs().amax()):
        raise AssertionError(f"spd_solve: residual {err}")
    log(f"spd_solve B={B} R={R}: {n} spd_inverse launch(es), max|Ax - b| {err:.3e}")
    return n


def run_fused_probe(device, gen):
    """inv_one_plus_psd from a drifted carry at the update_v shape with
    VLGP_FUSED_PROBE's route, counters set to 0 just before."""
    from vlgp_tpu_torch.ops import spd

    B, R = ZDIM * NTRIAL, 50
    G = realistic_factor(ZDIM, LENGTH, R, device)
    w0 = torch.rand((ZDIM, NTRIAL, LENGTH), generator=gen, device=device)
    w = w0 * (1e2 / lambda_max(G, w0))
    A = torch.einsum("ztr,zst,ztq->zsrq", G, w, G).contiguous()
    X = spd._ns_packed_plain(A.reshape(B, R, R), 16)[0].reshape(A.shape)
    A2 = A * (1 + 0.05 * (torch.arange(NTRIAL, device=device) % 2))[None, :, None, None]
    spd._FUSED_PROBE = True
    spd.reset_counters()
    Xw = spd.inv_one_plus_psd(A2, warm=X, warm_iters=4)
    torch.cuda.synchronize()
    n = spd.KERNEL_LAUNCHES["probe_skip"]
    spd._FUSED_PROBE = False
    if n == 0:
        raise AssertionError("inv_one_plus_psd with the fused probe never launched probe_skip")
    eye = torch.eye(R, dtype=torch.float64, device=device)
    r64 = float(((A2.double() + eye) @ Xw.double() - eye).abs().amax())
    if not r64 < RESID_TOL:
        raise AssertionError(f"fused probe route: residual {r64}")
    log(f"inv_one_plus_psd (fused probe) B={B} R={R}: {n} probe_skip launch(es), "
        f"fallbacks {spd.FALLBACKS['packed_refine_fail']}, residual (f64) {r64:.3e}")
    return n


def first_use_ms(device):
    """Wall ms of the first call in this process of each dense routine that
    elbo_terms adds to the fit path, on a 4 x 4 matrix: what the first ELBO
    record pays once (library set-up), apart from its own work."""
    A = 2 * torch.eye(4, device=device)[None]
    out = {}
    for name, fn in (("cholesky", torch.linalg.cholesky),
                     ("solve_triangular", lambda m: torch.linalg.solve_triangular(
                         m, m, upper=False))):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        fn(A)
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - tic)
    return out


def run_fit_elbo(default_walls):
    """9a: the flagship fit with track_elbo=True (default E-step), counters
    set to 0 just before; prints the ELBO series and the wall time of each
    record (models.driver._elbo_record, timed from outside: elbo_terms returns
    floats, so each record ends in a host sync).  Returns (launches, wall s,
    FitResult)."""
    from vlgp_tpu_torch.models import driver

    record, walls = driver._elbo_record, []

    def timed(*args):
        tic = time.perf_counter()
        record(*args)
        walls.append(1e3 * (time.perf_counter() - tic))

    first = first_use_ms(torch.device("cuda"))
    driver._elbo_record = timed
    launches, _, _, wall, _, r2, result = run_fit(False, track_elbo=True)
    driver._elbo_record = record
    e = np.asarray(result.runtime["elbo"])
    if not (len(e) == result.runtime["it"] and np.isfinite(e).all()):
        raise AssertionError(f"ELBO series of {len(e)} records for {result.runtime['it']} "
                             f"iterations, finite: {np.isfinite(e).all()}")
    if launches["ns_packed"] < len(e):
        raise AssertionError(f"{launches['ns_packed']} ns_packed launches for {len(e)} "
                             "ELBO records")
    drops = -np.diff(e)[np.diff(e) < 0]
    rel = np.abs(np.diff(e)) / np.abs(e[1:])

    def first_under(tol):
        hit = np.nonzero(rel < tol)[0]
        return int(hit[0]) + 2 if hit.size else None  # 1-based iteration of the record

    log(f"9a ELBO-tracked fit: {wall:.2f} s wall (default fits {default_walls[0]:.2f} / "
        f"{default_walls[1]:.2f} s), R^2 {r2:.4f}, {len(e)} records, ns_packed "
        f"{launches['ns_packed']} launches")
    fell = (f" (largest {float(drops.max())!r}, total {float(drops.sum())!r})"
            if len(drops) else "")
    log(f"9a ELBO series: first {float(e[0])!r}, last {float(e[-1])!r}; {len(drops)} "
        f"decreases{fell}; relative change first < 1e-5 at iteration {first_under(1e-5)}, "
        f"< 1e-6 at {first_under(1e-6)}")
    log("9a first use in this process, before the fit: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in first.items()))
    log(f"9a ELBO record wall: first {walls[0]:.2f} ms, then median "
        f"{statistics.median(walls[1:]):.2f} ms [{min(walls[1:]):.2f}-{max(walls[1:]):.2f}], "
        f"{sum(walls) / 1e3:.3f} s in all")
    return launches, wall, result


def _cpu64(obj):
    """A TrialSet or Params with every float tensor as float64 on the CPU."""
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: (t.double().cpu() if t.is_floating_point() else t.cpu())
        for f in dataclasses.fields(obj)
        if isinstance(t := getattr(obj, f.name), torch.Tensor)})


def check_elbo_card_vs_cpu(result):
    """9b: elbo_terms of a fit's result on the card in float32 against the
    CPU in float64 from the same state, on the segments as fit cuts and
    factors them and on the full-length state; the card's call timed.
    Returns {state: (relative elbo gap, card ms)}."""
    from vlgp_tpu_torch.data import cut_trials
    from vlgp_tpu_torch.evaluation import elbo_terms
    from vlgp_tpu_torch.models.gp import effective_rank, make_cholesky
    from vlgp_tpu_torch.ops import spd

    data, params, config = result.data, result.params, result.config
    segments = cut_trials(data, config.window, seed=config.seed)
    omega_hi = max(float(params.omega.max()), config.omega_bound[1])
    seg_rank = min(params.rank, effective_rank(segments.nbin, omega_hi, params.dt))
    G_seg = make_cholesky(segments.nbin, params, rank=seg_rank)
    out = {}
    for name, d, G in (("segments", segments, G_seg), ("full-length", data, result.G)):
        spd.reset_counters()
        card = elbo_terms(d, params, G)
        n_packed = spd.KERNEL_LAUNCHES["ns_packed"]
        walls = []
        for _ in range(5):
            tic = time.perf_counter()
            elbo_terms(d, params, G)  # returns floats: ends in a host sync
            walls.append(1e3 * (time.perf_counter() - tic))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            elbo_terms(d, params, G)
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:6]
        log(f"9b elbo_terms on the {name} state, one call traced: device time "
            f"{sum(e.self_device_time_total for e in prof.key_averages()) / 1e3:.2f} ms; top: "
            + ", ".join(f"{e.key} {e.self_device_time_total / 1e3:.2f} ms ({e.count})"
                        for e in ops))
        cpu = elbo_terms(_cpu64(d), _cpu64(params), G.double().cpu())
        gaps = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
        log(f"9b elbo_terms on the {name} state (G {tuple(G.shape)}): card float32 "
            f"{statistics.median(walls):.2f} ms [{min(walls):.2f}-{max(walls):.2f}] per call, "
            f"{n_packed} ns_packed launch(es); card float32 / CPU float64 / relative gap: "
            + ", ".join(f"{k} {card[k]!r} / {cpu[k]!r} / {gaps[k]:.3e}" for k in cpu))
        if not (all(np.isfinite(v) for v in card.values()) and gaps["elbo"] <= ELBO_RTOL):
            raise AssertionError(f"9b {name}: card ELBO {card} against CPU {cpu}: relative "
                                 f"gap {gaps['elbo']:.3e} > {ELBO_RTOL}")
        if n_packed == 0:
            raise AssertionError(f"9b {name}: elbo_terms never launched ns_packed")
        out[name] = (gaps["elbo"], statistics.median(walls))
    return out


def run_leave_one_neuron_out(result, card):
    """9c: leave_one_neuron_out over every neuron of a fit's result at each
    batch of LONO_BATCHES, counters and the peak memory statistic set to 0
    just before each run; each score against the latent-free baseline of
    tests/test_model_selection.py, and the batched scores against batch 1's
    within LONO_TOL.  Returns {batch: (launches, wall s, peak bytes)}."""
    from vlgp_tpu_torch import model_selection as ms
    from vlgp_tpu_torch.ops import control, spd

    d, b = result.data, result.params.b
    m = d.mask
    eta0 = torch.einsum("stxn,xn->stn", d.x, b)
    ll0 = (((d.y * eta0 - torch.exp(eta0)) * m[..., None]).sum((0, 1)) / m.sum()).cpu()
    base = torch.cuda.memory_allocated()
    runs, scores_of, sweeps_of = {}, {}, {}
    for batch in LONO_BATCHES:
        spd.reset_counters()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        scores = ms.leave_one_neuron_out(result, batch=batch)  # ends in a host read
        wall = time.perf_counter() - tic
        peak = torch.cuda.max_memory_allocated()
        launches = dict(spd.KERNEL_LAUNCHES)
        chunks = list(ms.LONO_CHUNKS)
        wins = sum(scores[n] > float(ll0[n]) for n in range(YDIM))
        per_chunk = " ".join(f"{min(c['sweeps'])}/{max(c['sweeps'])}/{sum(c['sweeps'])}:"
                             f"{c['rounds']}" for c in chunks)
        log(f"9c leave_one_neuron_out batch={batch} [{card}]: {len(scores)} neurons in "
            f"{len(chunks)} chunks, {wall:.3f} s wall, peak memory {peak / 2**30:.3f} GiB "
            f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before), "
            f"kernel launches {launches}, rounds {control.TRIPS['lono_rounds']}; {wins} of "
            f"{YDIM} neurons beat the latent-free baseline; scores "
            f"{min(scores.values()):.4f} to {max(scores.values()):.4f} per bin")
        log(f"  member sweeps min/max/sum:rounds per chunk: {per_chunk}")
        if not (len(scores) == YDIM and all(np.isfinite(v) for v in scores.values())):
            raise AssertionError(f"9c batch={batch}: missing or non-finite scores")
        if not wins > YDIM // 2:
            raise AssertionError(f"9c batch={batch}: only {wins} of {YDIM} neurons beat the "
                                 f"baseline")
        for name in ("ns_gram", "ns_packed"):
            if launches[name] == 0:
                raise AssertionError(f"9c batch={batch}: never launched {name}")
        # the chunk's GEMMs (Z5 S2500 T1000 R50) take the streaming GEMM
        if batch == max(LONO_BATCHES) and launches["ns_gram_pairs_stream"] == 0:
            raise AssertionError(f"9c batch={batch}: ns_gram's long-T GEMMs never took the "
                                 f"streaming GEMM")
        # every round of every chunk is one launch of each E-step kernel
        rounds = control.TRIPS["lono_rounds"]
        if not launches["estep_project"] == launches["estep_step"] == rounds > 0:
            raise AssertionError(f"9c batch={batch}: estep_project / estep_step launched "
                                 f"{launches['estep_project']} / {launches['estep_step']} times "
                                 f"in {rounds} rounds")
        runs[batch] = (launches, wall, peak)
        scores_of[batch] = scores
        sweeps_of[batch] = {n: s for c in chunks for n, s in zip(c["neurons"], c["sweeps"])}
    one = scores_of[1]
    for batch in LONO_BATCHES[1:]:
        gap = max(abs(scores_of[batch][n] - one[n]) for n in one)
        rel = max(abs(scores_of[batch][n] - one[n]) / abs(one[n]) for n in one)
        moved = sum(sweeps_of[batch][n] != sweeps_of[1][n] for n in one)
        log(f"9c batch={batch} against batch=1 [{card}]: max |d score| {gap:.3e} (relative "
            f"{rel:.3e}, tolerance {LONO_TOL:.1e}); {moved} of {YDIM} neurons swept another "
            f"count; wall {runs[batch][1]:.3f} s against {runs[1][1]:.3f} s; ns_gram launches "
            f"{runs[batch][0]['ns_gram']} against {runs[1][0]['ns_gram']}")
        if not gap <= LONO_TOL:
            raise AssertionError(f"9c batch={batch}: scores differ from batch=1's by {gap:.3e} "
                                 f"> {LONO_TOL}")
    # where the time goes at the largest batch: one more call, traced
    wall, busy, by_name = trace_kernels(lambda: ms.leave_one_neuron_out(
        result, batch=max(LONO_BATCHES)))
    groups = collections.Counter()
    for name, t in by_name.items():
        kind = next((k for k, keys in LONO_KERNEL_KINDS if any(x in name for x in keys)),
                    "other")
        groups[kind] += t
    log(f"9c traced batch={max(LONO_BATCHES)} [{card}]: {wall:.3f} s wall, kernels busy "
        f"{busy:.3f} s ({1 - busy / wall:.1%} of the wall without a kernel); kernel s by kind "
        + ", ".join(f"{k} {groups[k]:.3f}" for k, _ in LONO_KERNEL_KINDS + (("other", ()),))
        + f"; elementwise {groups['elementwise'] / max(busy, 1e-30):.1%} of the kernels' time")
    if not runs[max(LONO_BATCHES)][0]["ns_gram"] < runs[1][0]["ns_gram"]:
        raise AssertionError("9c: the largest batch made no fewer ns_gram launches than batch=1")
    peaks = [runs[batch][2] for batch in sorted(LONO_BATCHES)]
    if not all(p < q for p, q in zip(peaks, peaks[1:])):
        raise AssertionError(f"9c: peak memory {peaks} does not grow with the batch")
    return runs


def trace_kernels(fn):
    """fn() under torch.profiler: (wall s, seconds covered by device kernels,
    {kernel name: device s})."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    spans, by_name = [], collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            by_name[e.name()] += e.duration_ns() * 1e-9
    return wall, _union_s(spans), by_name


def run_sample_posterior(result, device, nsamples=1000):
    """9d: sample_posterior of trial 0 on the card; the sample mean within 5
    standard errors of mu at 99% of the bins.  Returns the wall s."""
    import vlgp_tpu_torch

    torch.cuda.synchronize()
    tic = time.perf_counter()
    s = vlgp_tpu_torch.sample_posterior(result, 0, nsamples)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    mu = result.data.mu[0]
    se = s.std(0) / nsamples ** 0.5
    share = float((torch.abs(s.mean(0) - mu) <= 5 * se).double().mean())
    log(f"9d sample_posterior (trial 0, {nsamples} samples, lowrank): {wall:.3f} s wall, "
        f"shape {tuple(s.shape)} on {s.device}; sample mean within 5 SE of mu at "
        f"{100 * share:.2f}% of the bins")
    if not (s.device.type == device.type and tuple(s.shape) == (nsamples, LENGTH, ZDIM)
            and torch.isfinite(s).all() and share >= 0.99):
        raise AssertionError("9d: sample_posterior samples off the card, misshaped, "
                             "non-finite or off the posterior mean")
    return wall


def run_gpfa_warm_start_and_cv(device):
    """9e: fastfit (20 GPFA iterations, then map2vi's 5 vLGP iterations) on
    the flagship trials without their mu, and the speckled CV sweep over 3,
    5 and 7 factors, counters set to 0 before each.  Returns (fastfit wall
    s, R^2, CV wall s)."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.model_selection import gmap_speckled_cv
    from vlgp_tpu_torch.ops import spd

    trials, _, zt = make_workload()
    for t in trials:
        del t["mu"]
    gp = dict(dt=1.0, var=1.0, scale=7.07)  # omega = 0.5 / 7.07^2 = 1e-2
    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    res = vlgp_tpu_torch.fastfit(trials, ZDIM, **gp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    mu = res.data.mu
    r2 = r2_aligned(mu.cpu().numpy().reshape(-1, ZDIM), zt)
    log(f"9e fastfit (20 GPFA + {res.runtime['it']} vLGP iterations): {wall:.2f} s wall, "
        f"R^2 {r2:.4f}, omega {res.params.omega.tolist()}; kernel launches "
        f"{dict(spd.KERNEL_LAUNCHES)}")
    if not (mu.device.type == device.type and torch.isfinite(mu).all()):
        raise AssertionError("9e: fastfit posterior off the card or non-finite")
    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    tr, te = gmap_speckled_cv(trials, (3, 5, 7), test_ratio=0.1, max_iter=20, window=50, **gp)
    cv_wall = time.perf_counter() - tic
    log(f"9e gmap_speckled_cv n_factors (3, 5, 7): {cv_wall:.2f} s wall; training errors "
        f"{tr}, test errors {te}")
    if not all(np.isfinite(tr + te)):
        raise AssertionError("9e: non-finite cross-validation errors")
    return wall, r2, cv_wall


def run_lorenz(device):
    """9f: examples/tutorial_lorenz.py's recipe at the flagship widths on the
    card: one normalised Lorenz trajectory, trial i reading it from bin 1000 +
    1000 i, latents x 2, a ~ N(0, 0.6^2) and bias -2.5 (NumPy seed 0), spikes
    from a generator seeded 0; fit with 3 factors and no a or b (factor
    analysis on the card), 30 EM iterations.  The trajectory is one launch of
    the lorenz kernel, counted from 0 just before.  Returns (simulation s,
    fit s, R^2, lorenz launches)."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import spd
    from vlgp_tpu_torch.simulation import lorenz, spike

    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    traj = lorenz(LORENZ_STEPS, normalized=True, device=device)
    torch.cuda.synchronize()
    lorenz_s = time.perf_counter() - tic
    launches = spd.KERNEL_LAUNCHES["lorenz"]
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, YDIM)) * 0.6
    b = np.full((1, YDIM), -2.5)
    z = torch.stack([traj[1000 + i * LENGTH: 1000 + (i + 1) * LENGTH] for i in range(NTRIAL)])
    z = (z * 2.0).float()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    y, _, _ = spike(z, a, b, gen)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - tic
    trials = [{"y": yi} for yi in y.cpu().numpy()]
    tic = time.perf_counter()
    res = vlgp_tpu_torch.fit(trials, 3, max_iter=30)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - tic
    r2 = r2_aligned(res.data.mu.cpu().numpy().reshape(-1, 3), z.cpu().numpy().reshape(-1, 3))
    log(f"9f Lorenz -> Poisson ({NTRIAL} x {LENGTH} x {YDIM}, 3 factors): simulation "
        f"{sim_s:.4f} s (lorenz {lorenz_s:.4f} s for {LORENZ_STEPS} steps in {launches} "
        f"launch(es) of its kernel; spike and the rest {sim_s - lorenz_s:.4f} s), spike rate "
        f"{float(y.mean()):.4f} per bin; fit {fit_s:.2f} s, {res.runtime['it']} EM "
        f"iterations, R^2 (lstsq-aligned) {r2:.4f}")
    if launches != 1:
        raise AssertionError(f"9f: lorenz made {launches} kernel launches, not 1")
    if not (y.device.type == res.data.mu.device.type == device.type and r2 >= R2_LORENZ_MIN):
        raise AssertionError(f"9f: Lorenz fit R^2 {r2:.4f} < {R2_LORENZ_MIN}, or off the card")
    return sim_s, fit_s, r2, launches


def result_diff(a, b):
    """Names of the fields where two FitResults differ: each tensor in dtype,
    shape, device or any bit; the config, the Params' scalars, the runtime."""
    def tensors(r):
        out = {f"data.{k}": v for k, v in vars(r.data).items()}
        out.update({f"params.{k}": v for k, v in vars(r.params).items()
                    if isinstance(v, torch.Tensor)})
        if r.factor_model is not None:
            out.update({f"fm.{k}": v for k, v in vars(r.factor_model).items()})
        out["G"] = r.G
        return out

    ta, tb = tensors(a), tensors(b)
    bad = sorted(set(ta) ^ set(tb))
    bad += [k for k in sorted(set(ta) & set(tb))
            if not (ta[k].dtype == tb[k].dtype and ta[k].device == tb[k].device
                    and torch.equal(ta[k], tb[k]))]
    for name in ("gp_noise", "dt", "rank", "likelihood_kind"):
        if getattr(a.params, name) != getattr(b.params, name):
            bad.append(f"params.{name}")
    if a.config != b.config:
        bad.append("config")
    if a.runtime != b.runtime:
        bad.append("runtime")
    return bad


def same_trials(out_a, out_b):
    """Whether two transform outputs hold the same mu, w and v, bit for bit."""
    return len(out_a) == len(out_b) and all(
        np.array_equal(ta[k], tb[k]) for ta, tb in zip(out_a, out_b) for k in ("mu", "w", "v"))


def run_save_load(result, work, card):
    """10a: save a fit's result, load it on the card, and require every
    tensor, the config and the runtime equal bit for bit; transform of the
    10 fresh trials under the loaded result equal to that under the
    in-memory one; resume of the loaded result for 2 EM iterations.
    Counters set to 0 just before."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import spd

    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    path = vlgp_tpu_torch.save(result, work / "fit")
    save_s = time.perf_counter() - tic
    tic = time.perf_counter()
    loaded = vlgp_tpu_torch.load(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - tic
    diff = result_diff(result, loaded)
    if diff or loaded.data.mu.device.type != "cuda":
        raise AssertionError(f"10a: the loaded result differs from the saved one in {diff}, "
                             f"or lies on {loaded.data.mu.device}")
    trials, _ = fresh_trials()
    out_mem = vlgp_tpu_torch.transform(trials, result)
    out_load = vlgp_tpu_torch.transform(trials, loaded)
    if not same_trials(out_mem, out_load):
        raise AssertionError("10a: transform under the loaded result differs from transform "
                             "under the in-memory one")
    torch.cuda.synchronize()
    tic = time.perf_counter()
    resumed = loaded
    for _ in range(2):
        resumed = vlgp_tpu_torch.resume(resumed)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - tic
    if not (resumed.data.mu.device.type == "cuda" and torch.isfinite(resumed.data.mu).all()
            and torch.isfinite(resumed.params.a).all()):
        raise AssertionError("10a: resume of the loaded result is off the card or not finite")
    launches = dict(spd.KERNEL_LAUNCHES)
    log(f"10a save/load [{card}]: {path.stat().st_size} bytes, save {save_s:.3f} s, load "
        f"{load_s:.3f} s; every tensor, the config and the runtime equal bit for bit; "
        f"transform of 10 fresh trials under the loaded result equal bit for bit to the "
        f"in-memory one's; resume x2 {resume_s:.3f} s; kernel launches {launches}")
    for name in ("ns_gram", "ns_packed"):
        if launches[name] == 0:
            raise AssertionError(f"10a: transform never launched {name}")


def run_checkpointed_fit(work, default_walls, card):
    """10b: the phase-8 default fit with path= and saving_interval=0 (run_fit,
    counters set to 0 just before): vlgp_tpu's Saver cadence writes a
    snapshot after each EM iteration and one at the end; the file holds
    save_params of the returned params; then a save_checkpoint /
    restore_checkpoint round trip of the params and posterior."""
    from vlgp_tpu_torch import callback
    from vlgp_tpu_torch.utils.io import restore_checkpoint, save_checkpoint, save_params

    snaps = []
    save = callback.save_params

    def counted(params, path):
        snaps.append(path)
        return save(params, path)

    callback.save_params = counted
    try:
        launches, _, _, wall, _, r2, result = run_fit(False, path=str(work / "snap"),
                                                       saving_interval=0)
    finally:
        callback.save_params = save
    it = result.runtime["it"]
    if len(snaps) != it + 1:
        raise AssertionError(f"10b: {len(snaps)} snapshots for {it} EM iterations, not {it + 1}")
    ref = save_params(result.params, work / "ref")
    with np.load(work / "snap.npz") as z_snap, np.load(ref) as z_ref:
        if sorted(z_snap.files) != sorted(z_ref.files) or not all(
                z_snap[k].dtype == z_ref[k].dtype and np.array_equal(z_snap[k], z_ref[k])
                for k in z_ref.files):
            raise AssertionError("10b: the snapshot on disk differs from save_params of the "
                                 "returned params")
    tic = time.perf_counter()
    ckpt = save_checkpoint(work / "ckpt", result.params, result.data, step=it)
    like = result.params.replace(a=torch.zeros_like(result.params.a))
    params, post = restore_checkpoint(ckpt, like, result.data)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - tic
    if not (all(torch.equal(getattr(params, f), getattr(result.params, f))
                for f in ("a", "b", "noise", "sigma", "omega", "poisson", "da", "db"))
            and all(torch.equal(post[k], getattr(result.data, k)) for k in ("mu", "w", "v"))
            and params.a.device.type == "cuda"):
        raise AssertionError("10b: restore_checkpoint does not give back the saved state")
    log(f"10b checkpointed fit [{card}]: {wall:.2f} s wall (phase 8 default fit "
        f"{default_walls[0]:.2f} / {default_walls[1]:.2f} s), {it} EM iterations, "
        f"{len(snaps)} snapshots (one per EM iteration and one at the end), R^2 {r2:.4f}; "
        f"snapshot equal to save_params of the returned params; checkpoint round trip "
        f"{ckpt_s:.3f} s ({ckpt.stat().st_size} bytes); kernel launches {launches}")


def run_cli(work, card):
    """10c: the flagship workload (y only) and the 10 fresh trials written as
    stacked npz files; `python3 -m vlgp_tpu_torch fit in.npz out.npz 5 --path
    snap` and `transform fresh.npz out.npz mu.npz` as subprocesses on the
    card; out.npz loaded here against an in-process fit with the CLI's
    settings (counters set to 0 just before it) and mu.npz against
    transform under it.  No kernel library may be rebuilt by the
    subprocesses."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import _build, spd

    trials, _, zt = make_workload()
    trials = [{"y": t["y"]} for t in trials]
    fresh, zt_fresh = fresh_trials()
    fin, ffresh = work / "in.npz", work / "fresh.npz"
    fout, fmu, snap = work / "out.npz", work / "mu.npz", work / "cli_snap"
    np.savez(fin, y=np.stack([t["y"] for t in trials]))
    np.savez(ffresh, y=np.stack([t["y"] for t in fresh]))

    def libraries():
        return {p.name: p.stat().st_mtime_ns for p in _build.BUILD_DIR.glob("*.so")}

    before = libraries()
    walls = {}
    for name, argv in (("fit", ["fit", fin, fout, ZDIM, "--path", snap]),
                       ("transform", ["transform", ffresh, fout, fmu])):
        tic = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vlgp_tpu_torch", *map(str, argv)],
                              cwd=ROOT, capture_output=True, text=True, timeout=600)
        walls[name] = time.perf_counter() - tic
        if proc.returncode != 0:
            raise AssertionError(f"10c: `{name}` exited {proc.returncode}:\n"
                                 f"{proc.stderr[-4000:]}")
    if libraries() != before:
        raise AssertionError(f"10c: the subprocesses rebuilt kernel libraries: {before} -> "
                             f"{libraries()}")
    if not snap.with_suffix(".npz").exists():
        raise AssertionError("10c: the CLI fit wrote no snapshot")
    cli = vlgp_tpu_torch.load(fout)

    spd.reset_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    ref = vlgp_tpu_torch.fit(trials, ZDIM, lik="poisson", max_iter=20, min_iter=5,
                             dtype="float32", fused=False, block=1, path=None, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(spd.KERNEL_LAUNCHES)
    # the factor-analysis subsample is integer draws from a seeded generator
    # (init._subsample_rows), so the fit in the CLI's process and this one
    # agree bit for bit
    gap = float((cli.data.mu - ref.data.mu).abs().max())
    if not (torch.equal(cli.data.mu, ref.data.mu) and torch.equal(cli.params.a, ref.params.a)):
        raise AssertionError(f"10c: the CLI fit differs from the in-process fit (max |dmu| "
                             f"{gap:.3e})")
    r2 = r2_aligned(cli.data.mu.cpu().numpy().reshape(-1, ZDIM), zt)
    if r2 < R2_CLI_MIN:
        raise AssertionError(f"10c: the CLI fit's R^2 {r2:.4f} < {R2_CLI_MIN}")
    out = vlgp_tpu_torch.transform(fresh, ref)
    with np.load(fmu) as z:
        cli_mu = [z[f"mu{i}"] for i in range(len(fresh))]
    if not all(np.array_equal(m, t["mu"]) for m, t in zip(cli_mu, out)):
        raise AssertionError("10c: the CLI transform differs from transform under the "
                             "in-process fit")
    r2_t = r2_aligned(np.concatenate(cli_mu), zt_fresh)
    log(f"10c command line [{card}]: fit subprocess {walls['fit']:.2f} s wall, transform "
        f"subprocess {walls['transform']:.2f} s; in-process fit {wall:.2f} s, "
        f"{ref.runtime['it']} EM iterations, kernel launches {launches}; CLI fit equal bit for "
        f"bit to the in-process fit, R^2 {r2:.4f} (floor {R2_CLI_MIN}); CLI transform equal "
        f"bit for bit, R^2 {r2_t:.4f}; no kernel library rebuilt")
    for name in ("ns_gram", "ns_packed"):
        if launches[name] == 0:
            raise AssertionError(f"10c: the in-process fit never launched {name}")


PARAM_FIELDS = ("a", "b", "noise", "sigma", "omega", "da", "db")


def param_recorder():
    """(list, callback): the callback appends a copy of the params' tensors
    at every EM iteration boundary."""
    seen = []

    def record(data, params, config):
        seen.append({f: getattr(params, f).clone() for f in PARAM_FIELDS})

    return seen, record


def same_boundaries(seen, ref):
    """Indices of the boundaries where two param records differ (every
    boundary when their lengths differ)."""
    if len(seen) != len(ref):
        return list(range(max(len(seen), len(ref))))
    return [i for i, (x, y) in enumerate(zip(seen, ref))
            if any(not torch.equal(x[f], y[f]) for f in PARAM_FIELDS)]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def reset_all_counters():
    from vlgp_tpu_torch.models import vlgp as tv
    from vlgp_tpu_torch.ops import spd

    spd.reset_counters()
    for k in tv.COLLECTIVES:
        tv.COLLECTIVES[k] = 0


def sharded_fit(recorder, ydim=YDIM, **kw):
    """fit_sharded on the flagship workload, or on its first ``ydim``
    neurons, counters set to 0 just before; returns (result, wall s,
    launches, collectives, R^2)."""
    from vlgp_tpu_torch.models import vlgp as tv
    from vlgp_tpu_torch.ops import spd
    from vlgp_tpu_torch.parallel.driver import fit_sharded

    trials, a, zt = make_workload()
    trials = [dict(t, y=t["y"][:, :ydim]) for t in trials]
    flagship = dict(FLAGSHIP_KW, b=FLAGSHIP_KW["b"][:, :ydim])
    reset_all_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    result = fit_sharded(trials, ZDIM, a=a[:, :ydim], callbacks=[recorder], **flagship, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches, coll = dict(spd.KERNEL_LAUNCHES), dict(tv.COLLECTIVES)
    mu = result.data.mu
    if tuple(mu.shape) != (NTRIAL, LENGTH, ZDIM) or mu.device.type != "cuda" or not all(
            torch.isfinite(getattr(result.data, f)).all() for f in ("mu", "v", "w")):
        raise AssertionError(f"sharded fit: posterior of shape {tuple(mu.shape)} on "
                             f"{mu.device}, or not finite")
    return result, wall, launches, coll, r2_aligned(mu.cpu().numpy().reshape(-1, ZDIM), zt)


# bytes of one iteration boundary's gather, all ranks' parts: the posterior
# fields (mu, w, v, dmu) of the flagship's 2000 window-50 segments, float32
BOUNDARY_BYTES = 4 * NTRIAL * -(-LENGTH // 50) * 50 * ZDIM * 4


def run_sharded_world1(card):
    """11a: fit_sharded in process over an nccl group of one rank against fit
    with the same settings, both recording the params at every boundary."""
    import datetime

    import torch.distributed as tdist

    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import spd

    trials, a, zt = make_workload()
    seen_fit, rec_fit = param_recorder()
    reset_all_counters()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    ref = vlgp_tpu_torch.fit(trials, ZDIM, a=a, callbacks=[rec_fit], **FLAGSHIP_KW)
    torch.cuda.synchronize()
    wall_fit = time.perf_counter() - tic
    launches_fit = dict(spd.KERNEL_LAUNCHES)
    r2_fit = r2_aligned(ref.data.mu.cpu().numpy().reshape(-1, ZDIM), zt)

    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                             world_size=1, timeout=datetime.timedelta(seconds=120))
    seen, rec = param_recorder()
    got, wall, launches, coll, r2 = sharded_fit(rec)  # mesh and device by default
    tdist.destroy_process_group()
    it = got.runtime["it"]
    log(f"11a fit [{card}]: {wall_fit:.2f} s wall, {ref.runtime['it']} EM iterations "
        f"(converged_at {ref.runtime.get('converged_at')}), R^2 {r2_fit:.4f}, "
        f"launches {launches_fit}")
    log(f"11a fit_sharded, nccl world 1 [{card}]: {wall:.2f} s wall, {it} EM iterations "
        f"(converged_at {got.runtime.get('converged_at')}, final_hstep "
        f"{got.runtime.get('final_hstep', False)}), R^2 {r2:.4f}, launches {launches}, "
        f"collectives {coll} ({coll['all_reduce'] / it:.1f} all_reduce per EM iteration, "
        f"{BOUNDARY_BYTES} bytes gathered per boundary)")
    diff = same_boundaries(seen, seen_fit)
    if diff:
        raise AssertionError(f"11a: {len(seen)} vs {len(seen_fit)} boundaries; params differ "
                             f"from fit's at boundaries {diff}")
    if got.runtime.get("converged_at") != ref.runtime.get("converged_at"):
        raise AssertionError("11a: converged_at differs from fit's")

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max())

    gap_om = rel(got.params.omega, ref.params.omega)
    gap_mu = rel(got.data.mu, ref.data.mu)
    log(f"11a: params equal bit for bit at all {len(seen)} boundaries; after the closing "
        f"H-step: max |d omega| / max |omega| {gap_om:.3e}, max |d mu| / max |mu| "
        f"{gap_mu:.3e}, R^2 {r2:.4f} vs {r2_fit:.4f}")
    if abs(r2 - r2_fit) > R2_SHARD_GAP or r2 < R2_MIN:
        raise AssertionError(f"11a: R^2 {r2:.4f} against fit's {r2_fit:.4f}")
    for name in ("ns_gram", "ns_packed"):
        if launches[name] == 0:
            raise AssertionError(f"11a: fit_sharded never launched {name}")
    return r2


def sharded_worker(rank, world, port, out, shape, ydim):
    """One rank of 11b, 11c or 11d: a gloo group on CUDA tensors, this rank's
    block of a ``shape`` mesh on the one card; writes its result to ``out``."""
    import datetime

    import torch.distributed as tdist

    from vlgp_tpu_torch.models import vlgp as tv
    from vlgp_tpu_torch.ops import spd
    from vlgp_tpu_torch.parallel import driver, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks share the host's cores (host-side work, gloo's staging)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // world))
    timeout = datetime.timedelta(seconds=120)
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                             world_size=world, timeout=timeout)
    mesh = make_mesh(shape, device="cuda:0", timeout=timeout)
    # asked for, and never eligible under a model axis (ops/sweep.py)
    tv._SWEEP_FUSED = mesh.model > 1
    # this rank's last channel after every EM step (a padded one in 11d)
    tails, step_of = [], driver.sharded_em_step

    def recorded(*args):
        step = step_of(*args)

        def run(*state):
            out = step(*state)
            p = out[1]
            tails.append({f: getattr(p, f)[..., -1].cpu() for f in ("a", "b", "da", "db")}
                         | {"active": None if p.active is None else bool(p.active[-1])})
            return out

        return run

    driver.sharded_em_step = recorded
    seen, rec = param_recorder()
    got, wall, launches, coll, r2 = sharded_fit(rec, ydim=ydim, mesh=mesh)
    routes = dict(spd.ROUTE_CALLS)
    tdist.destroy_process_group()
    torch.save({"params": {f: getattr(got.params, f).cpu() for f in PARAM_FIELDS},
                "mu": got.data.mu.cpu(), "v": got.data.v.cpu(), "w": got.data.w.cpu(),
                "seen": [s["a"].shape[-1] for s in seen], "it": got.runtime["it"],
                "converged_at": got.runtime.get("converged_at"),
                "final_hstep": got.runtime.get("final_hstep", False), "wall": wall,
                "em_s": sum(got.runtime["em_elapsed"]), "launches": launches,
                "routes": routes, "collectives": coll, "r2": r2, "coords": mesh.coords,
                "ydim": got.data.y.shape[-1], "tails": tails}, out)


# bytes of one E-step sweep's two model-axis all_reduces (residual @ a and
# the weights, each (Z, S, T) float32 over the flagship's 2000 segments)
SWEEP_MODEL_BYTES = 2 * ZDIM * NTRIAL * -(-LENGTH // 50) * 50 * 4


def run_sharded_gloo(card, r2_world1, tag="11b", shape=(2, 1), ydim=YDIM):
    """11b, 11c and 11d: two processes on the one card over a gloo group, on
    a ``shape`` mesh, fitting the first ``ydim`` neurons; both ranks equal
    bit for bit and R^2 >= R2_MIN; within R2_SHARD_GAP of 11a on all
    neurons; with a model axis, no sweep launch and the padded channel
    exactly zero."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix=".smoke11_", dir=ROOT) as tmp:
        outs = [f"{tmp}/rank{r}.pt" for r in range(2)]
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r),
                                   "--world", "2", "--port", str(port), "--out", outs[r],
                                   "--mesh", f"{shape[0]}x{shape[1]}", "--ydim", str(ydim)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            texts = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, text) in enumerate(zip(procs, texts)):
            if p.returncode != 0:
                raise AssertionError(f"{tag}: rank {r} exited {p.returncode}:\n{text[-4000:]}")
        res = [torch.load(o, weights_only=False) for o in outs]
    for r, x in enumerate(res):
        c, it = x["collectives"], x["it"]
        log(f"{tag} rank {r} at {x['coords']} of a {shape[0]}x{shape[1]} mesh, gloo on one card "
            f"[{card}]: {x['wall']:.2f} s wall (EM loop {x['em_s']:.2f} s), {it} EM iterations "
            f"(converged_at {x['converged_at']}, final_hstep {x['final_hstep']}), {ydim} "
            f"neurons, R^2 {x['r2']:.4f}, launches {x['launches']}, sweep route calls "
            f"{x['routes']['sweep']}, collectives {c}; all_reduce per EM iteration: data "
            f"{c['all_reduce_data'] / it:.1f}, model {c['all_reduce_model'] / it:.1f}; bytes: "
            f"data {c['bytes_data']}, model {c['bytes_model']} = "
            f"{c['bytes_model'] // SWEEP_MODEL_BYTES} x {SWEEP_MODEL_BYTES} + "
            f"{c['bytes_model'] % SWEEP_MODEL_BYTES}")
    a, b = res
    same = (all(torch.equal(a["params"][f], b["params"][f]) for f in PARAM_FIELDS)
            and all(torch.equal(a[f], b[f]) for f in ("mu", "v", "w"))
            and a["collectives"] == b["collectives"] and a["it"] == b["it"])
    log(f"{tag}: ranks equal bit for bit: {same}; R^2 {a['r2']:.4f} vs 11a {r2_world1:.4f}")
    if not same:
        raise AssertionError(f"{tag}: the two ranks disagree")
    if a["r2"] < R2_MIN or (ydim == YDIM and abs(a["r2"] - r2_world1) > R2_SHARD_GAP):
        raise AssertionError(f"{tag}: R^2 {a['r2']:.4f} against 11a's {r2_world1:.4f}")
    for r, x in enumerate(res):
        if x["ydim"] != ydim or set(x["seen"]) != {ydim}:
            raise AssertionError(f"{tag}: rank {r} returned {x['ydim']} channels, its callbacks "
                                 f"saw {set(x['seen'])}, not {ydim}")
        for name in ("ns_gram", "ns_packed"):
            if x["launches"][name] == 0:
                raise AssertionError(f"{tag}: rank {r} never launched {name}")
        if shape[1] > 1 and (x["launches"]["sweep"] or x["routes"]["sweep"]):
            raise AssertionError(f"{tag}: rank {r} ran the fused sweep under a model axis")
    if ydim % shape[1]:
        # the last rank of the data row holds the padded channels
        pad = res[-1]["tails"]
        zero = all(t["active"] is False and all(not t[f].any() for f in ("a", "b", "da", "db"))
                   for t in pad)
        log(f"{tag}: the padded channel on rank 1 is inactive, and its a, b, da and db exactly "
            f"zero at all {len(pad)} EM iteration boundaries: {zero}")
        if not zero or len(pad) != a["it"]:
            raise AssertionError(f"{tag}: the padded channel moved")


# ---------------------------------------------------------------------------
# 12: the fused and scanned EM drivers as CUDA graphs
# ---------------------------------------------------------------------------

# 12a/12c: a graph-replayed fit's R^2 against the eager fit's (the H-step's
# omega basin moves R^2 by about +-0.004 under float noise, as in phase 11)
R2_GRAPH_GAP = 0.004
# 12e: the card's float64 fused fit against the CPU's.  Both run the exact
# Cholesky route and differ in the order of their sums only, but over ten EM
# iterations the H-step's golden search, on an objective that is flat near
# its optimum, turns those ~1e-15 differences into up to 8.5e-6 in omega and
# 4e-6 in mu (measured on the card, the eager fit alike); the fused fit must
# equal the card's eager fit bit for bit, and the CPU's within 1e-4
GRAPH64_RTOL = 1e-4
# runtime API calls that make the host wait for the device (torch.profiler
# names); a device-to-host copy is one of cudaMemcpyAsync + a stream sync
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernelEx")


def _union_s(spans):
    """Seconds covered by the union of (start_ns, end_ns) intervals."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-9


def trace_fit(fn):
    """fn() (one fit) under torch.profiler (CPU and CUDA activities): (fn's
    result, stats).  For the whole call and for the EM loop: the device
    kernels that ran (copies and sets apart), their busy time (the union of
    their intervals), the idle share of the window, the host launch calls
    (kernel launches; cudaGraphLaunch apart) and the host syncs
    (SYNC_CALLS), the set-condition kernels of the IF nodes (count, mean
    us), and the eight kernels that took the most device time in the
    loop.  The loop's window runs from the first E-step annotation to
    the end of the last M- or H-step annotation of an eager fit, and from
    the first cudaGraphLaunch to the first host sync after the last one of
    a fused fit."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(rec)
        elif not (e.is_user_annotation() or rec[2].startswith("vlgp:")):
            dev.append(rec)  # the device-side spans of record_function are no work
    graph = sorted(h for h in host if h[2] == "cudaGraphLaunch")
    syncs = sorted(h for h in host if h[2] in SYNC_CALLS)
    if graph:
        lo = graph[0][0]
        hi = next((h[1] for h in syncs if h[0] >= graph[-1][1]), graph[-1][1])
    else:
        marks = [h for h in host if h[2] in ("vlgp:estep", "vlgp:mstep", "vlgp:hstep")]
        lo = min(h[0] for h in marks)
        hi = max(h[1] for h in marks)

    def stats(lo, hi):
        d = [x for x in dev if lo <= x[0] < hi]
        by_name = collections.Counter()
        for a, b, name in d:
            by_name[name] += b - a
        busy = _union_s([(a, b) for a, b, _ in d])
        conds = [b - a for a, b, name in d if "set_conditional_kernel" in name]
        return dict(device_kernels=sum(not x[2].startswith(("Memcpy", "Memset")) for x in d),
                    # csrc/graph_cond.cu's set-condition kernels: count and
                    # mean device time of one, in microseconds
                    set_condition=(len(conds), round(statistics.fmean(conds) * 1e-3, 3)
                                   if conds else None),
                    busy_s=busy, window_s=(hi - lo) * 1e-9,
                    idle_share=1 - busy / ((hi - lo) * 1e-9),
                    launch_calls=sum(lo <= h[0] < hi and h[2] in LAUNCH_CALLS for h in host),
                    graph_launches=sum(lo <= h[0] < hi for h in graph),
                    host_syncs=sum(lo <= h[0] < hi for h in syncs),
                    top_kernels_ms=[(n[:60], round(t * 1e-6, 2))
                                    for n, t in by_name.most_common(8)])

    first = min(x[0] for x in dev + host)
    last = max(x[1] for x in dev + host)
    whole = stats(first, last + 1)
    whole.pop("top_kernels_ms")
    st = dict(wall_s=wall, fit=whole, em_loop=stats(lo, hi))
    if not graph:
        st["regions"] = split_by_region(prof.profiler.kineto_results.events())
    return out, st


# the EM loop's regions (models/driver.py, models/gp.py); a kernel goes to
# every region whose host span holds the runtime call that launched it
TRACE_REGIONS = ("vlgp:estep", "vlgp:mstep", "vlgp:hstep", "vlgp:hstep_stat",
                 "vlgp:hstep_search")


def split_by_region(events):
    """The device kernels of an eager trace split by TRACE_REGIONS: for each
    region its kernels, their busy time (the union of their intervals) and
    the five kernel classes that took the most device time.  A kernel is
    tied to its launch call by Kineto's correlation id, and the launch call's
    start to the regions' host spans; kernels whose launch call was not
    found are counted apart."""
    import bisect

    spans = {name: [] for name in TRACE_REGIONS}
    launch_at = {}
    kernels = []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not (e.is_user_annotation() or name.startswith(("vlgp:", "Memcpy", "Memset"))):
                kernels.append((e.start_ns(), e.start_ns() + e.duration_ns(), name,
                                e.correlation_id()))
        elif name in spans:
            spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            launch_at[e.correlation_id()] = e.start_ns()
    for v in spans.values():
        v.sort()
    out = {}
    lost = 0
    per = {name: [] for name in TRACE_REGIONS}
    for k in kernels:
        t = launch_at.get(k[3])
        if t is None:
            lost += 1
            continue
        for name, v in spans.items():
            i = bisect.bisect_right(v, (t, float("inf"))) - 1
            if i >= 0 and v[i][0] <= t < v[i][1]:
                per[name].append(k)
    for name, ks in per.items():
        by_name = collections.Counter()
        calls = collections.Counter()
        for a, b, kname, _ in ks:
            by_name[kname] += b - a
            calls[kname] += 1
        out[name] = dict(kernels=len(ks), busy_s=_union_s([(a, b) for a, b, _, _ in ks]),
                         top5=[(n[:60], calls[n], round(t * 1e-6, 2))
                               for n, t in by_name.most_common(5)])
    out["unattributed_kernels"] = lost
    return out


def graph_fit(recorder=None, **fit_kw):
    """One flagship fit with the counters set to 0 just before it and the
    peak memory reset: (result, wall s, R^2, host kernel launches, peak
    bytes)."""
    import vlgp_tpu_torch
    from vlgp_tpu_torch.ops import spd

    trials, a, zt = make_workload()
    reset_all_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    result = vlgp_tpu_torch.fit(trials, ZDIM, a=a, callbacks=[recorder] if recorder else [],
                                **{**FLAGSHIP_KW, **fit_kw})
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    d = result.data
    if tuple(d.mu.shape) != (NTRIAL, LENGTH, ZDIM) or d.mu.device.type != "cuda" or not all(
            torch.isfinite(getattr(d, f)).all() for f in ("mu", "v", "w")):
        raise AssertionError(f"fit {fit_kw}: posterior of shape {tuple(d.mu.shape)} on "
                             f"{d.mu.device}, or not finite")
    r2 = r2_aligned(d.mu.cpu().numpy().reshape(-1, ZDIM), zt)
    return result, wall, r2, dict(spd.KERNEL_LAUNCHES), torch.cuda.max_memory_allocated()


def boundary_gap(seen, ref):
    """(max relative gap of the params over the recorded boundaries, the
    first boundary's): 0.0 where equal bit for bit."""
    gaps = [max(float((x[f] - y[f]).abs().max() / y[f].abs().max().clamp_min(1e-30))
                for f in PARAM_FIELDS) for x, y in zip(seen, ref)]
    return max(gaps), gaps[0]


def run_graph_decisions(card):
    """12a, first part: five EM iterations eagerly and as replays of the
    captured step, each recording the params at every boundary: the
    decision counts of the loop (sweeps, M-step iterations, fallbacks) and
    the params at every boundary compared; the capture time."""
    from vlgp_tpu_torch.models import driver

    driver._GRAPH_CACHE.clear()
    seen_e, rec_e = param_recorder()
    eager, wall_e, r2_e, launch_e, mem_e = graph_fit(rec_e, max_iter=5)
    seen_f, rec_f = param_recorder()
    fused, wall_f, r2_f, launch_f, mem_f = graph_fit(rec_f, max_iter=5, fused=True)
    ce, cf = eager.runtime["counts"], fused.runtime["counts"]
    gap, gap1 = boundary_gap(seen_f, seen_e)
    log(f"12a decisions, 5 EM iterations [{card}]: eager (host counters) {ce}")
    log(f"12a decisions, 5 EM iterations [{card}]: fused (device counters of the replays) {cf}")
    log(f"12a: the host counters of the fused fit count each capture, not each replay: "
        f"KERNEL_LAUNCHES {launch_f} holds the kernels the two captures recorded (and the "
        f"eager set-up, final H-step and inference), against {launch_e} for the eager fit")
    log(f"12a: capture of the step's two cadence graphs (warm-up of every branch included) "
        f"{fused.runtime['capture_s']:.2f} s, outside em_elapsed; fit wall {wall_f:.2f} s "
        f"against {wall_e:.2f} s eager")
    log(f"12a: params at the {len(seen_f)} boundaries: max relative gap {gap:.3e} "
        f"(after iteration 1: {gap1:.3e}); R^2 {r2_f:.4f} vs {r2_e:.4f}")
    if ce != cf:
        raise AssertionError(f"12a: decision counts differ: eager {ce}, fused {cf}")
    if len(seen_f) != len(seen_e) or fused.runtime["it"] != eager.runtime["it"]:
        raise AssertionError("12a: the fused fit ran another number of iterations")


def run_graph_fits(card, r2_eager, walls_eager):
    """12a (second part) and 12b: the 30-iteration flagship fit with
    fused=True, block=5 and block=7, each replay run under
    torch.cuda.set_sync_debug_mode("error") (the norms reads excepted),
    R^2 within R2_GRAPH_GAP of the eager fit's, the host reads counted.
    Returns the EM loop seconds of each fit, by tag ("eager" first)."""
    from vlgp_tpu_torch.models import driver

    reads = [0]
    norms = driver._GraphSteps.norms

    def counted(self):
        reads[0] += 1
        return norms(self)

    res, wall, r2, launches, mem = graph_fit()
    em_loops = {"eager": sum(res.runtime["em_elapsed"])}
    log(f"12a eager default fit [{card}]: {wall:.2f} s wall, EM loop "
        f"{sum(res.runtime['em_elapsed']):.3f} s (E {sum(res.runtime['e_elapsed']):.3f}, M "
        f"{sum(res.runtime['m_elapsed']):.3f}, H {sum(res.runtime['h_elapsed']):.3f}), peak "
        f"memory {mem / 2**20:.0f} MiB, R^2 {r2:.4f}; ns_gram launches {launches['ns_gram']} "
        f"({launches['ns_gram_stream']} on the streaming path)")
    if launches["ns_gram_stream"] == 0:
        raise AssertionError("12a: the eager fit never took ns_gram's streaming path")
    driver._GraphSteps.norms = counted
    driver.CHECK_REPLAY_SYNCS = True
    out = {}
    try:
        for tag, kw in (("12a fused", dict(fused=True)), ("12b block=5", dict(block=5)),
                        ("12b block=7", dict(block=7))):
            reads[0] = 0
            res, wall, r2, launches, mem = graph_fit(**kw)
            rt = res.runtime
            em = sum(rt["em_elapsed"])
            log(f"{tag} [{card}]: {wall:.2f} s wall (eager default fit "
                f"{walls_eager[0]:.2f} / {walls_eager[1]:.2f} s in phase 8), EM loop {em:.3f} s "
                f"({1e3 * em / rt['it']:.1f} ms per iteration), capture {rt.get('capture_s', 0):.2f} "
                f"s, {rt['it']} iterations (converged_at {rt.get('converged_at')}), "
                f"{reads[0]} host reads of the norms, peak memory {mem / 2**20:.0f} MiB, "
                f"R^2 {r2:.4f} vs {r2_eager:.4f}; counts {rt['counts']}")
            if (launches["estep_project"] == 0 or launches["estep_step"] == 0
                    or launches["ns_gram_stream"] == 0):
                raise AssertionError(f"{tag}: the E-step's kernels (estep_project, estep_step, "
                                     f"ns_gram's streaming path) were not launched: {launches}")
            k = kw.get("block", 1)
            if reads[0] != -(-rt["it"] // k):
                raise AssertionError(f"{tag}: {reads[0]} norms reads for {rt['it']} iterations")
            if abs(r2 - r2_eager) > R2_GRAPH_GAP or r2 < R2_MIN:
                raise AssertionError(f"{tag}: R^2 {r2:.4f} against the eager fit's {r2_eager:.4f}")
            out[tag] = res
            em_loops[tag] = em
    finally:
        driver._GraphSteps.norms = norms
        driver.CHECK_REPLAY_SYNCS = False
    ca = [r.runtime.get("converged_at") for r in out.values()]
    if len(set(ca)) != 1:
        raise AssertionError(f"12b: converged_at differs between the drivers: {ca}")
    return em_loops


def run_graph_fused_sweep(card, r2_fused_sweep):
    """12c: fit(fused=True) with the fused E-step sweep: its cooperative
    launch replayed inside the captured step."""
    from vlgp_tpu_torch.models import vlgp as tv

    tv._SWEEP_FUSED = True
    try:
        res, wall, r2, launches, mem = graph_fit(fused=True)
    finally:
        tv._SWEEP_FUSED = False
    rt = res.runtime
    log(f"12c fused=True with the fused sweep [{card}]: {wall:.2f} s wall, EM loop "
        f"{sum(rt['em_elapsed']):.3f} s, capture {rt['capture_s']:.2f} s, R^2 {r2:.4f} "
        f"(phase 8 fused sweep, eager: {r2_fused_sweep:.4f}); counts {rt['counts']}; "
        f"host-counted sweep launches {launches['sweep']} (captures)")
    if launches["sweep"] == 0:
        raise AssertionError("12c: no sweep launch was captured")
    if abs(r2 - r2_fused_sweep) > R2_GRAPH_GAP or r2 < R2_MIN:
        raise AssertionError(f"12c: R^2 {r2:.4f} against {r2_fused_sweep:.4f}")


def run_graph_fallback(card, device, gen):
    """12d: inv_one_plus_gram captured with a warm start, replayed from a
    good carry and from a NaN one: the NaN carry makes the IF bodies run
    the probe's reject, the refine (NaN) and the cold restart on the card;
    each replay equal bit for bit to the eager call and its device counters
    equal to the eager call's host fallbacks."""
    from vlgp_tpu_torch.ops import control, spd

    G = realistic_factor(ZDIM, 50, 40, device)
    w = torch.rand((ZDIM, 2000, 50), generator=gen, device=device) * 2.0
    X0 = spd.inv_one_plus_gram(G, w, iters=16)
    warm = X0.clone()
    cap = control.Capturer(device)

    def f():
        return spd.inv_one_plus_gram(G, w, iters=16, warm=warm, warm_iters=4, want_v=True)

    cap.warmup(f)
    graph, out = cap.capture(f)
    for case, carry in (("good carry", X0), ("NaN carry", torch.full_like(X0, float("nan")))):
        warm.copy_(carry)
        cap.reset_counts()
        graph.replay()
        got = cap.read_counts()
        spd.reset_counters()
        X, v = f()
        host = {k: n for k, n in spd.FALLBACKS.items() if n}
        dev = {k: n for k, n in got.items() if n and k in spd.FALLBACKS}
        same = torch.equal(out[0], X) and torch.equal(out[1], v)
        log(f"12d {case} [{card}]: replay equal to the eager call bit for bit: {same}; "
            f"device fallbacks {dev}, eager host fallbacks {host}")
        if not same or dev != host:
            raise AssertionError(f"12d {case}: the captured net differs from the eager one")
        if case == "NaN carry" and set(host) != {"gram_probe_reject", "gram_refine_fail"}:
            raise AssertionError(f"12d: a NaN carry took {host}, not reject -> refine -> cold")
    cap.close()


def run_graph_float64(card):
    """12e: a small float64 fit(fused=True) on the card against the CPU's
    float64 fused fit (the same 4 x 120 x 10 x 2 input as phase 7)."""
    import vlgp_tpu_torch

    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 10)) * 0.5
    trials = []
    for _ in range(4):
        z = np.column_stack((np.sin(np.linspace(0, 6, 120)), np.cos(np.linspace(0, 6, 120))))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.5)).astype(float),
                       "mu": rng.normal(size=(120, 2)) * 0.1})
    kw = dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), max_iter=10, dtype="float64")
    gpu = vlgp_tpu_torch.fit(trials, 2, device="cuda", fused=True, **kw)
    eager = vlgp_tpu_torch.fit(trials, 2, device="cuda", **kw)
    cpu = vlgp_tpu_torch.fit(trials, 2, device="cpu", fused=True, **kw)

    def gaps(x, ref):
        rel = {f: float((getattr(x.params, f).cpu() - getattr(ref.params, f).cpu()).abs().max()
                        / getattr(ref.params, f).abs().max()) for f in ("a", "b", "omega", "sigma")}
        rel["mu"] = float((x.data.mu.cpu() - ref.data.mu.cpu()).abs().max()
                          / ref.data.mu.abs().max())
        return rel

    vs_eager, vs_cpu, eager_cpu = gaps(gpu, eager), gaps(gpu, cpu), gaps(eager, cpu)
    log(f"12e float64 fit(fused=True) on the card [{card}]: against the card's eager fit "
        f"{vs_eager}; against the CPU's fused fit {vs_cpu} (the card's eager fit against the "
        f"CPU: {eager_cpu}); counts card {gpu.runtime['counts']} / CPU {cpu.runtime['counts']}")
    if max(vs_eager.values()) > 0 or gpu.runtime["counts"] != cpu.runtime["counts"]:
        raise AssertionError("12e: the card's float64 fused fit differs from its eager fit")
    if max(vs_cpu.values()) > GRAPH64_RTOL:
        raise AssertionError("12e: the card's float64 fused fit disagrees with the CPU's")


def run_graph_sharded(card):
    """12f: fit_sharded(block=3) over an nccl group of one rank against
    fit_sharded(block=1), the params at the block boundaries compared; then
    fit_sharded(block=2) over a gloo group on CUDA tensors, which must raise
    a ValueError naming nccl."""
    import datetime

    import torch.distributed as tdist

    from vlgp_tpu_torch.parallel.driver import fit_sharded

    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                             world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        seen1, rec1 = param_recorder()
        ref, wall1, _, _, r2_1 = sharded_fit(rec1)
        seen3, rec3 = param_recorder()
        got, wall3, launches, coll, r2_3 = sharded_fit(rec3, block=3)
    finally:
        tdist.destroy_process_group()
    gap, gap1 = boundary_gap(seen3, seen1[2::3])
    log(f"12f fit_sharded, nccl world 1 [{card}]: block=1 {wall1:.2f} s, R^2 {r2_1:.4f}; "
        f"block=3 {wall3:.2f} s, R^2 {r2_3:.4f}, {got.runtime['it']} iterations "
        f"(converged_at {got.runtime.get('converged_at')}), capture and replays; params at "
        f"{len(seen3)} block boundaries: max relative gap {gap:.3e} (first {gap1:.3e})")
    if abs(r2_3 - r2_1) > R2_GRAPH_GAP or len(seen3) != -(-got.runtime["it"] // 3):
        raise AssertionError("12f: fit_sharded(block=3) disagrees with block=1")
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                             world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        trials, a, _ = make_workload(ntrial=4)
        try:
            fit_sharded(trials, ZDIM, a=a, device="cuda", block=2, **FLAGSHIP_KW)
        except ValueError as e:
            if "nccl" not in str(e):
                raise
            log(f"12f fit_sharded(block=2) on a gloo group with CUDA tensors raised: {e}")
        else:
            raise AssertionError("12f: fit_sharded(block=2) on gloo with CUDA tensors ran")
    finally:
        tdist.destroy_process_group()


def run_graph_svd(card, fro_em):
    """12g: the flagship fit with constrain_loading="svd" eagerly, then with
    fused=True and with block=5 (each replay under
    torch.cuda.set_sync_debug_mode("error")): the params equal the eager
    fit's bit for bit at every boundary, the replays' device decision
    counts equal the eager fit's host counts, R^2 >= R2_MIN, one
    svd_loading launch per eager EM iteration, the EM loops beside the
    "fro" fits' of 12a and 12b; then fit_sharded(block=3) against block=1
    over an nccl group of one rank, bit for bit at the block boundaries.
    Returns the eager fit's svd_loading launches."""
    import datetime

    import torch.distributed as tdist

    from vlgp_tpu_torch.models import driver

    svd = dict(constrain_loading="svd")
    seen_e, rec_e = param_recorder()
    eager, wall_e, r2_e, launch_e, _ = graph_fit(rec_e, **svd)
    em_e = sum(eager.runtime["em_elapsed"])
    log(f"12g eager svd fit [{card}]: {wall_e:.2f} s wall, EM loop {em_e:.3f} s (the 'fro' "
        f"eager fit of 12a: {fro_em['eager']:.3f} s), R^2 {r2_e:.4f}, svd_loading launches "
        f"{launch_e['svd_loading']}, counts {eager.runtime['counts']}")
    if launch_e["svd_loading"] != eager.runtime["it"] or r2_e < R2_MIN:
        raise AssertionError(f"12g: the eager svd fit made {launch_e['svd_loading']} "
                             f"svd_loading launches in {eager.runtime['it']} iterations, R^2 "
                             f"{r2_e:.4f}")
    driver.CHECK_REPLAY_SYNCS = True
    try:
        for tag, kw, fro_tag in (("fused=True", dict(fused=True), "12a fused"),
                                 ("block=5", dict(block=5), "12b block=5")):
            seen, rec = param_recorder()
            res, wall, r2, launches, _ = graph_fit(rec, **svd, **kw)
            k = kw.get("block", 1)
            diff = same_boundaries(seen, seen_e[k - 1::k])
            em = sum(res.runtime["em_elapsed"])
            log(f"12g {tag} svd fit [{card}]: {wall:.2f} s wall, EM loop {em:.3f} s (the 'fro' "
                f"fit: {fro_em[fro_tag]:.3f} s), capture {res.runtime['capture_s']:.2f} s, R^2 "
                f"{r2:.4f}; params equal to the eager fit's bit for bit at all {len(seen)} "
                f"boundaries: {not diff}; counts equal: "
                f"{res.runtime['counts'] == eager.runtime['counts']}; svd_loading launches "
                f"{launches['svd_loading']} (captures)")
            if diff or res.runtime["counts"] != eager.runtime["counts"]:
                raise AssertionError(f"12g {tag}: params differ at boundaries {diff}, or counts "
                                     f"{res.runtime['counts']}")
            if r2 < R2_MIN or launches["svd_loading"] == 0:
                raise AssertionError(f"12g {tag}: R^2 {r2:.4f}, or no svd_loading captured")
    finally:
        driver.CHECK_REPLAY_SYNCS = False
    tdist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                             world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        seen1, rec1 = param_recorder()
        _, wall1, _, _, r2_1 = sharded_fit(rec1, **svd)
        seen3, rec3 = param_recorder()
        _, wall3, launches, _, r2_3 = sharded_fit(rec3, block=3, **svd)
    finally:
        tdist.destroy_process_group()
    diff = same_boundaries(seen3, seen1[2::3])
    log(f"12g fit_sharded svd, nccl world 1 [{card}]: block=1 {wall1:.2f} s, R^2 {r2_1:.4f}; "
        f"block=3 {wall3:.2f} s, R^2 {r2_3:.4f}; params equal bit for bit at all "
        f"{len(seen3)} block boundaries: {not diff}")
    if diff or launches["svd_loading"] == 0:
        raise AssertionError(f"12g: fit_sharded(block=3) differs from block=1 at {diff}")
    return launch_e["svd_loading"]


def run_graph_traces(card):
    """12, the trace: one eager and one fused flagship fit under
    torch.profiler, each after an untraced fit with the same settings (so
    the fused fit's graphs are captured and cached before the trace)."""
    for tag, kw in (("eager", {}), ("fused", dict(fused=True))):
        graph_fit(**kw)
        res, st = trace_fit(lambda: graph_fit(**kw))
        st["em_elapsed_s"] = sum(res[0].runtime["em_elapsed"])
        log(f"12 trace, {tag} fit [{card}]: {json.dumps(st)}")


def run_window_none(card):
    """13: the flagship workload with window=None (whole 1000-bin trials,
    so the H-step searches on the wide path), 30 EM iterations, eagerly and
    with fused=True, each with the counters set to 0 just before it and
    the params recorded at every EM iteration boundary; the eager fit's
    hstep_search calls each between a pair of CUDA events.  Logs wall, EM
    loop, the H-step's share, the searches' device time, capture time, R^2,
    launches and peak memory; the fused fit's decision counts and params
    must equal the eager fit's bit for bit.  Returns (the eager fit's
    hstep_search launches, their summed ms)."""
    from vlgp_tpu_torch.models import gp

    real = gp.hstep_search
    events = []

    def timed(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **k)
        end.record()
        events.append((start, end))
        return out

    seen_e, rec_e = param_recorder()
    gp.hstep_search = timed
    try:
        eager, wall_e, r2_e, launch_e, mem_e = graph_fit(rec_e, window=None)
    finally:
        gp.hstep_search = real
    search_ms = sum(a.elapsed_time(b) for a, b in events)
    seen_f, rec_f = param_recorder()
    fused, wall_f, r2_f, launch_f, mem_f = graph_fit(rec_f, window=None, fused=True)
    for tag, res, wall, r2, launches, mem in (("eager", eager, wall_e, r2_e, launch_e, mem_e),
                                              ("fused", fused, wall_f, r2_f, launch_f, mem_f)):
        rt = res.runtime
        em, h = sum(rt["em_elapsed"]), sum(rt["h_elapsed"])
        log(f"13 window=None fit, {tag} [{card}]: {wall:.2f} s wall, EM loop {em:.3f} s "
            f"(H-step {h:.3f} s, {h / max(em, 1e-9):.0%}), capture {rt.get('capture_s', 0):.2f} s, "
            f"{rt['it']} iterations (converged_at {rt.get('converged_at')}), peak memory "
            f"{mem / 2**20:.0f} MiB, R^2 {r2:.4f}; counts {rt['counts']}; launches {launches}")
    log(f"13 window=None eager fit: {len(events)} hstep_search calls, {search_ms:.1f} ms of "
        f"device time in all ({search_ms / max(len(events), 1):.2f} ms a search)")
    if launch_e["hstep_search"] == 0 or len(events) != launch_e["hstep_search"]:
        raise AssertionError(f"13: the eager window=None fit launched hstep_search "
                             f"{launch_e['hstep_search']} times in {len(events)} calls")
    if eager.runtime["counts"] != fused.runtime["counts"]:
        raise AssertionError(f"13: decision counts differ: eager {eager.runtime['counts']}, "
                             f"fused {fused.runtime['counts']}")
    differ = same_boundaries(seen_f, seen_e)
    if differ or fused.runtime["it"] != eager.runtime["it"]:
        raise AssertionError(f"13: the fused fit's params differ from the eager fit's at "
                             f"boundaries {differ[:5]} ({len(seen_f)} against {len(seen_e)})")
    log(f"13: the fused fit's decision counts and params at all {len(seen_e)} boundaries equal "
        f"the eager fit's bit for bit")
    return launch_e["hstep_search"], search_ms


def run_phase12(card, device, gen, r2_eager, walls_eager, r2_fused_sweep):
    """Phase 12, each sub-phase with its counters set to 0 just before.
    Returns 12g's svd_loading launches."""
    run_graph_decisions(card)
    fro_em = run_graph_fits(card, r2_eager, walls_eager)
    run_graph_fused_sweep(card, r2_fused_sweep)
    run_graph_fallback(card, device, gen)
    run_graph_float64(card)
    run_graph_sharded(card)
    n_svd = run_graph_svd(card, fro_em)
    run_graph_traces(card)
    return n_svd


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    # plain versions multiply in full float32 (no TF32), like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vlgp_tpu_torch.ops import _build

    tic = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - tic:.1f} s (nvcc {_build.BUILD_SECONDS:.1f} s, "
        f"{len(_build.SOURCES)} sources in parallel)")

    device = torch.device("cuda")
    gen = torch.Generator(device=device)

    def seeded():
        """The generator at seed 0: each phase draws its inputs from the same
        state, whatever the phases before it drew (the sweep's time follows
        its slowest exit group, so its inputs must not move with them)."""
        return gen.manual_seed(0)

    Z, S, T, R = ZDIM, 2000, 50, 40
    g_err_a, g_rows = check_ns_gram(Z, S, T, R, device, seeded())
    log(f"ns_gram's per_matrix design at Z={Z} S={S} T={T} R={R}, the streaming path against "
        f"the block path, graph replays in turns [{card}]:")
    g_paths, g_err_p = check_ns_gram_paths(device, seeded(), (Z, S, T, R))
    g_err_b, _ = check_ns_gram(ZDIM, 100, 1000, 50, device, seeded())
    B, RP = ZDIM * NTRIAL, 50
    p_err, p_rows, p_lms = check_ns_packed(B, RP, device, seeded())
    p_err_elbo, _, _ = check_ns_packed(10000, 40, device, seeded(), T=50)  # elbo_terms
    # a chunk of leave_one_neuron_out at its default batch (9c): 25 x 100 trials
    lono_S = max(LONO_BATCHES) * NTRIAL
    log(f"ns_gram and ns_packed at a leave_one_neuron_out chunk's shapes [{card}]:")
    g_err_l, g_rows_l = check_ns_gram(ZDIM, lono_S, LENGTH, 50, device, seeded())
    p_err_l, p_rows_l, p_lms_l = check_ns_packed(ZDIM * lono_S, RP, device, seeded())
    e_err = check_edge_shapes(device, seeded())
    c_err = check_ns_gram_crossover(device, seeded())
    check_ns_gram_invariance(device, seeded())
    check_ns_gram_pairs_capture(device, seeded())
    log(f"ns_gram's long-T design: the streaming GEMM against the tiled GEMMs [{card}]:")
    pairs_rows = check_ns_gram_pairs_paths(device, seeded())
    sw_err, sw_ms, sw_pms, sw_bms, sw_by = check_sweep(device, seeded())
    si_err, si_ms, si_pms, si_lms, si_bms, si_by = check_spd_inverse(device, seeded())
    ps_err, ps_ms, ps_pms, ps_lms, ps_bms, ps_by = check_probe_skip(device, seeded())
    sv_err, sv_ms, sv_pms, sv_lms, sv_bms, sv_by = check_svd_loading(device, seeded())
    lz_err, lz_ms, lz_pms, lz_bms, lz_by = check_lorenz(device)

    check_small_fit_against_cpu()
    # the main paths, in turns: default, fused, fused, default
    fits = [run_fit(fused) for fused in (False, True, True)]
    fits.append(run_fit_split(False)[0])
    default, fused = fits[0], fits[1]
    gap = max(abs(f[5] - d[5]) for f in fits[1:3] for d in (fits[0], fits[3]))
    log(f"fits: default {fits[0][3]:.2f} / {fits[3][3]:.2f} s wall, E-step "
        f"{fits[0][4]:.3f} / {fits[3][4]:.3f} s, R^2 {fits[0][5]:.4f}; fused sweep "
        f"{fits[1][3]:.2f} / {fits[2][3]:.2f} s wall, E-step {fits[1][4]:.3f} / "
        f"{fits[2][4]:.3f} s, R^2 {fits[1][5]:.4f} / {fits[2][5]:.4f}; "
        f"sweep launches {fused[0]['sweep']}, route calls {fused[1]['sweep']}, "
        f"sweep_core {fused[2]['sweep_core']}")
    if gap > R2_FUSED_GAP:
        raise AssertionError(f"fused-sweep fit R^2 differs from the default fit's by {gap:.4f}")
    # 6c, the M-step's and the H-step's kernels on the last default fit's
    # state (so they come after phase 8)
    tic = time.perf_counter()
    log(f"6c mstep_stats / mstep_update against their plain versions [{card}]:")
    ms_out = check_mstep(device, seeded(), fits[3][6])
    log(f"6c hstep_search against its plain version [{card}]:")
    hs_out = check_hstep(device, seeded(), fits[3][6])
    log(f"6c: {time.perf_counter() - tic:.1f} s")
    # 6d, the H-step's statistic on the same state
    tic = time.perf_counter()
    log(f"6d hstep_stat against its plain version [{card}]:")
    st_out = check_hstep_stat(device, seeded(), fits[3][6])
    log(f"6d: {time.perf_counter() - tic:.1f} s")
    # 6e, the E-step's per-sweep chain on the same state
    tic = time.perf_counter()
    log(f"6e estep_project / estep_step against their plain versions [{card}]:")
    es_out = check_estep(device, seeded(), fits[3][6])
    el_err, _, _ = check_estep_long(device, seeded())
    em_out = check_estep_members(device, seeded())
    es_out["err"] = max(es_out["err"], el_err)
    log(f"6e: {time.perf_counter() - tic:.1f} s")
    tr_launches = run_transform(fits[3][6])[0]
    n_solve = run_spd_solve(device, seeded())
    n_probe = run_fused_probe(device, seeded())

    # 9, the model-selection path, each sub-phase with its own counters
    result_elbo = run_fit_elbo((fits[0][3], fits[3][3]))[2]
    check_elbo_card_vs_cpu(result_elbo)
    lono = run_leave_one_neuron_out(fits[3][6], card)
    run_sample_posterior(fits[3][6], device)
    run_gpfa_warm_start_and_cv(device)
    n_lorenz = run_lorenz(device)[3]

    # 10, save / load, the checkpointed fit and the command line, each
    # sub-phase with its own counters; files in a directory of the checkout
    with tempfile.TemporaryDirectory(prefix=".smoke10_", dir=ROOT) as tmp:
        work = pathlib.Path(tmp)
        run_save_load(fits[3][6], work, card)
        run_checkpointed_fit(work, (fits[0][3], fits[3][3]), card)
        run_cli(work, card)

    # 11, the sharded fit, each sub-phase with its own counters
    r2_world1 = run_sharded_world1(card)
    run_sharded_gloo(card, r2_world1)
    run_sharded_gloo(card, r2_world1, "11c", (1, 2))
    run_sharded_gloo(card, r2_world1, "11d", (1, 2), ydim=YDIM - 1)

    # 12, the fused and scanned EM drivers as CUDA graphs
    n_svd = run_phase12(card, device, seeded(), fits[0][5], (fits[0][3], fits[3][3]),
                        fits[1][5])
    # 13, window=None: whole trials, the H-step's search on the wide path
    wn_launches, _ = run_window_none(card)

    p_cold = next(r for r in p_rows if r[0] == "cold")
    p_bms, p_by = bound(B * 33 * RP ** 3, 4 * (2 * B * RP * RP + B))
    from vlgp_tpu_torch.ops.spd import _ns_gram_design

    # ns_gram at the segments: every call of its kernels (launches), the
    # per_matrix design's block path timed; then the streaming path, which
    # the fit takes there, in the E-step's three modes (graph replays)
    t_block, _, t_plain, g_bms, g_by = g_paths["cold 16"]
    kernels = [
        {"name": f"ns_gram (every call; the {_ns_gram_design(T, R)} design's block path timed, "
                 f"cold 16, Z{Z} S{S} T{T} R{R})",
         "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
         "replaces": "vlgp_tpu/ops/spd.py:796", "launches": default[0]["ns_gram"],
         "max_abs_err": max(g_err_a, g_err_b, e_err, c_err), "ms": t_block[0][0],
         "plain_ms": t_plain[0], "bound_ms": g_bms, "bound_by": g_by, "library_ms": None}]
    for mode in ("probe+v", "warm 4+v", "cold 16"):
        _, t_stream, t_plain, g_bms, g_by = g_paths[mode]
        kernels.append(
            {"name": f"ns_gram ({_ns_gram_design(T, R)} design, streaming path, {mode}, "
                     f"Z{Z} S{S} T{T} R{R})",
             "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
             "replaces": "vlgp_tpu/ops/spd.py:796", "launches": default[0]["ns_gram_stream"],
             "max_abs_err": g_err_p, "ms": t_stream[0][0], "plain_ms": t_plain[0],
             "bound_ms": g_bms, "bound_by": g_by, "library_ms": None})
    kernels += [
        {"name": "ns_packed", "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
         "replaces": "vlgp_tpu/ops/spd.py:558", "launches": default[0]["ns_packed"],
         "max_abs_err": max(p_err, p_err_elbo, e_err), "ms": p_cold[3][0],
         "plain_ms": p_cold[4][0],
         "bound_ms": p_bms, "bound_by": p_by, "library_ms": p_lms[0]},
        {"name": "sweep", "route": "cuda", "source": "vlgp_tpu_torch/csrc/sweep.cu",
         "replaces": "vlgp_tpu/ops/sweep.py:368", "launches": fused[0]["sweep"],
         "max_abs_err": sw_err, "ms": sw_ms[0], "plain_ms": sw_pms[0],
         "bound_ms": sw_bms, "bound_by": sw_by, "library_ms": None},
        {"name": "spd_inverse", "route": "cuda", "source": "vlgp_tpu_torch/csrc/spd_inverse.cu",
         "replaces": "vlgp_tpu/ops/spd.py:123", "launches": n_solve,
         "max_abs_err": si_err, "ms": si_ms[0], "plain_ms": si_pms[0],
         "bound_ms": si_bms, "bound_by": si_by, "library_ms": si_lms[0]},
        {"name": "probe_skip", "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
         "replaces": "vlgp_tpu/ops/spd.py:558", "launches": n_probe,
         "max_abs_err": ps_err, "ms": ps_ms[0], "plain_ms": ps_pms[0],
         "bound_ms": ps_bms, "bound_by": ps_by, "library_ms": ps_lms[0]},
        {"name": "svd_loading", "route": "cuda", "source": "vlgp_tpu_torch/csrc/svd_loading.cu",
         "replaces": "vlgp_tpu/models/vlgp.py:512", "launches": n_svd,
         "max_abs_err": sv_err, "ms": sv_ms[0], "plain_ms": sv_pms[0],
         "bound_ms": sv_bms, "bound_by": sv_by, "library_ms": sv_lms[0]},
        {"name": "lorenz", "route": "cuda", "source": "vlgp_tpu_torch/csrc/lorenz.cu",
         "replaces": "vlgp_tpu/simulation.py:107", "launches": n_lorenz,
         "max_abs_err": lz_err, "ms": lz_ms[0], "plain_ms": lz_pms,
         "bound_ms": lz_bms, "bound_by": lz_by, "library_ms": None},
    ]
    # the M-step's and H-step's kernels (6c): launches of phase 8's first
    # default fit; max_abs_err is the largest gap relative to each tensor's
    # largest |value| (mstep) and the largest objective gap (hstep_search)
    m_err, s_ms, s_pms, s_bms, s_by, u_ms, u_pms, u_bms, u_by = ms_out
    h_err, h_ms, h_pms, h_bms, h_by, h_plan, h_rows = hs_out
    wide = h_rows[LENGTH]
    kernels += [
        {"name": f"mstep_stats (Z{ZDIM} S2000 T50 Y{YDIM} X1, partial sums)", "route": "cuda",
         "source": "vlgp_tpu_torch/csrc/mstep.cu", "replaces": "vlgp_tpu/models/vlgp.py:374",
         "launches": default[0]["mstep_stats"], "max_abs_err": m_err, "ms": s_ms[0],
         "plain_ms": s_pms[0], "bound_ms": s_bms, "bound_by": s_by, "library_ms": None},
        {"name": f"mstep_update (Z{ZDIM} Y{YDIM} X1, prologue reduces the partials)",
         "route": "cuda", "source": "vlgp_tpu_torch/csrc/mstep.cu",
         "replaces": "vlgp_tpu/models/vlgp.py:374", "launches": default[0]["mstep_update"],
         "max_abs_err": m_err, "ms": u_ms[0], "plain_ms": u_pms[0], "bound_ms": u_bms,
         "bound_by": u_by, "library_ms": None},
        {"name": f"hstep_search (Z{ZDIM} T50, clusters of {h_plan['nb']}, {h_plan['rounds']} "
                 f"rounds)", "route": "cuda",
         "source": "vlgp_tpu_torch/csrc/hstep.cu", "replaces": "vlgp_tpu/models/gp.py:255",
         "launches": default[0]["hstep_search"], "max_abs_err": h_err, "ms": h_ms[0],
         "plain_ms": h_pms[0], "bound_ms": h_bms, "bound_by": h_by, "library_ms": None},
        {"name": f"hstep_search (wide path, Z{ZDIM} T{LENGTH} window=None, clusters of "
                 f"{wide['plan']['nb']}, {wide['plan']['per']} blocks an evaluation, "
                 f"{wide['plan']['rounds']} rounds)", "route": "cuda",
         "source": "vlgp_tpu_torch/csrc/hstep.cu", "replaces": "vlgp_tpu/models/gp.py:255",
         "launches": wn_launches, "max_abs_err": h_err, "ms": wide["ms"][0],
         "plain_ms": wide["plain_ms"][0], "bound_ms": wide["bound_ms"],
         "bound_by": wide["bound_by"], "library_ms": wide["library_ms"][0]},
    ]
    # the H-step's statistic (6d): launches of phase 8's first default fit;
    # max_abs_err is the largest gap relative to each sum's largest |entry|
    st_err, _, st_ms, st_pms, st_bms, st_by, _ = st_out
    kernels.append(
        {"name": f"hstep_stat (Z{ZDIM} S2000 T50 R40, the pass and its reduction)",
         "route": "cuda", "source": "vlgp_tpu_torch/csrc/hstep_stat.cu",
         "replaces": "vlgp_tpu/models/gp.py:435", "launches": default[0]["hstep_stat"],
         "max_abs_err": st_err, "ms": st_ms[0], "plain_ms": st_pms[0], "bound_ms": st_bms,
         "bound_by": st_by, "library_ms": None})
    # the E-step's per-sweep chain (6e): launches of phase 8's first default
    # fit at the segments' shape, of transform's inference at T1000;
    # max_abs_err is the largest gap on 6e's scales
    for key, shape, launched in (
            ("flagship", f"Z{ZDIM} S2000 T50 Y{YDIM} R40", default[0]),
            ("final", f"Z{ZDIM} S{NTRIAL} T{LENGTH} Y{YDIM} R50, transform's inference",
             tr_launches)):
        for name, source_line, path, (ms, pms, b_ms, b_by) in zip(
                ("estep_project", "estep_step"), ("202", "206"), es_out[key + " paths"],
                es_out[key]):
            kernels.append(
                {"name": f"{name} ({path} path, {shape})", "route": "cuda",
                 "source": "vlgp_tpu_torch/csrc/estep.cu",
                 "replaces": f"vlgp_tpu/models/vlgp.py:{source_line}",
                 "launches": launched[name], "max_abs_err": es_out["err"], "ms": ms[0],
                 "plain_ms": pms[0], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    # the kernels at the shapes of a leave_one_neuron_out chunk, launches of
    # 9c's run at the default batch
    lono_launches = lono[max(LONO_BATCHES)][0]
    (kp, pl_p, bp, bp_by), (ks, pl_s, bs, bs_by), (pp, sp) = em_out["chunk"]
    for name, source_line, path, ms, pms, b_ms, b_by in (
            ("estep_project", "202", pp, kp, pl_p, bp, bp_by),
            ("estep_step", "206", sp, ks, pl_s, bs, bs_by)):
        kernels.append(
            {"name": f"{name} ({path} path, 9c chunk: B{ESTEP_MEMBER_CASES[0][6]} members on "
                     f"Z{ZDIM} S{NTRIAL} T{LENGTH} Y{YDIM} R50)", "route": "cuda",
             "source": "vlgp_tpu_torch/csrc/estep.cu",
             "replaces": f"vlgp_tpu/models/vlgp.py:{source_line}",
             "launches": lono_launches[name], "max_abs_err": em_out["err"], "ms": ms[0],
             "plain_ms": pms[0], "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for mode in ("warm+v", "probe+v"):
        row = next(r for r in g_rows_l if r[0] == mode)
        b_ms, b_by = ns_gram_bound(ZDIM, lono_S, LENGTH, 50, mode)
        kernels.append(
            {"name": f"ns_gram ({_ns_gram_design(LENGTH, 50)} design, 9c chunk, {mode}, "
                     f"Z{ZDIM} S{lono_S} T{LENGTH} R50)",
             "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
             "replaces": "vlgp_tpu/ops/spd.py:796", "launches": lono_launches["ns_gram"],
             "max_abs_err": g_err_l, "ms": row[3][0], "plain_ms": row[4][0],
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    # the long-T design's two GEMMs on the streaming GEMM (phase 4), launches
    # of 9c's run at the default batch (the chunk: pairs_plan streams both;
    # at S100 it keeps the tiled kernels, so the S100 times stand in the log)
    for (tag, launched, where) in ((f"Z{ZDIM} S{lono_S} T{LENGTH} R50", lono_launches,
                                    "9c chunk"),):
        for name, what in (("gram", "Gram"), ("v", "v")):
            r = pairs_rows[tag][name]
            g = r["gemm"]
            kernels.append(
                {"name": f"ns_gram_pairs {what} GEMM (streaming GEMM, {g.bm}x{g.bn} tiles, "
                         f"{g.grid} blocks, {g.stages} stages, {where}, {tag}; tiled path "
                         f"{r['tiled_ms']:.4f} ms in turns)",
                 "route": "cuda", "source": "vlgp_tpu_torch/csrc/ns_inverse.cu",
                 "replaces": "vlgp_tpu/ops/spd.py:796", "launches": launched["ns_gram_pairs_stream"],
                 "max_abs_err": g_err_l, "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"]})
    row = next(r for r in p_rows_l if r[0] == "cold")
    BL = ZDIM * lono_S
    b_ms, b_by = bound(BL * 33 * RP ** 3, 4 * (2 * BL * RP * RP + BL))
    kernels.append(
        {"name": f"ns_packed (9c chunk, cold, B{BL} R{RP})", "route": "cuda",
         "source": "vlgp_tpu_torch/csrc/ns_inverse.cu", "replaces": "vlgp_tpu/ops/spd.py:558",
         "launches": lono_launches["ns_packed"], "max_abs_err": p_err_l, "ms": row[3][0],
         "plain_ms": row[4][0], "bound_ms": b_ms, "bound_by": b_by, "library_ms": p_lms_l[0]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if "--rank" in sys.argv:  # one rank of phase 11b, 11c or 11d
        import argparse

        ap = argparse.ArgumentParser()
        for flag in ("--rank", "--world", "--port"):
            ap.add_argument(flag, type=int, required=True)
        ap.add_argument("--out", required=True)
        ap.add_argument("--mesh", default=None, help="DxM, default: every rank on the data axis")
        ap.add_argument("--ydim", type=int, default=YDIM, help="fit the first YDIM neurons")
        args = ap.parse_args()
        shape = (args.world, 1) if args.mesh is None else tuple(map(int, args.mesh.split("x")))
        sharded_worker(args.rank, args.world, args.port, args.out, shape, args.ydim)
    else:
        main()
