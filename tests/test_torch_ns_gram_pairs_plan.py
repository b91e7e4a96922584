"""The launch plan of ns_gram's long-T design (``ops/spd.py:pairs_plan``).

At T >= 100 ``ns_gram`` runs the Gram and v as two FP32 GEMMs over the
pairs of the upper triangle.  Each GEMM runs on the streaming GEMM of
``csrc/ns_inverse.cu`` (persistent blocks of consumer and helper warps
around a ring of stages, A copied by tensor-memory-accelerator boxes) or on
the tiled kernel.  ``pairs_stream_plan`` picks, by (Z, S, T, R) and
the card's SM count alone, each streaming GEMM's tile shape, stage count
and grid; ``pairs_plan`` keeps a GEMM on the streaming GEMM where its 128
x 128 tiles give every SM four rounds or more.  None of these changes a bit
of the output (each output is one FMA chain over k in order, whatever tile
holds it), so these tests hold the plans to the kernel's limits and layout:
every output covered once by a tile that runs the full K, 232,448 bytes, 3
or 4 stages as documented, the tile order, the copy path, and the rule.
The long-T design keeps the (Z, S, P) scratch unpadded: read as
groups of four rows it has an aligned stride for odd P, so no padded
scratch is needed.  The kernels' bits against the tiled kernels' (``TILED_PLAN``) and
the plans' bytes against the kernel's own layout are held on the card
(``chip_smoke.check_ns_gram_pairs_paths``).
"""
import inspect

import numpy as np
import pytest
import torch

from vlgp_tpu_torch.ops import spd as tspd

# (Z, S, T, R): a leave-one-neuron-out chunk, the final inference, a
# 200-bin trial set, and the crossover's edges (T 100, 101 and 1023: w's
# rows aligned or not; R 1, 17, 50, 127, 128: P odd, even, the largest)
SHAPES = ([(5, 2500, 1000, 50), (5, 100, 1000, 50), (5, 500, 200, 50)]
          + [(2, 131, T, R) for T in (100, 101, 1023) for R in (1, 17, 50, 127, 128)])


def _dims(kind, S, T, R):
    """(M, N, K) of the Gram (kind 0) or of v (kind 1)."""
    P = R * (R + 1) // 2
    return (S, P, T) if kind == 0 else (S, T, P)


def _gemms(plan):
    return ((0, plan.gram), (1, plan.v))


@pytest.mark.parametrize("Z,S,T,R", SHAPES)
def test_plan_covers_every_output_once(Z, S, T, R):
    """Every output of both GEMMs lies in exactly one tile of one block's
    walk, and every tile runs the whole K (no split of k)."""
    plan = tspd.pairs_stream_plan(Z, S, T, R)
    assert plan.path == "stream"
    for kind, gemm in _gemms(plan):
        M, N, K = _dims(kind, S, T, R)
        walk = tspd.pairs_walk(gemm, Z, M, N)
        assert len(walk) == gemm.grid and all(walk)  # no block without a tile
        hits = np.zeros((Z, M, N), dtype=np.int32)
        for tiles in walk:
            for z, m0, n0 in tiles:
                hits[z, m0:m0 + gemm.bm, n0:n0 + gemm.bn] += 1
        assert (hits == 1).all()
        # the kernel's k loop: ceil(K / 32) stages of 32 from k = 0 for every tile
        stages = -(-K // tspd._PG_BK)
        assert (stages - 1) * tspd._PG_BK < K <= stages * tspd._PG_BK


@pytest.mark.parametrize("Z,S,T,R", SHAPES)
def test_plan_fits_the_kernel(Z, S, T, R):
    """Shared memory within 232,448 bytes and equal to the kernel's layout,
    the block's threads those of its tile shape, 4 stages where they keep
    the blocks an SM of 3 (or where the grid puts one block on an SM) and
    else 3, a grid no larger than the tiles or the blocks the card holds at
    once."""
    plan = tspd.pairs_stream_plan(Z, S, T, R)
    for kind, gemm in _gemms(plan):
        M, N, _ = _dims(kind, S, T, R)
        bm, bn, cw, hw = tspd._PAIRS_SHAPES[gemm.shape]
        assert (gemm.bm, gemm.bn, gemm.threads) == (bm, bn, 32 * (cw + hw))
        assert gemm.smem == tspd._pairs_smem(kind, bm, bn, R, gemm.stages) <= tspd.SMEM_MAX
        stages, per_sm = tspd._pairs_fit(kind, gemm.shape, R)
        tiles = Z * -(-M // bm) * -(-N // bn)
        assert 1 <= gemm.grid == min(tiles, tspd.SMS * per_sm)
        alone = gemm.grid <= tspd.SMS and tspd._pairs_smem(kind, bm, bn, R, 4) <= tspd.SMEM_MAX
        assert gemm.stages == (4 if alone else stages) and gemm.stages in (3, 4)
        blocks = lambda st: tspd._SM_SMEM // (tspd._pairs_smem(kind, bm, bn, R, st) + 1024)  # noqa: E731
        if stages == 3 and tspd._pairs_smem(kind, bm, bn, R, 4) <= tspd.SMEM_MAX:
            assert min(blocks(4), per_sm + 1) < per_sm  # a fourth stage costs a block an SM
        # consumer warps of 64 x 32 tiles (8 x 8 sums a lane) cover the tile;
        # each helper owns whole columns of B and whole boxes of A's residues
        assert cw == (bm // 64) * (bn // 32)
        assert bn % (32 * hw) == 0 and 4 % hw == 0


@pytest.mark.parametrize("Z,S,T,R", SHAPES)
def test_copy_path_is_the_tensor_boxes_at_every_alignment(Z, S, T, R):
    """A's rows go by tensor-memory-accelerator boxes whatever the row
    length: read as groups of four rows, A's row stride is 16 K bytes, which
    is 16-byte aligned for odd K too (w's rows at T 101 and 1023, Xp's at
    odd P); the ends (the stage past K % 32, the last partial group) and an
    A whose address is not 16-byte aligned take 4-byte copies inside the
    kernel, into the same layout."""
    plan = tspd.pairs_stream_plan(Z, S, T, R)
    assert plan.gram.copy == plan.v.copy == "tma"
    for K in (T, R * (R + 1) // 2):
        assert (16 * K) % 16 == 0 and (4 * K) % 4 == 0


def test_tile_order_is_latent_then_column_then_row():
    """Block b takes tiles b, b + grid, ...; the list runs over latents,
    within a latent over columns of tiles, within a column over rows, so
    the blocks in flight share a latent's rows of A and one column's B."""
    Z, S, T, R = 3, 300, 200, 17
    plan = tspd.pairs_stream_plan(Z, S, T, R)
    for kind, gemm in _gemms(plan):
        M, N, _ = _dims(kind, S, T, R)
        walk = tspd.pairs_walk(gemm, Z, M, N)
        by_tau = {}
        for b, tiles in enumerate(walk):
            for k, tile in enumerate(tiles):
                by_tau[b + k * gemm.grid] = tile
        expected = [(z, m0, n0) for z in range(Z) for n0 in range(0, N, gemm.bn)
                    for m0 in range(0, M, gemm.bm)]
        assert [by_tau[t] for t in range(len(expected))] == expected


def test_plan_shapes_at_the_main_path():
    """The streaming GEMM's model picks 128 x 128 tiles on one persistent
    block an SM at a leave-one-neuron-out chunk and 64 x 128 tiles on a
    block a tile at the final inference (50 tiles of 128 x 128 would leave
    82 of 132 SMs idle)."""
    chunk = tspd.pairs_stream_plan(5, 2500, 1000, 50)
    assert [(g.bm, g.bn, g.grid, g.stages) for g in (chunk.gram, chunk.v)] == [
        (128, 128, 132, 4), (128, 128, 132, 4)]
    final = tspd.pairs_stream_plan(5, 100, 1000, 50)
    assert [(g.bm, g.bn, g.grid) for g in (final.gram, final.v)] == [(64, 128, 100),
                                                                     (64, 128, 80)]


@pytest.mark.parametrize("Z,S,T,R", SHAPES + [(5, 700, 1000, 50), (12, 2500, 1000, 50)])
def test_rule_streams_a_gemm_with_four_rounds_of_tiles(Z, S, T, R):
    """pairs_plan streams a GEMM where its 128 x 128 tiles give each of the
    132 SMs four rounds or more (the chunk's 1,000 and 800), keeps the
    tiled kernel elsewhere (the final inference, batch 7's 300 and 240
    tiles, the crossover's edges), TILED_PLAN where neither streams, and
    takes a streaming GEMM as pairs_stream_plan gives it."""
    P = R * (R + 1) // 2
    plan, full = tspd.pairs_plan(Z, S, T, R), tspd.pairs_stream_plan(Z, S, T, R)
    want = [Z * -(-S // 128) * -(-N // 128) >= 4 * tspd.SMS for N in (P, T)]
    if not any(want):
        assert plan == tspd.TILED_PLAN
        return
    assert plan.path == "stream"
    assert plan.gram == (full.gram if want[0] else None)
    assert plan.v == (full.v if want[1] else None)
    if (Z, S, T, R) == (5, 2500, 1000, 50):
        assert plan.gram is not None and plan.v is not None


def test_plan_reads_the_shape_and_the_sm_count_alone():
    for fn in (tspd.pairs_plan, tspd.pairs_stream_plan):
        assert list(inspect.signature(fn).parameters) == ["Z", "S", "T", "R", "nsm"]
    for nsm in (66, 114):  # other cards' SM counts: still every output once
        plan = tspd.pairs_stream_plan(5, 500, 200, 50, nsm)
        for kind, gemm in _gemms(plan):
            M, N, _ = _dims(kind, 500, 200, 50)
            hits = sum(len(t) for t in tspd.pairs_walk(gemm, 5, M, N))
            assert hits == 5 * -(-M // gemm.bm) * -(-N // gemm.bn)
            assert gemm.grid <= nsm * tspd._pairs_fit(kind, gemm.shape, 50)[1]


def _cpu_problem(Z=2, S=3, T=100, R=5):
    rng = np.random.default_rng(0)
    G = torch.from_numpy(rng.normal(size=(Z, T, R)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=(Z, S, T)).astype(np.float32))
    return G, w


def test_wrapper_refuses_a_plan_the_kernels_would_refuse():
    """Refused before any device is touched: a layout other than the
    kernel's, stages past 4, no blocks, an unknown copy path, tile shape or
    path, and a plan of the other design."""
    G, w = _cpu_problem()
    Z, S, T, R = 2, 3, 100, 5
    good = tspd.pairs_stream_plan(Z, S, T, R)
    g = good.gram
    bad = [good._replace(gram=g._replace(smem=g.smem + 16)),
           good._replace(gram=g._replace(stages=5)),
           good._replace(v=good.v._replace(grid=0)),
           good._replace(v=good.v._replace(copy="bulk")),
           good._replace(gram=g._replace(shape=3))]
    for plan in bad:
        with pytest.raises(ValueError, match="does not fit"):
            tspd._ns_gram_cuda(G, w, plan=plan)
    with pytest.raises(ValueError, match="unknown ns_gram_pairs path"):
        tspd._ns_gram_cuda(G, w, plan=good._replace(path="fast"))
    with pytest.raises(ValueError, match="per-matrix design"):
        tspd._ns_gram_cuda(G, w, design="per_matrix", plan=good)
    with pytest.raises(ValueError, match="per-matrix design"):
        tspd._ns_gram_cuda(G, w, plan=tspd.BLOCK_PLAN)
    # a valid plan, the tiled plan or none: refused only for the CPU tensors
    for plan in (good, tspd.TILED_PLAN, None):
        with pytest.raises(ValueError, match="CUDA"):
            tspd._ns_gram_cuda(G, w, plan=plan)
    assert tspd.KERNEL_LAUNCHES["ns_gram"] == tspd.KERNEL_LAUNCHES["ns_gram_pairs_stream"] == 0


def test_cpu_dispatch_stays_the_plain_version():
    """At T >= 100 on the CPU ns_gram is the plain version, bit for bit,
    and counts no launch."""
    G, w = _cpu_problem(T=120)
    assert tspd._ns_gram_design(120, 5) == "pairs"
    for kw in (dict(), dict(want_v=True), dict(iters=4, want_v=True)):
        got = tspd.ns_gram(G, w, **kw)
        X, resid, v = tspd._ns_gram_plain(G, w, **kw)
        assert torch.equal(got[0], X) and torch.equal(got[1], resid.amax())
        assert (v is None and got[2] is None) or torch.equal(got[2], v)
    assert tspd.KERNEL_LAUNCHES["ns_gram"] == tspd.KERNEL_LAUNCHES["ns_gram_pairs_stream"] == 0
