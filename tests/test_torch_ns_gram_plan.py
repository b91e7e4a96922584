"""The launch plan of ns_gram's per-matrix design (``ops/spd.py:gram_plan``).

The plan picks, by (T, R, Z) and the card's SM count alone, the streaming
path (persistent blocks, G resident, one consumer warp a matrix in 8 x 8
tiles, ``csrc/ns_inverse.cu:ns_gram_stream_kernel``) or the block path (a
block per matrix).  These tests hold the plan to the kernel's limits (R <=
40, 2 to 8 consumer warps, 232,448 bytes of shared memory), to its rule
(stream at 37 <= R <= 40), to a walk that takes every matrix once, and the
wrapper to its refusals.  The plan's byte count is held equal to the
kernel's own layout on the card (``chip_smoke.check_gram_smem``); the CPU
dispatch of ``ns_gram`` stays the plain version, which
``tests/test_torch_spd.py`` holds against the Pallas kernel.
"""
import inspect

import numpy as np
import pytest
import torch

from vlgp_tpu_torch.ops import spd as tspd

# (T, R, Z): the fit's segments (T50 R40 Z5), the ends of the streaming
# path's R (37, 40) and of the per-matrix design's T (1, 99), widths past it
# (41 to 128), and Z 1 / 12 (26 and 11 blocks a latent on 132 SMs)
SHAPES = [(50, 40, 5), (99, 40, 5), (1, 40, 1), (13, 37, 12), (50, 38, 5), (99, 39, 12),
          (50, 36, 5), (50, 17, 1), (1, 1, 1), (33, 41, 5), (50, 50, 5), (99, 64, 12),
          (50, 100, 5), (99, 128, 1), (7, 128, 12)]


def _lanes_rule(R):
    """Stream where the block path's block has 128 threads or more (so its
    4 x 4 tiles issue as many FMA instructions a step as one warp's 8 x 8
    tiles) and one warp holds the 8 x 8 tiles."""
    nb = -(-R // 4)
    return R <= 40 and -(-nb * nb // 32) * 32 >= 128


@pytest.mark.parametrize("T,R,Z", SHAPES)
def test_plan_fits_the_kernel(T, R, Z):
    plan = tspd.gram_plan(T, R, Z)
    assert plan.path == ("stream" if _lanes_rule(R) else "block")
    assert plan.smem <= tspd.SMEM_MAX == 232_448
    nb = -(-R // 4)
    if plan.path == "stream":
        assert 2 <= plan.warps <= 8
        assert plan.threads == 32 * (plan.warps + 1)
        assert plan.per == max(1, tspd.SMS // Z) and Z * plan.per <= max(Z, tspd.SMS)
        assert plan.smem == tspd._gram_stream_smem(T, R, plan.warps)
        # the most warps that fit: one more would not (or 8 already)
        assert plan.warps == 8 or tspd._gram_stream_smem(T, R, plan.warps + 1) > tspd.SMEM_MAX
    else:
        assert (plan.warps, plan.per) == (0, 0)
        assert plan.threads == -(-nb * nb // 32) * 32


def test_plan_reads_no_segment_count():
    """The choice is a function of (T, R, Z) and the SM count, never of S,
    so a segment's bits do not depend on how many segments share the call."""
    assert list(inspect.signature(tspd.gram_plan).parameters) == ["T", "R", "Z", "nsm"]
    assert list(inspect.signature(tspd.stream_plan).parameters) == ["T", "R", "Z", "nsm"]


def test_rule_streams_only_where_the_block_path_fills_four_warps():
    for T in (1, 50, 99):
        assert [R for R in range(1, 129) if tspd.gram_plan(T, R, 5).path == "stream"] == [
            37, 38, 39, 40]


def test_stream_plan_runs_wherever_a_warp_holds_the_tiles():
    """The streaming path itself takes every R <= 40 (chip_smoke forces it at
    the edge shapes), and no R past it."""
    for T in (1, 13, 50, 99):
        for R in range(1, 41):
            plan = tspd.stream_plan(T, R, 5)
            assert plan is not None and plan.smem <= tspd.SMEM_MAX and plan.warps >= 2
        assert tspd.stream_plan(T, 41, 5) is None


def test_block_path_where_the_stream_does_not_fit():
    for R in (41, 50, 64, 100, 127, 128):
        plan = tspd.gram_plan(99, R, 5)
        assert plan.path == "block" and plan.smem == tspd._gram_block_smem(R)
    # the block path's bytes: Mt, X, Xt, the G chunk, w, v's partial sums,
    # one float a warp (223,488 at R = 128, csrc/ns_inverse.cu)
    assert tspd._gram_block_smem(128) == 223_488
    assert tspd._gram_block_smem(40) == 27_664


def test_stream_layout_grows_by_a_warp_at_a_time():
    """The streaming layout: fixed bytes (mbarriers, G twice) plus the same
    bytes for each consumer warp; G grows with T, a warp with R."""
    for T, R in ((50, 40), (99, 37), (1, 1)):
        sizes = [tspd._gram_stream_smem(T, R, w) for w in range(1, 9)]
        steps = set(np.diff(sizes))
        assert len(steps) == 1 and steps.pop() > 0
    assert tspd._gram_stream_smem(99, 40, 8) > tspd._gram_stream_smem(50, 40, 8)
    assert tspd._gram_stream_smem(50, 40, 8) > tspd._gram_stream_smem(50, 32, 8)


@pytest.mark.parametrize("Z,S", [(5, 2000), (5, 100), (1, 1), (12, 7), (2, 131), (140, 3)])
def test_walk_takes_every_matrix_once(Z, S):
    plan = tspd.stream_plan(50, 40, Z)
    walk = tspd.gram_walk(plan, Z, S)
    assert len(walk) == Z * min(plan.per, S)
    seen = [b for block in walk for b, _ in block]
    assert sorted(seen) == list(range(Z * S))
    for block in walk:
        bs = [b for b, _ in block]
        assert bs == sorted(bs) and len({b // S for b in bs}) <= 1  # one latent a block
        assert [g for _, g in block] == [k % plan.warps for k in range(len(block))]


def _cpu_problem(Z=2, S=3, T=7, R=5):
    rng = np.random.default_rng(0)
    G = torch.tensor(rng.standard_normal((Z, T, R)) * 0.3, dtype=torch.float32)
    w = torch.tensor(rng.random((Z, S, T)), dtype=torch.float32)
    return G, w


def test_wrapper_refuses_a_plan_the_kernel_would_refuse():
    """Refused before any device is touched: a streaming plan past R = 40,
    with a layout other than the kernel's, warps past 8, no blocks, an
    unknown path, or a plan for the long-T design."""
    G, w = _cpu_problem(R=5)
    T, R, Z = 7, 5, 2
    good = tspd.stream_plan(T, R, Z)
    bad = [good._replace(smem=good.smem + 16), good._replace(warps=9, threads=320),
           good._replace(per=0), good._replace(threads=good.threads + 32),
           good._replace(path="fast")]
    for plan in bad:
        with pytest.raises(ValueError, match="streaming plan|unknown ns_gram path"):
            tspd._ns_gram_cuda(G, w, plan=plan)
    G50, w50 = _cpu_problem(R=50)
    with pytest.raises(ValueError, match="does not fit"):
        tspd._ns_gram_cuda(G50, w50, plan=tspd.stream_plan(7, 40, 2)._replace(
            smem=tspd._gram_stream_smem(7, 50, 8)))
    with pytest.raises(ValueError, match="per-matrix design"):
        tspd._ns_gram_cuda(G, w, design="pairs", plan=good)
    # a valid plan, the block plan or none: refused only for the CPU tensors
    for plan in (good, tspd.BLOCK_PLAN, None):
        with pytest.raises(ValueError, match="CUDA"):
            tspd._ns_gram_cuda(G, w, plan=plan)
    assert tspd.KERNEL_LAUNCHES["ns_gram"] == tspd.KERNEL_LAUNCHES["ns_gram_stream"] == 0


def test_cpu_dispatch_stays_the_plain_version():
    G, w = _cpu_problem()
    for kw in (dict(), dict(want_v=True), dict(iters=4, want_v=True)):
        got = tspd.ns_gram(G, w, **kw)
        X, resid, v = tspd._ns_gram_plain(G, w, **kw)
        assert torch.equal(got[0], X) and torch.equal(got[1], resid.amax())
        assert (v is None and got[2] is None) or torch.equal(got[2], v)
    assert tspd.KERNEL_LAUNCHES["ns_gram"] == tspd.KERNEL_LAUNCHES["ns_gram_stream"] == 0
