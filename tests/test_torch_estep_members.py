"""The member axis of the E-step's kernels (``vlgp_tpu_torch/ops/estep.py``,
leave-one-neuron-out's chunks): the member plain versions against the torch
chain that ``models/vlgp.estep_members`` ran a round before the kernels took
the members, ``estep_members``' calls, the launch plans of both kernels with
members and of ``estep_step``'s cluster path at whole trials, and the CUDA
wrappers' refusals.  The kernels themselves run on the card only
(``chip_smoke.py``, 6e and 9c).

Tolerance: none.  The plain versions must give the chain's bits, so
leave-one-neuron-out on the CPU keeps its scores to the last bit.
"""
import numpy as np
import pytest
import torch

from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.ops import control
from vlgp_tpu_torch.ops import estep as oe
from vlgp_tpu_torch.ops.math import trunc_exp

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the chain estep_members ran a round before the member axis, verbatim
# ---------------------------------------------------------------------------

def _chain_eta_rates(muz, vz, a, xb):
    shape = (-1,) + tuple(xb.shape)
    eta = torch.einsum("zst,zy->sty", muz, a).reshape(shape) + xb
    r = trunc_exp(eta + torch.einsum("zst,zy->sty", vz, 0.5 * a * a).reshape(shape))
    return eta, r


def _chain_round(y, xb, mask, a, poisson, noise, G, muz, wz, vz, X, cmask, dmu_bound):
    """s, then (mu + delta, delta, w): the sweep body of estep_members before
    the kernels (its ``_residual``, einsum, ``_woodbury_delta``, clamp and
    ``_member_weights``)."""
    B = cmask.shape[0]
    T, Y = y.shape[1:]
    m = mask[..., None]
    cm = cmask[:, None, None, :]
    maskz = mask.repeat(B, 1)[None]
    eta, r = _chain_eta_rates(muz, vz, a, xb)
    residual = torch.where(poisson, y - r, (y - eta) / torch.clamp(noise, min=1e-30)) * m * cm
    s = torch.einsum("sty,zy->zst", residual.reshape(-1, T, Y), a)
    Gts = torch.einsum("ztr,zst->zsr", G, s)
    u = torch.einsum("ztr,zsr->zst", G, Gts) - muz
    Gwu = torch.einsum("ztr,zst->zsr", G, (wz * maskz) * u)
    M = torch.einsum("zsrq,zsq->zsr", X, Gwu)
    delta = u - torch.einsum("ztr,zsr->zst", G, M)
    delta = torch.clamp(delta, -dmu_bound, dmu_bound) * maskz
    muz = muz + delta
    _, r = _chain_eta_rates(muz, vz, a, xb)
    U = torch.where(poisson, r, 1.0 / torch.clamp(noise, min=1e-30)) * cm
    w = torch.einsum("sty,zy->zst", U.reshape(-1, *U.shape[-2:]), a * a) * maskz
    return s, (muz, delta, w)


def _members(S, T, Y, Z, R, B, dtype, dmu_bound, seed=0):
    """One round's inputs of B members on S shared segments: mixed channels
    (the second half Gaussian, the last one padded with zero loading, data
    and noise, channel 0 a Poisson channel whose unused noise is NaN), a
    ragged mask with segment 0 masked whole, member b holding out channel b
    mod Y."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(Z, Y)) * 0.4
    xb = np.full((S, T, Y), -0.5) + rng.normal(size=(S, T, Y)) * 0.05
    mu = rng.normal(size=(Z, B * S, T)) * 0.5
    eta = np.einsum("zst,zy->sty", mu[:, :S], a) + xb
    y = rng.poisson(np.exp(eta)).astype(np.float64)
    poisson = np.ones(Y, dtype=bool)
    noise = np.ones(Y)
    gauss = np.arange(Y) >= Y // 2
    poisson[gauss] = False
    noise[gauss] = rng.uniform(0.5, 2.0, size=int(gauss.sum()))
    y[..., gauss] = eta[..., gauss] + rng.normal(size=(S, T, int(gauss.sum())))
    a[:, -1], xb[..., -1], y[..., -1], noise[-1] = 0.0, 0.0, 0.0, 0.0
    noise[0] = np.nan
    ends = rng.integers(1, T + 1, size=S)
    mask = (np.arange(T)[None] < ends[:, None]).astype(np.float64)
    mask[0] = 0.0
    G = rng.normal(size=(Z, T, R)) * 0.6
    v = rng.uniform(0.01, 0.1, size=(Z, B * S, T))
    w = rng.uniform(0.1, 3.0, size=(Z, B * S, T))
    wm = w * np.tile(mask, (B, 1))[None]
    X = np.linalg.inv(np.eye(R) + np.einsum("ztr,zst,ztq->zsrq", G, wm, G))
    cm = np.ones((B, Y))
    cm[np.arange(B), np.arange(B) % Y] = 0.0
    t = {k: torch.tensor(v_, dtype=dtype) for k, v_ in dict(
        y=y, xb=xb, mask=mask, a=a, noise=noise, G=G, mu=mu, v=v, w=wm, X=X, cm=cm).items()}
    t["poisson"] = torch.tensor(poisson)
    t["dmu_bound"] = dmu_bound
    return t


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("B", [1, 3, 4])
def test_member_plain_versions_are_the_chain_bit_for_bit(B, dtype):
    """``_estep_project_plain`` and ``_estep_step_plain`` with ``cm`` give
    the chain's s, mu, delta and w bit for bit (mixed channels, a ragged
    mask, a clip that binds); so do the wrappers on CPU tensors, which
    launch nothing."""
    from vlgp_tpu_torch.ops.spd import KERNEL_LAUNCHES

    t = _members(5, 9, 8, 3, 4, B, dtype, dmu_bound=0.05)
    project = (t["y"], t["xb"], t["mask"], t["a"], t["mu"], t["v"], t["poisson"], t["noise"])
    s_ref, out_ref = _chain_round(t["y"], t["xb"], t["mask"], t["a"], t["poisson"], t["noise"],
                                  t["G"], t["mu"], t["w"], t["v"], t["X"], t["cm"],
                                  t["dmu_bound"])
    before = dict(KERNEL_LAUNCHES)
    for fn in (oe._estep_project_plain, oe.estep_project):
        assert torch.equal(fn(*project, t["cm"]), s_ref)
    step = (t["G"], s_ref, t["mu"], t["w"], t["X"], t["mask"], t["a"], t["xb"], t["v"],
            t["poisson"], t["noise"], t["dmu_bound"])
    for fn in (oe._estep_step_plain, oe.estep_step):
        for name, g, r in zip(("mu", "delta", "w"), fn(*step, t["cm"]), out_ref):
            assert torch.equal(g, r), name
    assert dict(KERNEL_LAUNCHES) == before
    assert float(out_ref[1].abs().max()) == pytest.approx(0.05)  # the clip binds
    assert torch.isfinite(s_ref).all() and all(torch.isfinite(o).all() for o in out_ref)


def _pin(dtype=torch.float64, ntrial=3, length=40, ydim=6, zdim=2):
    from vlgp_tpu_torch.config import default_config, make_params
    from vlgp_tpu_torch.data import pack_trials
    from vlgp_tpu_torch.models.gp import make_cholesky

    rng = np.random.default_rng(3)
    a = rng.normal(size=(zdim, ydim)) * 0.5
    trials = []
    for _ in range(ntrial):
        z = np.sin(np.linspace(0, 6, length))[:, None] * np.ones((1, zdim))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.0)).astype(float),
                       "mu": rng.normal(size=(length, zdim)) * 0.1})
    name = "float64" if dtype == torch.float64 else "float32"
    config = default_config(dtype=name, estep_tol=0.0, Eniter=3)
    params = make_params(ydim, zdim, 1, ["poisson"] * (ydim - 1) + ["gaussian"], a=a,
                         b=np.full((1, ydim), -1.0), noise=np.full(ydim, 0.8),
                         omega=np.full(zdim, 1e-2), dtype=dtype, device="cpu")
    data = pack_trials(trials, zdim, 1, dtype=dtype, device="cpu")
    G = make_cholesky(data.nbin, params)
    return data, params, G, config


def test_estep_members_calls_each_wrapper_once_a_round(monkeypatch):
    """A round of ``estep_members`` is one ``estep_project`` and one
    ``estep_step`` over the B*S segments with the chunk's channel weights,
    and nothing else of stages a-c: a fixed count of rounds (estep_tol 0),
    the same bits as without the counting wrappers."""
    data, params, G, config = _pin()
    B = 3
    cmask = torch.ones((B, params.a.shape[1]), dtype=torch.float64)
    cmask[torch.arange(B), torch.arange(B)] = 0.0
    *ref, ref_sweeps = tv.infer_members(data, params, G, config, cmask)
    calls = {"estep_project": 0, "estep_step": 0}

    def counted(name):
        fn = getattr(tv, name)

        def call(*args):
            calls[name] += 1
            assert args[-1] is cmask  # the chunk's channel weights, as cm
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(tv, name, counted(name))
    control.TRIPS["lono_rounds"] = 0
    *got, sweeps = tv.infer_members(data, params, G, config, cmask)
    rounds = control.TRIPS["lono_rounds"]
    assert rounds == config.Eniter and calls == {"estep_project": rounds, "estep_step": rounds}
    assert sweeps.tolist() == ref_sweeps.tolist() == [rounds] * B
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


# the shapes of the plans: whole trials at a chunk's edges, R from 1 to the
# limit, no members and leave-one-neuron-out's default batch
PLAN_T = (100, 101, 1000, 1024)
PLAN_R = (1, 50, 128)
PLAN_B = (1, 25)


@pytest.mark.parametrize("B", PLAN_B)
@pytest.mark.parametrize("T", PLAN_T)
def test_plans_with_members_fit_and_cover_every_segment_of_every_member_once(T, B):
    """Both kernels' plans at S100 Y100 Z5 with B members: each fits the
    H100's 232,448 bytes a block; ``estep_project``'s walk covers every
    (base row, member) once and ``estep_step``'s every (segment, member)
    once, the block path's too; the cluster path's blocks of a cluster
    take the cluster's segments, a base segment's members side by side."""
    S, Y, Z = 100, 100, 5
    N = S * T
    pp, bp = oe.project_plan(S, T, Y, Z, torch.float32, B), oe.block_plans(S, T, Y, Z, 50,
                                                                             torch.float32, B)[0]
    for plan in (pp, bp):
        assert 0 < plan.smem <= oe.SMEM_MAX == 232_448
        seen = np.zeros((B, N), dtype=np.int64)
        for block in oe.project_walk(plan, N, B):
            for first, n, m in block:
                seen[m, first:first + n] += 1
        assert (seen == 1).all()
    if pp.path == "stream":
        assert pp.smem == oe._project_smem(pp.units, pp.stages, Y, Z, 4, B)
    for R in PLAN_R:
        sp, bs = oe.step_plan(S, T, Y, Z, R, torch.float32, B), oe.block_plans(
            S, T, Y, Z, R, torch.float32, B)[1]
        for plan in (sp, bs):
            assert 0 < plan.smem <= oe.SMEM_MAX
            walk = oe.step_walk(plan, S, B)
            if plan.path == "cluster":
                assert all(walk[b] == walk[b - b % plan.units] for b in range(plan.grid))
                walk = walk[::plan.units]
            seen = np.zeros(B * S, dtype=np.int64)
            for block in walk:
                segs = [seg for seg, _ in block]
                for seg in segs:
                    seen[seg] += 1
                if plan.path == "cluster":  # a base segment's members side by side
                    assert segs == [m * S + s for s in sorted({x % S for x in segs})
                                    for m in range(B)]
            assert (seen == 1).all()
        if R == 50:  # the flagship's rank: whole trials take the cluster path
            assert sp.path == "cluster"


@pytest.mark.parametrize("T", PLAN_T)
def test_cluster_path_blocks_own_whole_chunks_in_order(T):
    """A cluster of t_chunks(T) blocks, block q owning chunk q of the sums
    over t (the block path's ceil(T / chunks) rows), the chunks in order and
    every row once; its shared memory the kernel's layout, within the
    H100's; another cluster size refused."""
    C = oe._t_chunks(T)
    rows = oe.cluster_rows(T, C)
    tch = -(-T // C)
    assert [first for first, _ in rows] == [q * tch for q in range(C)]
    assert all(n >= 1 for _, n in rows) and sum(n for _, n in rows) == T
    assert all(a + n == b for (a, n), (b, _) in zip(rows, rows[1:]))
    assert 2 <= C <= oe._CLUSTER_MAX
    plan = oe.step_plan(100, T, 100, 5, 50, torch.float32, 25)
    assert (plan.path, plan.units, plan.threads) == ("cluster", C, 384)
    assert plan.smem == oe._cluster_smem(C, plan.stages, T, 100, 5, 50, 4) <= oe.SMEM_MAX
    with pytest.raises(ValueError, match="t_chunks"):
        oe.cluster_rows(T, C + 1)


def test_cuda_wrappers_refuse_a_bad_cm_a_cpu_tensor_and_float16():
    """The CUDA launch paths raise on a cm of another shape (before they look
    at the device), on CPU tensors and on float16; the public wrappers check
    cm's shape on the CPU too."""
    t = _members(4, 7, 6, 2, 3, 3, torch.float32, dmu_bound=5.0)
    project = [t["y"], t["xb"], t["mask"], t["a"], t["mu"], t["v"], t["poisson"], t["noise"]]
    step = [t["G"], t["mu"], t["mu"], t["w"], t["X"], t["mask"], t["a"], t["xb"], t["v"],
            t["poisson"], t["noise"], 5.0]
    for bad in (t["cm"][:, 1:], t["cm"][:2], t["cm"][0]):
        for fn in (oe._estep_project_cuda, oe.estep_project):
            with pytest.raises(ValueError, match="shape"):
                fn(*project, bad)
        for fn in (oe._estep_step_cuda, oe.estep_step):
            with pytest.raises(ValueError, match="shape"):
                fn(*step, bad)
    with pytest.raises(ValueError, match="CUDA"):
        oe._estep_project_cuda(*project, t["cm"])
    with pytest.raises(ValueError, match="CUDA"):
        oe._estep_step_cuda(*step, t["cm"])
    with pytest.raises(TypeError, match="float32 or float64"):
        oe._estep_project_cuda(*[p.half() if p.is_floating_point() else p for p in project],
                               t["cm"].half())
    with pytest.raises(TypeError, match="float32 or float64"):
        oe._estep_step_cuda(*[p.half() if torch.is_tensor(p) and p.is_floating_point() else p
                              for p in step], t["cm"].half())
