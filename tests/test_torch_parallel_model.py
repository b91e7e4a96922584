"""vlgp_tpu_torch.parallel's model axis (channels split over ranks) on
torch.distributed: gloo ranks on the CPU (tests/_torch_dist_worker.py, one
process per rank) against vlgp_tpu.parallel on the same (data, model) mesh
of the virtual CPU devices, in float64 from the same start.

Tolerances are test_torch_parallel.py's for the (2, 1) mesh: one EM step
and one inference at atol 1e-12 (G G' 1e-9, norms 1e-15), a whole fit at
the JAX package's own (a 1e-6, omega 1e-8, mu 1e-6;
tests/test_fit_sharded.py:45-55 gives the reason).  The (1, 2) fit is the
exception, with its reason in its test: one golden-search comparison of its
first H-step flips on the rounding of the split channel sums."""
import datetime
import functools

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import jax

import vlgp_tpu_torch
from vlgp_tpu_torch.config import make_params
from vlgp_tpu_torch.data import pack_trials
from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.models.driver import check_capturable, make_em_step
from vlgp_tpu_torch.ops import sweep as tsw
from vlgp_tpu_torch.parallel import pad_channels, trim_channels

import _torch_dist_worker as W
from _torch_parity import assert_close, jax_scan, np_of, pin_trials

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gloo_model"))


@functools.lru_cache(maxsize=None)
def _launch(case: str, tmp: str, world: int, mesh: str):
    return W.launch(case, tmp, world, mesh)


@functools.lru_cache(maxsize=None)
def _gloo(case: str, tmp: str, world: int, mesh: str):
    """Every rank's result of one worker case (started once per module)."""
    return W.collect(_launch(case, tmp, world, mesh), case, tmp)


def _jmesh(shape):
    from vlgp_tpu.parallel import make_mesh

    return make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


@functools.lru_cache(maxsize=None)
def _jax_model():
    """vlgp_tpu.parallel on a (1, 2) mesh, 15 channels padded to 16: one EM
    step and one inference from the prepared state, then fit_sharded."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vlgp_tpu.config import default_config, make_params as jparams
    from vlgp_tpu.data import cut_trials, pack_trials as jpack
    from vlgp_tpu.models.gp import effective_rank, make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w
    from vlgp_tpu.parallel import (replicate, shard_data, sharded_em_step,
                                   sharded_infer)
    from vlgp_tpu.parallel.driver import fit_sharded
    from vlgp_tpu.parallel.mesh import _put, pad_channels as jpad_channels, to_host

    mesh = _jmesh((1, 2))
    config = default_config(**W.FIT_KW)
    trials, a = W.workload(ydim=W.YDIM_ODD)
    kw = W.start_kw(a)
    params = jparams(W.YDIM_ODD, W.ZDIM, 1, "poisson", a=kw["a"], b=kw["b"],
                     noise=kw["noise"], omega=np.full(W.ZDIM, 1e-2), dtype=jnp.float64)
    data = jpack(trials, W.ZDIM, 1, dtype=np.float64)
    data, params = jpad_channels(data, params, 2)
    G_full = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G_full, config)
    seg = cut_trials(data, config.window, seed=0)
    rank = min(params.rank, effective_rank(seg.nbin, config.omega_bound[1], params.dt))
    G = make_cholesky(seg.nbin, params, rank=rank)
    seg_s = shard_data(seg, mesh)
    params_r, G_r = replicate((params, G), mesh)
    xinv = _put(np.zeros((W.ZDIM, seg.ntrial, rank, rank)), mesh, P(None, "data", None, None))
    seg_o, p_o, G_o, norms, _ = sharded_em_step(mesh, config, seg_s, params_r)(
        seg_s, params_r, G_r, xinv, 0)
    data_s = shard_data(data, mesh)
    inf = sharded_infer(mesh, config, data_s, params_r)(data_s, params_r, replicate(G_full, mesh))

    seen = []
    res = fit_sharded(trials, W.ZDIM, mesh=mesh, track_elbo=True,
                      callbacks=[lambda d, p, c: seen.append(p)], **kw, **W.FIT_KW)
    return dict(seg=to_host(seg_o), params=to_host(p_o), G=np.asarray(G_o),
                norms={k: float(v) for k, v in norms.items()}, infer=to_host(inf),
                fit=res, seen=seen)


@functools.lru_cache(maxsize=None)
def _jax_model4():
    """vlgp_tpu.parallel's fit_sharded on a (2, 2) mesh, 15 channels."""
    from vlgp_tpu.parallel.driver import fit_sharded

    trials, a = W.workload(ydim=W.YDIM_ODD)
    return fit_sharded(trials, W.ZDIM, mesh=_jmesh((2, 2)), **W.start_kw(a), **W.FIT_KW)


def _fit_close(got, mu, ref):
    assert np.abs(got["a"].numpy() - np.asarray(ref.params.a)).max() < 1e-6
    assert np.abs(got["omega"].numpy() - np.asarray(ref.params.omega)).max() < 1e-8
    assert np.abs(mu.numpy() - np.asarray(ref.data.mu)).max() < 1e-6


def test_model_axis_em_step_and_infer_match_jax(tmp_dir):
    """One sharded_em_step (its H-step included) and one sharded_infer over
    two gloo ranks of a (1, 2) mesh against vlgp_tpu.parallel's, from the
    same state: 15 channels padded to 16, 8 per rank.  Every all-reduce is
    on the model axis (the data axis has one rank): 50 of the 53 are the two
    (Z, S, T) sums of each of the 25 sweeps, and the padded channel's a and
    b stay exactly zero."""
    _launch("model", tmp_dir, 2, "1x2")  # the ranks run while vlgp_tpu computes its side
    ref = _jax_model()
    ranks = _gloo("model", tmp_dir, 2, "1x2")
    for r in ranks:
        assert r["local_y"][-1] == 8 and r["likelihood_kind"] == "poisson"
        for f in ("mu", "w", "v", "dmu"):
            assert_close(r["step_seg"][f], np.asarray(getattr(ref["seg"], f)), atol=1e-12,
                         err_msg=f)
            assert_close(r["infer"][f], np.asarray(getattr(ref["infer"], f)), atol=1e-12,
                         err_msg=f)
        for f in ("a", "b", "noise", "omega", "sigma", "da", "db"):
            assert_close(r["step_params"][f], np.asarray(getattr(ref["params"], f)),
                         atol=1e-12, err_msg=f)
        assert torch.equal(r["step_params"]["active"], torch.arange(16) < 15)
        for f in ("a", "b", "da", "db"):
            assert torch.all(r["step_params"][f][:, 15:] == 0), f
        # G is the factor at the new omega; a pivot tie of the pivoted ichol
        # (ROADMAP Queue 3) may swap columns of one latent, so compare the
        # prior G G' it stands for, at test_torch_parallel.py's G tolerance
        assert_close(r["step_G"] @ r["step_G"].mT, ref["G"] @ ref["G"].transpose(0, 2, 1),
                     atol=1e-9)
        for k, v in ref["norms"].items():
            assert_close(r["step_norms"][k], v, atol=1e-15, err_msg=k)
        c = r["step_counts"]
        assert c["all_reduce_data"] == c["bytes_data"] == 0
        assert c["all_reduce"] == c["all_reduce_model"] == 53
        S, T = ref["seg"].mu.shape[:2]
        # and 4 squared norms before and after the step and the loading's norm
        assert c["bytes_model"] - 50 * W.ZDIM * S * T * 8 == 2 * 4 * 8 + 8
    a, b = ranks
    for f in a["step_params"]:
        assert torch.equal(a["step_params"][f], b["step_params"][f]), f
    for f in a["step_seg"]:
        assert torch.equal(a["step_seg"][f], b["step_seg"][f]), f


def test_model_axis_fit_sharded_pads_channels_matches_jax(tmp_dir):
    """fit_sharded over a (1, 2) mesh with 15 channels (one padded) against
    vlgp_tpu's on the same mesh: 4 EM iterations and the closing H-step; the
    result and every boundary's params have the 15 real channels.

    The first boundary's loading matches at 1e-12, but its H-step ends one
    golden-search bracket from vlgp_tpu's: omega 6.4e-4 (near the lower
    bound, where the objective is flat) comes out 5.0e-8 apart.  The port
    sums each channel contraction as two partial sums and an all_reduce,
    which rounds differently from one sum (XLA's pairwise reduction gives
    vlgp_tpu the same bits either way: its (1, 2) fit equals its fit to
    1e-13), and that flips one golden comparison; one EM step from one
    state agrees at 1e-12 (the test above).  So the whole fit is held to
    what the flip leaves: omega within 2e-4 relative at every boundary,
    a 1e-5, mu 1e-4 (|mu| up to 3.8), the ELBO series at rtol 1e-6 (measured:
    omega 7.8e-5, a 2.1e-6, mu 5.5e-5, ELBO 3.1e-7)."""
    ranks = _gloo("model", tmp_dir, 2, "1x2")
    ref = _jax_model()
    fit = ref["fit"]
    assert fit.params.ydim == 15 and fit.runtime.get("final_hstep") is True
    for r in ranks:
        assert r["fit_ydim"] == 15 and r["fit_params"]["a"].shape == (W.ZDIM, 15)
        assert "active" not in r["fit_params"]
        assert r["final_hstep"] is True and r["fit_runtime"]["it"] == fit.runtime["it"]
        assert [n for n, _ in r["seen"]] == [15] * fit.runtime["it"]
        assert_close(r["seen"][0][1]["a"], np.asarray(ref["seen"][0].a), atol=1e-12)
        for (_, p), jp in zip(r["seen"], ref["seen"]):
            assert p["a"].shape == (W.ZDIM, 15)
            assert_close(p["omega"], np.asarray(jp.omega), rtol=2e-4)
        assert_close(r["fit_params"]["omega"], np.asarray(fit.params.omega), rtol=2e-4)
        assert np.abs(r["fit_params"]["a"].numpy() - np.asarray(fit.params.a)).max() < 1e-5
        assert np.abs(r["fit_mu"].numpy() - np.asarray(fit.data.mu)).max() < 1e-4
        assert_close(np.array(r["fit_runtime"]["elbo"]), np.array(fit.runtime["elbo"]), rtol=1e-6)
    assert torch.equal(ranks[0]["fit_mu"], ranks[1]["fit_mu"])
    for f in ranks[0]["fit_params"]:
        assert torch.equal(ranks[0]["fit_params"][f], ranks[1]["fit_params"][f]), f


def test_model_axis_four_ranks_fit_sharded_matches_jax(tmp_dir):
    """fit_sharded on a (2, 2) mesh of four gloo ranks (rank r at (r // 2,
    r % 2)), both axes at once: 15 segments padded to 16, 15 channels padded
    to 16, against vlgp_tpu's on a (2, 2) mesh; every rank ends equal."""
    _launch("model4", tmp_dir, 4, "2x2")
    ref = _jax_model4()
    ranks = _gloo("model4", tmp_dir, 4, "2x2")
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["final_hstep"] is True and r["it"] == ref.runtime["it"]
        _fit_close(r["fit_params"], r["fit_mu"], ref)
        assert r["collectives"]["all_reduce_data"] > 0 and r["collectives"]["all_reduce_model"] > 0
    for r in ranks[1:]:
        assert torch.equal(r["fit_mu"], ranks[0]["fit_mu"])
        for f in r["fit_params"]:
            assert torch.equal(r["fit_params"][f], ranks[0]["fit_params"][f]), f
        assert r["collectives"] == ranks[0]["collectives"]


def test_model_axis_em_scan_and_block_fit_match_jax(tmp_dir):
    """sharded_em_scan (3 steps) and fit_sharded with block=2 over a (1, 2)
    mesh of two gloo ranks (15 channels padded to 16) against
    vlgp_tpu.parallel's on the same mesh: the steps at the one-step
    tolerances (atol 1e-12, G G' 1e-9, norms rtol 1e-8; measured ~1e-12),
    the fit at the (1, 2) fit's above (omega 2e-4 relative, a 1e-5, mu
    1e-4, ELBO rtol 1e-6: its first H-step flips the same golden-search
    comparison), the runtime bookkeeping equal."""
    _launch("scan", tmp_dir, 2, "1x2")
    ref = jax_scan((1, 2))
    ranks = _gloo("scan", tmp_dir, 2, "1x2")
    fit = ref["fit"]
    for r in ranks:
        for f in ("mu", "w", "v", "dmu"):
            assert_close(r["scan_seg"][f], np.asarray(getattr(ref["seg"], f)), atol=1e-12,
                         err_msg=f)
        for f in ("a", "b", "noise", "omega", "sigma", "da", "db"):
            assert_close(r["scan_params"][f], np.asarray(getattr(ref["params"], f)),
                         atol=1e-12, err_msg=f)
        assert_close(r["scan_G"] @ r["scan_G"].mT, ref["G"] @ ref["G"].transpose(0, 2, 1),
                     atol=1e-9)
        for k, v in ref["norms"].items():
            assert_close(r["scan_norms"][k], v, atol=1e-15, err_msg=k)
        for key in ("it", "converged_at", "final_hstep"):
            assert r["fit_runtime"][key] == fit.runtime.get(key), key
        assert len(r["seen"]) == len(ref["seen"]) == 2
        assert_close(r["fit_params"]["omega"], np.asarray(fit.params.omega), rtol=2e-4)
        assert np.abs(r["fit_params"]["a"].numpy() - np.asarray(fit.params.a)).max() < 1e-5
        assert np.abs(r["fit_mu"].numpy() - np.asarray(fit.data.mu)).max() < 1e-4
        assert_close(np.array(r["fit_runtime"]["elbo"]), np.array(fit.runtime["elbo"]), rtol=1e-6)
    for f in ranks[0]["fit_params"]:
        assert torch.equal(ranks[0]["fit_params"][f], ranks[1]["fit_params"][f]), f


def test_model_axis_adaptive_exits_agree_bitwise(tmp_dir):
    """Float32 with the adaptive E-step and M-step exits on (estep_tol,
    mstep_tol) and the fused sweep asked for: the two model ranks decide
    every exit alike (the E-step's on the posterior, which the model
    all-reduces give both ranks bit for bit; the M-step's on model-summed
    norms), so they end bit for bit equal with equal collective counts, and
    the fused sweep never runs under a model axis."""
    a, b = (r["adaptive"] for r in _gloo("model", tmp_dir, 2, "1x2"))
    for f in a["params"]:
        assert torch.equal(a["params"][f], b["params"][f]), f
    assert torch.equal(a["mu"], b["mu"]) and torch.equal(a["v"], b["v"])
    assert torch.isfinite(a["mu"]).all() and a["mu"].dtype == torch.float32
    assert a["collectives"] == b["collectives"] and a["it"] == b["it"]
    assert a["collectives"]["all_reduce_model"] > 0
    assert a["sweep_calls"] == b["sweep_calls"] == 0


@pytest.mark.parametrize("lik", ["poisson", "mixed", "gaussian"])
def test_pad_and_trim_channels_match_jax(lik):
    """pad_channels / trim_channels against vlgp_tpu's: zero y, x, a, b, da
    and db, noise 1, the majority family, an active mask, and the model's
    likelihood_kind kept (an all-Poisson model stays "poisson"); the M-step
    on the padded set leaves the real channels bit for bit as on the
    unpadded set and the padded ones exactly zero."""
    import jax.numpy as jnp

    from vlgp_tpu.config import make_params as jparams
    from vlgp_tpu.data import pack_trials as jpack
    from vlgp_tpu.parallel.mesh import pad_channels as jpad, trim_channels as jtrim

    trials, a, _ = pin_trials(ntrial=3, length=60)
    liks = {"poisson": "poisson", "gaussian": "gaussian",
            "mixed": ["poisson"] * 6 + ["gaussian"] * 4}[lik]
    kw = dict(a=a * 0.6, b=np.full((1, 10), -1.5), noise=np.linspace(0.5, 1.5, 10))
    params = make_params(10, 2, 1, liks, dtype=torch.float64, **kw)
    data = pack_trials(trials, 2, 1, dtype=torch.float64)
    jd, jp = jpad(jpack(trials, 2, 1, dtype=np.float64),
                  jparams(10, 2, 1, liks, dtype=jnp.float64, **kw), 4)
    data_p, params_p = pad_channels(data, params, 4)
    assert params_p.likelihood_kind == jp.likelihood_kind == params.likelihood_kind
    for f in ("a", "b", "da", "db", "noise", "poisson", "active"):
        assert np.array_equal(np_of(getattr(params_p, f)), np.asarray(getattr(jp, f))), f
    for f in ("y", "x"):
        assert np.array_equal(np_of(getattr(data_p, f)), np.asarray(getattr(jd, f))), f
    data_t, params_t = trim_channels(data_p, params_p, 10)
    jd_t, jp_t = jtrim(jd, jp, 10)
    assert params_t.active is None and jp_t.active is None
    for f in ("a", "b", "noise", "poisson"):
        assert torch.equal(getattr(params_t, f), getattr(params, f)), f
    assert torch.equal(data_t.y, data.y) and np.array_equal(np_of(data_t.x), np.asarray(jd_t.x))
    assert pad_channels(data, params, 5)[1] is params  # 10 channels split over 5 as they are

    config = vlgp_tpu_torch.default_config(dtype="float64", mstep_tol=0)
    p1 = tv.mstep(data, params, config)
    p2 = tv.mstep(data_p, params_p, config)
    for f in ("a", "b", "noise", "da", "db"):
        assert torch.equal(getattr(p2, f)[..., :10], getattr(p1, f)), f
    for f in ("a", "b", "da", "db"):
        assert torch.all(getattr(p2, f)[..., 10:] == 0), f
    assert torch.all(p2.noise[10:] == 1)


def test_model_axis_refusals():
    """Under a model axis sweep_fused_eligible is false (vlgp_tpu/ops/
    sweep.py:355) and the EM step with constrain_loading="svd" raises, as in
    vlgp_tpu (models/vlgp.py:510-511), here on a gloo model group of one
    rank, whose CUDA collectives a captured step refuses (checked without a
    card); block > 1 runs on the CPU."""
    _, seg, params, G = W.prepared(vlgp_tpu_torch.default_config(dtype="float64"))
    seg32 = seg.replace(**{f: getattr(seg, f).float() for f in ("y", "x", "mu", "w", "v", "dmu")})
    p32 = params.replace(a=params.a.float())
    assert tsw.sweep_fused_eligible(seg32, p32, G.float(), tv.Dist())
    assert not tsw.sweep_fused_eligible(seg32, p32, G.float(), tv.Dist(model=object()))
    svd = vlgp_tpu_torch.default_config(dtype="float64", constrain_loading="svd")
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{W.free_port()}", rank=0,
                             world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        step = make_em_step(svd, tv.Dist(model=tdist.group.WORLD))
        with pytest.raises(NotImplementedError, match="svd"):
            step(seg, params, G)
        # the data axis alone takes the svd constraint
        make_em_step(svd, tv.Dist(data=tdist.group.WORLD))(seg, params, G)
        with pytest.raises(ValueError, match="nccl"):
            check_capturable(vlgp_tpu_torch.default_config(), tv.Dist(model=tdist.group.WORLD),
                             torch.device("cuda"))
    finally:
        tdist.destroy_process_group()
    trials, a = W.workload(ydim=W.YDIM_ODD)
    from vlgp_tpu_torch.parallel.driver import fit_sharded

    # block > 1 runs: on the CPU its steps are the eager ones, bit for bit
    got = fit_sharded(trials, W.ZDIM, device="cpu", block=2, **W.start_kw(a), **W.FIT_KW)
    ref = fit_sharded(trials, W.ZDIM, device="cpu", **W.start_kw(a), **W.FIT_KW)
    assert torch.equal(got.params.a, ref.params.a) and torch.equal(got.data.mu, ref.data.mu)
    assert got.runtime["it"] == ref.runtime["it"] == 4
