"""vlgp_tpu_torch.parallel, the data axis on torch.distributed: the world of
one in process against the port's fit, and two gloo ranks on the CPU
(tests/_torch_dist_worker.py, two processes per case) against
vlgp_tpu.parallel on a (2, 1) mesh of the virtual CPU devices."""
import datetime
import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import jax

import vlgp_tpu_torch
from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.parallel import (DIST, data_specs, gather, make_mesh, pad_segments,
                                     params_specs, replicate, shard_data)
from vlgp_tpu_torch.parallel.driver import fit_sharded

import _torch_dist_worker as W
from _torch_parity import assert_close, jax_scan, np_of, pin_trials

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _launch(case: str, tmp: str):
    """Start both ranks of one worker case (once per case and module), each
    a process of its own."""
    return W.launch(case, tmp)


@functools.lru_cache(maxsize=None)
def _gloo(case: str, tmp: str):
    """Both ranks' results of one worker case."""
    return W.collect(_launch(case, tmp), case, tmp)


@pytest.fixture(scope="module")
def tmp_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("gloo"))


@functools.lru_cache(maxsize=None)
def _jax_parity():
    """vlgp_tpu.parallel's side of the parity case on a (2, 1) mesh."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import cut_trials, pack_trials
    from vlgp_tpu.models.gp import effective_rank, make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w
    from vlgp_tpu.parallel import (make_mesh as jmesh, pad_segments as jpad,
                                   replicate as jrep, shard_data as jshard,
                                   sharded_em_step, sharded_infer)
    from vlgp_tpu.parallel.driver import fit_sharded as jfit_sharded
    from vlgp_tpu.parallel.mesh import _put, to_host

    mesh = jmesh((2, 1), devices=jax.devices()[:2])
    config = default_config(**W.FIT_KW)
    trials, a = W.workload()
    kw = W.start_kw(a)
    params = make_params(W.YDIM, W.ZDIM, 1, "poisson", a=kw["a"], b=kw["b"],
                         noise=kw["noise"], omega=np.full(W.ZDIM, 1e-2), dtype=jnp.float64)
    data = pack_trials(trials, W.ZDIM, 1, dtype=np.float64)
    G_full = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G_full, config)
    seg = cut_trials(data, config.window, seed=0)
    rank = min(params.rank, effective_rank(seg.nbin, config.omega_bound[1], params.dt))
    G = make_cholesky(seg.nbin, params, rank=rank)
    seg_s = jshard(jpad(seg, 2), mesh)
    params_r, G_r = jrep((params, G), mesh)
    xinv = _put(np.zeros((W.ZDIM, seg_s.ntrial, rank, rank)), mesh, P(None, "data", None, None))
    seg_o, p_o, G_o, norms, _ = sharded_em_step(mesh, config, seg_s, params_r)(
        seg_s, params_r, G_r, xinv, 0)
    data_s = jshard(jpad(data, 2), mesh)
    Gf_r = jrep(G_full, mesh)
    inf = sharded_infer(mesh, config, data_s, params_r)(data_s, params_r, Gf_r)

    seen = []
    res = jfit_sharded(trials, W.ZDIM, mesh=mesh, track_elbo=True,
                       callbacks=[lambda d, p, c: seen.append(p)], **kw, **W.FIT_KW)
    return dict(seg=to_host(seg_o), params=to_host(p_o), G=np.asarray(G_o),
                norms={k: float(v) for k, v in norms.items()}, infer=to_host(inf),
                n_seg=seg.ntrial, fit=res, seen=seen)


def _fit_kw():
    """The pin workload, every start given; the norms test passes at
    iteration 4 (min_iter), which skips its H-step: a closing H-step runs."""
    trials, a, _ = pin_trials()
    return trials, dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), dtype="float64",
                        max_iter=8, tol=5e-3, min_iter=4)


@pytest.mark.parametrize("group", ["none", "gloo_world1"])
def test_world1_fit_sharded_matches_fit(group):
    """A world of one (no process group, and a gloo group of one rank whose
    all_reduces run): fit_sharded's EM trajectory equals fit's bit for bit
    at every iteration boundary (a recording callback), and so does
    converged_at; the final result at rtol 1e-8 (the closing H-step runs
    without the inverse carry, see fit_sharded)."""
    trials, kw = _fit_kw()
    seen = {"fit": [], "sharded": []}

    def record(name):
        return lambda d, p, c: seen[name].append((d.mu.clone(), p))

    ref = vlgp_tpu_torch.fit(trials, 2, device="cpu", callbacks=[record("fit")], **kw)
    if group == "gloo_world1":
        tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{W.free_port()}",
                                 rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        for k in tv.COLLECTIVES:
            tv.COLLECTIVES[k] = 0
        got = fit_sharded(trials, 2, device="cpu", callbacks=[record("sharded")], **kw)
        counts = dict(tv.COLLECTIVES)
    finally:
        if group == "gloo_world1":
            tdist.destroy_process_group()
    assert (counts["all_reduce"] > 0) == (group == "gloo_world1")
    assert len(seen["fit"]) == len(seen["sharded"]) == ref.runtime["it"] == got.runtime["it"]
    assert ref.runtime.get("converged_at") == got.runtime.get("converged_at") is not None
    assert ref.runtime.get("final_hstep") == got.runtime.get("final_hstep")
    for (mu_f, p_f), (mu_s, p_s) in zip(seen["fit"], seen["sharded"]):
        assert torch.equal(mu_f, mu_s)
        for name in ("a", "b", "noise", "sigma", "omega", "da", "db"):
            assert torch.equal(getattr(p_f, name), getattr(p_s, name)), name
    for name in ("a", "b", "omega", "sigma"):
        assert_close(getattr(got.params, name), np_of(getattr(ref.params, name)), err_msg=name)
    assert_close(got.data.mu, np_of(ref.data.mu), atol=1e-12)


def test_two_ranks_em_step_and_infer_match_jax(tmp_dir):
    """One sharded_em_step (its H-step included) and one sharded_infer over
    two gloo ranks against vlgp_tpu.parallel on a (2, 1) mesh, float64, from
    the same state; 15 segments, padded to 16, and 5 trials padded to 6."""
    _launch("parity", tmp_dir)  # the ranks run while vlgp_tpu computes its side
    ref = _jax_parity()
    ranks = _gloo("parity", tmp_dir)
    for r in ranks:
        n = ref["n_seg"]
        for f in ("mu", "w", "v", "dmu"):
            assert_close(r["step_seg"][f][:n], np.asarray(ref["seg"].__dict__[f])[:n],
                         atol=1e-12, err_msg=f)
            assert np.all(r["step_seg"][f][n:].numpy() == 0), f  # padded rows stay inert
        for f in ("a", "b", "noise", "omega", "sigma", "da", "db"):
            assert_close(r["step_params"][f], np.asarray(getattr(ref["params"], f)),
                         atol=1e-12, err_msg=f)
        # G is the Nystrom factor at the new omega: its landmark Cholesky
        # (jitter 2e-5, condition ~1e5) turns omega's rounding-level gap into
        # ~5e-11 on entries of order 1
        assert_close(r["step_G"], ref["G"], atol=1e-9)
        # squared norms; dmu's after 25 sweeps is rounding noise (~5e-23)
        for k, v in ref["norms"].items():
            assert_close(r["step_norms"][k], v, atol=1e-15, err_msg=k)
        assert r["xinv_shape"][1] == 8  # the carry is per rank: (Z, S / 2, R, R)
        for f in ("mu", "w", "v", "dmu"):
            assert_close(r["infer"][f][:5], np.asarray(ref["infer"].__dict__[f])[:5],
                         atol=1e-12, err_msg=f)
    for f in ranks[0]["step_params"]:
        assert torch.equal(ranks[0]["step_params"][f], ranks[1]["step_params"][f]), f


def test_two_ranks_fit_sharded_matches_jax(tmp_dir):
    """fit_sharded over two gloo ranks against vlgp_tpu's on a (2, 1) mesh:
    4 EM iterations at hyper_interval 2, so both run the closing H-step, at
    the JAX test's own tolerances (a 1e-6, omega 1e-8, mu 1e-6;
    tests/test_fit_sharded.py:45-55 gives the reason)."""
    ranks = _gloo("parity", tmp_dir)
    ref = _jax_parity()["fit"]
    assert ref.runtime.get("final_hstep") is True
    for r in ranks:
        assert r["final_hstep"] is True and r["fit_runtime"]["it"] == ref.runtime["it"]
        assert np.abs(r["fit_params"]["a"].numpy() - np.asarray(ref.params.a)).max() < 1e-6
        assert np.abs(r["fit_params"]["omega"].numpy()
                      - np.asarray(ref.params.omega)).max() < 1e-8
        assert np.abs(r["fit_mu"].numpy() - np.asarray(ref.data.mu)).max() < 1e-6
    assert torch.equal(ranks[0]["fit_mu"], ranks[1]["fit_mu"])


def test_two_ranks_boundary_work(tmp_dir):
    """ELBO tracking and callbacks see the gathered real segments (15, not the
    16 padded rows), on both ranks: the ELBO series equals vlgp_tpu's (which
    scores its real segments too) at rtol 1e-8, and so do the callbacks'
    params; path= writes the snapshot from rank 0 only."""
    ranks = _gloo("parity", tmp_dir)
    ref = _jax_parity()
    fit = ref["fit"]
    for r in ranks:
        assert_close(np.array(r["fit_runtime"]["elbo"]), np.array(fit.runtime["elbo"]))
        assert [n for n, _ in r["seen"]] == [ref["n_seg"]] * fit.runtime["it"]
        for (_, p), jp in zip(r["seen"], ref["seen"]):
            assert np.abs(p["a"].numpy() - np.asarray(jp.a)).max() < 1e-6
            assert np.abs(p["omega"].numpy() - np.asarray(jp.omega)).max() < 1e-8
    # a snapshot per EM iteration (saving_interval=0) and the final one
    assert ranks[0]["saves"] == fit.runtime["it"] + 1 and ranks[1]["saves"] == 0
    assert os.path.exists(os.path.join(tmp_dir, "snap.npz"))


def test_two_ranks_em_scan_and_block_fit_match_jax(tmp_dir):
    """sharded_em_scan (3 steps, norms stacked per step) and fit_sharded
    with block=2 over two gloo ranks against vlgp_tpu.parallel on a (2, 1)
    mesh, float64, from the same state: the steps at the one-step
    tolerances above (atol 1e-12, G 1e-9, norms rtol 1e-8), the fit at the
    fit's (a 1e-6, omega 1e-8, mu 1e-6), the per-block ELBO at rtol 1e-8 and
    the runtime bookkeeping equal.  The port's norms come back after xinv,
    in vlgp_tpu's order."""
    _launch("scan", tmp_dir)
    ref = jax_scan((2, 1))
    ranks = _gloo("scan", tmp_dir)
    fit = ref["fit"]
    n = ref["n_seg"]
    for r in ranks:
        for f in ("mu", "w", "v", "dmu"):
            assert_close(r["scan_seg"][f][:n], np.asarray(getattr(ref["seg"], f))[:n],
                         atol=1e-12, err_msg=f)
        for f in ("a", "b", "noise", "omega", "sigma", "da", "db"):
            assert_close(r["scan_params"][f], np.asarray(getattr(ref["params"], f)),
                         atol=1e-12, err_msg=f)
        assert_close(r["scan_G"], ref["G"], atol=1e-9)
        for k, v in ref["norms"].items():
            assert r["scan_norms"][k].shape == (3,)
            assert_close(r["scan_norms"][k], v, atol=1e-15, err_msg=k)
        assert r["xinv_shape"][1] == 8
        for key in ("it", "converged_at", "final_hstep"):
            assert r["fit_runtime"][key] == fit.runtime.get(key), key
        assert len(r["seen"]) == len(ref["seen"]) == 2  # one per block
        assert np.abs(r["fit_params"]["a"].numpy() - np.asarray(fit.params.a)).max() < 1e-6
        assert np.abs(r["fit_params"]["omega"].numpy()
                      - np.asarray(fit.params.omega)).max() < 1e-8
        assert np.abs(r["fit_mu"].numpy() - np.asarray(fit.data.mu)).max() < 1e-6
        assert_close(np.array(r["fit_runtime"]["elbo"]), np.array(fit.runtime["elbo"]))
    assert torch.equal(ranks[0]["fit_mu"], ranks[1]["fit_mu"])


@pytest.mark.parametrize("name", ["f64", "f32_fused"])
def test_two_ranks_adaptive_exits_agree_bitwise(tmp_dir, name):
    """With the adaptive E/M exits and the grid stage on, each branch that
    holds a collective decides on reduced values, so both ranks take the
    same branches: bitwise-equal params and posterior, equal collective
    counts.  f32_fused runs the fused sweep (its residual maxed over the
    ranks) on every EM iteration."""
    ranks = _gloo("adaptive", tmp_dir)
    r0, r1 = ranks[0][name], ranks[1][name]
    for f in r0["params"]:
        assert torch.equal(r0["params"][f], r1["params"][f]), f
    assert torch.equal(r0["mu"], r1["mu"]) and torch.equal(r0["v"], r1["v"])
    assert torch.isfinite(r0["mu"]).all()
    assert r0["collectives"] == r1["collectives"] and r0["collectives"]["all_reduce"] > 0
    assert r0["it"] == r1["it"]
    assert (r0["sweep_calls"] > 0) == (name == "f32_fused")


def test_mesh_contract_world1():
    """The sharding contract splits every field over the axes vlgp_tpu's
    does, dimension by dimension; a world of one pads, shards, gathers and
    replicates as identities (values)."""
    from vlgp_tpu.parallel import mesh as jmesh

    from vlgp_tpu_torch.config import make_params
    from vlgp_tpu_torch.data import pack_trials

    trials, a, _ = pin_trials(ntrial=3, length=60)
    data = pack_trials(trials, 2, 1, dtype=torch.float64)
    params = make_params(10, 2, 1, "poisson", a=a, dtype=torch.float64)
    assert set(data_specs(data)) == set(jmesh.TRIALSET_SPEC_FIELDS)
    assert set(params_specs(params)) == set(jmesh.PARAMS_SPEC_FIELDS)
    for f, spec in data_specs(data).items():
        assert spec == tuple(jmesh.TRIALSET_SPEC_FIELDS[f]), f
    for f, spec in params_specs(params).items():
        assert spec == tuple(jmesh.PARAMS_SPEC_FIELDS[f]), f
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.group) == ((1, 1), 0, None)
    assert mesh.dist(DIST) == tv.Dist()
    padded = pad_segments(data, 2)
    assert padded.ntrial == 4 and torch.all(padded.mask[3] == 0) and torch.all(padded.y[3] == 0)
    shard = shard_data(padded, mesh)
    back = gather(shard, mesh)
    assert all(torch.equal(getattr(back, f), getattr(padded, f)) for f in data_specs(data))
    assert replicate((params, None), mesh)[0] is params


def test_entry_points_refuse():
    """block > 1 runs (on the CPU, eagerly) and repeats block=1's fit bit
    for bit; a mesh shape must cover the ranks, and the svd loading
    constraint under a model axis raises, as in vlgp_tpu
    (models/vlgp.py:510-511)."""
    trials, kw = _fit_kw()
    got = fit_sharded(trials, 2, device="cpu", block=2, **kw)
    ref = fit_sharded(trials, 2, device="cpu", **kw)
    assert torch.equal(got.params.omega, ref.params.omega) and torch.equal(got.data.mu,
                                                                           ref.data.mu)
    # the norms test passes at iteration 4, the end of the second block
    assert got.runtime["converged_at"] == ref.runtime["converged_at"] == got.runtime["it"] == 4
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((1, 2), device="cpu")  # a world of one
    config = vlgp_tpu_torch.default_config(dtype="float64", constrain_loading="svd")
    _, seg, params, _ = W.prepared(config)
    with pytest.raises(NotImplementedError, match="svd"):
        tv.constrain_loading(seg, params, config, dist=tv.Dist(model=object()))


def test_fit_sharded_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trials, kw = _fit_kw()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_sharded(trials, 2, **kw)


def test_initialize_distributed_backend(monkeypatch):
    """nccl unless the caller names a backend; the keywords pass through."""
    from vlgp_tpu_torch.parallel import driver

    seen = []
    monkeypatch.setattr(driver.tdist, "init_process_group", lambda **kw: seen.append(kw))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    driver.initialize_distributed(init_method="tcp://127.0.0.1:1", rank=0, world_size=1)
    driver.initialize_distributed(backend="gloo")
    assert seen == [dict(backend="nccl", init_method="tcp://127.0.0.1:1", rank=0, world_size=1),
                    dict(backend="gloo")]
