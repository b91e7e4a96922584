"""The plain reference against the program on the CPU in float64, where the
program takes its exact routes, and the reference's imports."""
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT

from reference import vlgp as R

FORBIDDEN = ("jax", "jaxlib", "flax", "vlgp_tpu", "vlgp_tpu_torch")
TOL = 1e-9


@pytest.fixture(scope="module")
def small():
    """A float64 program state on 3 trials x 60 bins x 8 neurons x 2 latents."""
    from vlgp_tpu_torch.config import default_config, make_params
    from vlgp_tpu_torch.data import pack_trials
    from vlgp_tpu_torch.models import gp, vlgp

    N, T, Y, Z = 3, 60, 8, 2
    rng = np.random.default_rng(1)
    a = rng.normal(size=(Z, Y)) * 0.5
    zt = np.stack([np.sin(np.linspace(0, 6 + 2 * i, T)) for i in range(Z)], 1)
    trials = [{"y": rng.poisson(np.exp(zt @ a - 1.0)).astype(float),
               "mu": rng.normal(size=(T, Z)) * 0.1} for _ in range(N)]
    cfg = default_config(dtype="float64", window=20)
    params = make_params(Y, Z, 1, "poisson", a=a, b=np.full((1, Y), -1.0),
                         omega=np.full(Z, 1e-2), dtype=torch.float64)
    data = pack_trials(trials, Z, 1, dtype=torch.float64)
    G = gp.make_cholesky(T, params, rank=20)
    data = vlgp.update_v(vlgp.update_w(data, params, cfg), params, G, cfg)
    s = dict(estep_tol=cfg.estep_tol, dmu_bound=cfg.dmu_bound, eps=cfg.eps,
             mstep_tol=cfg.mstep_tol, Mniter=cfg.Mniter, da_bound=cfg.da_bound,
             db_bound=cfg.db_bound, omega_bound=cfg.omega_bound, gp_noise=1e-4, dt=1.0,
             hyper_iters=cfg.hyper_iters, hyper_grid=cfg.hyper_grid,
             hyper_tiebreak=cfg.hyper_tiebreak, hyper_trust=cfg.hyper_trust,
             hyper_learn_sigma=True, max_iter=cfg.max_iter)
    Gr = R.factor(T, params.omega, params.sigma, 20, 1.0, torch.float64, torch.float64)
    xb = torch.einsum("stxy,xy->sty", data.x, params.b)
    return dict(cfg=cfg, s=s, params=params, data=data, G=G, Gr=Gr, xb=xb, gp=gp, vlgp=vlgp)


def z(t):
    return t.permute(2, 0, 1)


def test_factor_and_first_weights(small):
    d, p = small["data"], small["params"]
    assert float((small["G"] @ small["G"].mT - small["Gr"] @ small["Gr"].mT).abs().max()) < TOL
    w = R.weights(z(d.mu), torch.zeros_like(z(d.mu)), p.a, small["xb"], p.poisson, p.noise,
                  d.mask[None])
    assert float((w - z(d.w)).abs().max()) < TOL
    v = R.marginal_v(small["Gr"], R.inv_gram(small["Gr"], w)) * d.mask[None]
    assert float((v - z(d.v)).abs().max()) < TOL


def test_estep_mstep_hstep(small):
    d, p, cfg, s = small["data"], small["params"], small["cfg"], small["s"]
    V, gp = small["vlgp"], small["gp"]
    d2 = V.estep(d, p, small["G"], cfg)
    (mu, _, v, _), _ = R.estep(d.y, small["xb"], d.mask, p.a, p.poisson, p.noise, small["Gr"],
                               (z(d.mu), z(d.w), z(d.v), z(d.dmu)), s, cfg.Eniter)
    assert float((mu - z(d2.mu)).abs().max()) < TOL and float((v - z(d2.v)).abs().max()) < TOL
    p2 = V.mstep(d2, p, cfg)
    a, b, *_ = R.mstep(d.y, d.x, d.mask, z(d2.mu), z(d2.v), p.a, p.b, p.noise, p.da, p.db, s)
    assert float((a - p2.a).abs().max()) < TOL and float((b - p2.b).abs().max()) < TOL
    p3 = gp.hstep(d2, p2, cfg, rank=20)
    om, sg = R.hstep(z(d2.mu), z(d2.w), d2.mask, p2.omega, p2.sigma, s, 20, torch.float64)
    assert float((om - p3.omega).abs().max() / p3.omega.abs().max()) < 1e-8
    assert float((sg - p3.sigma).abs().max()) < 1e-8


def test_lono_scores(small):
    import vlgp_tpu_torch as V

    d, p, cfg = small["data"], small["params"], small["cfg"]
    res = V.FitResult(data=d, params=p, config=cfg, factor_model=None, G=small["G"],
                      runtime={})
    got = V.model_selection.leave_one_neuron_out(res, batch=3)
    Gfull = R.factor(d.nbin, p.omega, p.sigma, p.rank, 1.0, torch.float64, torch.float64)
    trails, ran = R.lono_scores(d.y, small["xb"], d.mask, p.a, p.poisson, p.noise, Gfull,
                                list(range(p.ydim)), small["s"], cfg.max_iter, members=3,
                                extra=1)
    assert max(abs(got[k] - trails[k][ran[k]]) for k in trails) < 1e-9
    # one sweep past each member's exit, its own sweeps unchanged
    assert all(len(trails[k]) >= min(ran[k] + 2, cfg.max_iter + 1) for k in trails)


def test_extra_sweeps_leave_the_exit_and_its_state(small):
    d, p, cfg, s = small["data"], small["params"], small["cfg"], small["s"]
    args = (d.y, small["xb"], d.mask, p.a, p.poisson, p.noise, small["Gr"],
            (z(d.mu), z(d.w), z(d.v), z(d.dmu)), s, cfg.Eniter)
    (mu, *_), k = R.estep(*args)
    trail = []
    _, k2 = R.estep(*args, extra=1, each=trail.append)
    assert int(k2[0]) == int(k[0]) and len(trail) == min(int(k[0]) + 1, cfg.Eniter)
    assert torch.equal(trail[int(k[0]) - 1][0], mu)


def test_hstep_amplitude_holds_the_program_and_not_a_step_left_out(small):
    """The program's sigma in float64 is the reference's profile amplitude at
    the program's omega; the input sigma, an H-step left out, is not."""
    import checks

    d, p, cfg, s = small["data"], small["params"], small["cfg"], small["s"]
    V, gp = small["vlgp"], small["gp"]
    d2 = V.estep(d, p, small["G"], cfg)
    p3 = gp.hstep(d2, p, cfg, rank=20)
    om, sg, C, nseg = R.hstep(z(d2.mu), z(d2.w), d2.mask, p.omega, p.sigma, s, 20,
                              torch.float64, stat=True)
    truth = dict(omega=om, sigma=sg, C=C, nseg=nseg, gp_noise=s["gp_noise"], dt=s["dt"])
    assert checks.hstep_amplitude(p3.omega, p3.sigma, truth) < 1e-10
    assert checks.hstep_amplitude(p.omega, p.sigma, truth) > 1e-2


def test_cut_and_scatter_match_the_program():
    from vlgp_tpu_torch.data import cut_trials, pack_trials

    rng = np.random.default_rng(3)
    trials = [{"y": rng.poisson(1.0, size=(57, 4)).astype(float)} for _ in range(3)]
    data = pack_trials(trials, 2, 1, dtype=torch.float64)
    seg = cut_trials(data, 20, seed=7)
    idx, start = R.cut(np.full(3, 57), 20, 7)
    assert np.array_equal(idx, seg.trial_idx.numpy()) and np.array_equal(start, seg.start.numpy())
    y = R.gather(data.y, idx, start, 20)
    assert torch.equal(y, seg.y)
    back = R.scatter(torch.zeros_like(data.y), y, idx, start)
    assert torch.equal(back, data.y)


def test_reference_imports_nothing_of_the_program():
    """Compared by the top-level name, taken whole before the first dot."""
    code = ("import sys; sys.path.insert(0, %r); import checks, reference.vlgp; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r); "
            "print(bad); sys.exit(1 if bad else 0)") % (str(BENCH), FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stdout + out.stderr
