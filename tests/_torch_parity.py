"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Builds the regression-pin workload (4 trials x 120 bins x 10 neurons x
2 latents) from a NumPy seed and hands the same state to ``vlgp_tpu``
and ``vlgp_tpu_torch`` as NumPy arrays, through
``vlgp_tpu_torch.utils.convert``.
"""
import dataclasses

import numpy as np
import torch

from vlgp_tpu_torch.utils.convert import (factor_model_from_numpy, fit_result_from_numpy,
                                          params_from_numpy, trialset_from_numpy)

# f64 phase parity: both packages run the exact LAPACK route and differ
# only in the order of their sums
RTOL64 = 1e-8


def pin_trials(seed=7, ntrial=4, length=120):
    """The workload of tests/test_regression_pin.py, plus the true latents."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(2, 10)) * 0.5
    trials, zs = [], []
    for _ in range(ntrial):
        z = np.column_stack((np.sin(np.linspace(0, 6, length)),
                             np.cos(np.linspace(0, 6, length))))
        trials.append({"y": rng.poisson(np.exp(z @ a - 1.5)).astype(float),
                       "mu": rng.normal(size=(length, 2)) * 0.1})
        zs.append(z)
    return trials, a, np.concatenate(zs)


def to_np(obj) -> dict:
    """A vlgp_tpu pytree dataclass (Params, TrialSet) as a dict of arrays."""
    return {f.name: (None if getattr(obj, f.name) is None else np.asarray(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def port_params(jparams):
    arrays = to_np(jparams)
    static = {k: arrays.pop(k) for k in ("gp_noise", "dt", "rank", "likelihood_kind")}
    static = {k: (v.item() if isinstance(v, np.ndarray) else v) for k, v in static.items()}
    return params_from_numpy(arrays, **static)


def port_data(jdata):
    return trialset_from_numpy(to_np(jdata))


def port_result(jres):
    """A vlgp_tpu FitResult's state (data, params, G, config) in the port."""
    return fit_result_from_numpy(to_np(jres.data), to_np(jres.params), np.asarray(jres.G),
                                 dataclasses.asdict(jres.config))


def factor_models(seed=3, ydim=10, zdim=2):
    """One factor model in both packages: the same mean, a and psi."""
    import jax.numpy as jnp

    from vlgp_tpu.init import FactorModel as JaxFactorModel

    rng = np.random.default_rng(seed)
    arrays = {"mean": rng.uniform(0.1, 0.5, size=ydim),
              "a": rng.normal(size=(zdim, ydim)) * 0.5,
              "psi": rng.uniform(0.5, 1.5, size=ydim)}
    jfm = JaxFactorModel(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jfm, factor_model_from_numpy(arrays)


def port_config(jconfig):
    from vlgp_tpu_torch.config import Config

    return Config(**dataclasses.asdict(jconfig))


def np_of(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_close(port, ref, rtol=RTOL64, atol=0.0, err_msg=""):
    np.testing.assert_allclose(np_of(port), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def r2_aligned(mu, zt):
    X = np.column_stack([mu, np.ones(len(mu))])
    beta, *_ = np.linalg.lstsq(X, zt, rcond=None)
    return float(1 - np.sum((X @ beta - zt) ** 2) / np.sum((zt - zt.mean(0)) ** 2))


def pin_state(dtype="float64", **config_kw):
    """The pin workload prepared as tests/test_regression_pin.py:_setup
    does, in both packages: (jax (seg, params, G, config), port (...))."""
    import jax.numpy as jnp

    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import cut_trials, pack_trials
    from vlgp_tpu.models.gp import make_cholesky
    from vlgp_tpu.models.vlgp import update_w

    trials, a, _ = pin_trials()
    config = default_config(dtype=dtype, **config_kw)
    np_dtype = np.dtype(dtype)
    params = make_params(10, 2, 1, "poisson", a=a, b=np.full((1, 10), -1.5),
                         omega=np.full(2, 1e-2), dtype=jnp.dtype(dtype))
    data = pack_trials(trials, 2, 1, dtype=np_dtype)
    seg = cut_trials(data, config.window, seed=0)
    G = make_cholesky(seg.nbin, params)
    seg = update_w(seg, params, config)
    port = (port_data(seg), port_params(params), torch.tensor(np.asarray(G)),
            port_config(config))
    return (seg, params, G, config), port


def jax_scan(shape):
    """vlgp_tpu.parallel's side of tests/_torch_dist_worker.py's ``scan``
    case on a ``shape`` (data, model) mesh of the virtual CPU devices:
    sharded_em_scan of 3 steps from the prepared state (15 channels padded
    to the model axis where it has one), then fit_sharded with block=2,
    ELBO tracking and a recording callback."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import cut_trials, pack_trials
    from vlgp_tpu.models.gp import effective_rank, make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w
    from vlgp_tpu.parallel import make_mesh, pad_segments, replicate, shard_data
    from vlgp_tpu.parallel.driver import fit_sharded
    from vlgp_tpu.parallel.spmd import sharded_em_scan
    from vlgp_tpu.parallel.mesh import _put, pad_channels, to_host

    import _torch_dist_worker as W

    mesh = make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    ydim = W.YDIM if shape[1] == 1 else W.YDIM_ODD
    config = default_config(**W.FIT_KW)
    trials, a = W.workload(ydim=ydim)
    kw = W.start_kw(a)
    params = make_params(ydim, W.ZDIM, 1, "poisson", a=kw["a"], b=kw["b"], noise=kw["noise"],
                         omega=np.full(W.ZDIM, 1e-2), dtype=jnp.float64)
    data = pack_trials(trials, W.ZDIM, 1, dtype=np.float64)
    data, params = pad_channels(data, params, shape[1])
    G_full = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G_full, config)
    seg = cut_trials(data, config.window, seed=0)
    rank = min(params.rank, effective_rank(seg.nbin, config.omega_bound[1], params.dt))
    G = make_cholesky(seg.nbin, params, rank=rank)
    seg_s = shard_data(pad_segments(seg, shape[0]), mesh)
    params_r, G_r = replicate((params, G), mesh)
    xinv = _put(np.zeros((W.ZDIM, seg_s.ntrial, rank, rank)), mesh, P(None, "data", None, None))
    seg_o, p_o, G_o, _, norms = sharded_em_scan(mesh, config, seg_s, params_r, 3)(
        seg_s, params_r, G_r, xinv, 0)
    seen = []
    res = fit_sharded(trials, W.ZDIM, mesh=mesh, block=2, track_elbo=True,
                      callbacks=[lambda d, p, c: seen.append(p)], **kw, **W.FIT_KW)
    return dict(seg=to_host(seg_o), params=to_host(p_o), G=np.asarray(G_o),
                norms={k: np.asarray(v) for k, v in norms.items()}, n_seg=seg.ntrial,
                fit=res, seen=seen)
