"""vlgp_tpu_torch.transform against vlgp_tpu.transform: new trials under
fitted parameters, in float64 on the CPU, on the regression-pin workload
(4 trials x 120 bins x 10 neurons x 2 latents)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vlgp_tpu
import vlgp_tpu_torch
from vlgp_tpu.init import FactorModel as JaxFactorModel
from vlgp_tpu_torch.init import FactorModel

from _torch_parity import RTOL64, assert_close, pin_state, pin_trials, port_config, port_params

torch.set_num_threads(1)


def _factor_models(seed=3):
    """One factor model in both packages: the same mean, a and psi."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.1, 0.5, size=10)
    a = rng.normal(size=(2, 10)) * 0.5
    psi = rng.uniform(0.5, 1.5, size=10)
    jfm = JaxFactorModel(mean=jnp.asarray(mean), a=jnp.asarray(a), psi=jnp.asarray(psi))
    tfm = FactorModel(mean=torch.tensor(mean), a=torch.tensor(a), psi=torch.tensor(psi))
    return jfm, tfm


@pytest.mark.parametrize("given", ["params", "factor_model", "fit_result"])
def test_transform_f64_matches_jax(given):
    """Bare Params with the trials' own mu; a factor model filling the mu of
    every trial (one trial keeps its own); a FitResult supplying params,
    config and factor model.  Every posterior field at rtol 1e-8."""
    (_, jparams, _, jconfig), _ = pin_state("float64")
    params, config = port_params(jparams), port_config(jconfig)
    trials, _, _ = pin_trials(seed=11, ntrial=3, length=90)
    if given == "params":
        jout = vlgp_tpu.transform(trials, jparams, jconfig)
        tout = vlgp_tpu_torch.transform(trials, params, config, device="cpu")
    else:
        for t in trials[1:]:
            del t["mu"]
        jfm, tfm = _factor_models()
        if given == "factor_model":
            jout = vlgp_tpu.transform(trials, jparams, jconfig, factor_model=jfm)
            tout = vlgp_tpu_torch.transform(trials, params, config, factor_model=tfm,
                                            device="cpu")
        else:
            jres = vlgp_tpu.FitResult(data=None, params=jparams, config=jconfig,
                                      factor_model=jfm, G=None, runtime={})
            tres = vlgp_tpu_torch.FitResult(data=None, params=params, config=config,
                                            factor_model=tfm, G=None, runtime={})
            jout = vlgp_tpu.transform(trials, jres)
            tout = vlgp_tpu_torch.transform(trials, tres, device="cpu")
    assert len(tout) == len(trials)
    for i, (jt, tt) in enumerate(zip(jout, tout)):
        assert tt["mu"].shape == (90, 2) and tt["mu"].dtype == np.float64
        for name in ("mu", "w", "v"):
            # rtol 1e-8, and 1e-8 of the field's largest entry near zero
            # crossings (the two packages sum in another order)
            scale = np.abs(np.asarray(jt[name])).max()
            assert_close(tt[name], jt[name], rtol=RTOL64, atol=RTOL64 * scale,
                         err_msg=f"trial {i} {name}")


def test_transform_without_device_needs_cuda(monkeypatch):
    """transform runs on the card unless the caller asks for the CPU: with no
    CUDA device it raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (_, params, _, config) = pin_state("float64")
    trials, _, _ = pin_trials(ntrial=1, length=60)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vlgp_tpu_torch.transform(trials, params, config)
