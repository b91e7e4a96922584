"""Leave-one-neuron-out in chunks: vlgp_tpu_torch.model_selection's
``batch`` folds each chunk of held-out neurons into the segment axis
(models.vlgp.infer_members / estep_members), on the state of
tests/test_torch_model_selection.py (pin trials, 10 channels, 8 Poisson and
2 Gaussian, ragged lengths), against vlgp_tpu's vmapped chunks in float64
on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vlgp_tpu
from vlgp_tpu import model_selection as jms
from vlgp_tpu_torch import model_selection as tms
from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.ops import control

from _torch_parity import RTOL64, pin_trials, port_result

torch.set_num_threads(1)

YDIM = 10
SUBSET = [7, 2, 9, 0, 4]  # out of order
# float32 on the CPU (the kernels' plain versions), batched against one
# neuron at a time: the sums run in another order and the inverse routes'
# residual checks decide once per chunk.  Measured on this state: 1.4e-5
# relative at batch 10, 2.9e-7 at batch 3 (max_iter 6, every member
# sweeping 6 times); the bound keeps a margin of 7.
RTOL32 = 1e-4


def lono_state(dtype="float64", **config_kw):
    """The same FitResult state in both packages (test_torch_model_selection's)."""
    from vlgp_tpu.config import default_config, make_params
    from vlgp_tpu.data import pack_trials
    from vlgp_tpu.models.gp import make_cholesky
    from vlgp_tpu.models.vlgp import update_v, update_w

    trials, a, _ = pin_trials(ntrial=3, length=90)
    trials[2]["y"], trials[2]["mu"] = trials[2]["y"][:70], trials[2]["mu"][:70]
    config = default_config(dtype=dtype, **{"max_iter": 6, **config_kw})
    params = make_params(YDIM, 2, 1, ["poisson"] * 8 + ["gaussian"] * 2, a=a,
                         b=np.full((1, YDIM), -1.5), noise=np.full(YDIM, 0.8),
                         omega=np.full(2, 1e-2), dtype=getattr(jnp, dtype))
    data = pack_trials(trials, 2, 1, dtype=getattr(np, dtype))
    G = make_cholesky(data.nbin, params)
    data = update_v(update_w(data, params, config), params, G, config)
    jres = vlgp_tpu.FitResult(data=data, params=params, config=config, factor_model=None,
                              G=G, runtime={})
    return jres, port_result(jres)


@pytest.fixture(scope="module")
def f64():
    """The float64 state and vlgp_tpu's scores, all neurons and SUBSET."""
    jres, tres = lono_state()
    refs = {key: jms.leave_one_neuron_out(jres, neurons=neurons, batch=3)
            for key, neurons in (("all", None), ("subset", SUBSET))}
    return tres, refs


def assert_scores(out, ref, rtol):
    assert list(out) == list(ref)
    for k in ref:
        assert np.isclose(out[k], ref[k], rtol=rtol, atol=0.0), (k, out[k], ref[k])


@pytest.mark.parametrize("batch", [1, 3, 4, 10, 12])
def test_chunked_scores_match_jax(f64, batch):
    """Every batch gives vlgp_tpu's scores at rtol 1e-8, for all neurons and
    for a subset out of order, in ceil(k / B) chunks of the request's
    neurons in order, B = min(batch, ydim); the rounds counted in
    control.TRIPS are the chunks' rounds."""
    tres, refs = f64
    B = min(batch, YDIM)
    for key, neurons in (("all", None), ("subset", SUBSET)):
        control.TRIPS["lono_rounds"] = 0
        out = tms.leave_one_neuron_out(tres, neurons=neurons, batch=batch)
        assert_scores(out, refs[key], RTOL64)
        asked = list(range(YDIM)) if neurons is None else neurons
        chunks = tms.LONO_CHUNKS
        assert [c["neurons"] for c in chunks] == [asked[k:k + B]
                                                  for k in range(0, len(asked), B)]
        assert control.TRIPS["lono_rounds"] == sum(c["rounds"] for c in chunks)
        assert all(c["rounds"] == max(c["sweeps"]) for c in chunks)


def test_members_exit_on_their_own_sweep_counts():
    """With estep_tol > 0 and room to stop early (max_iter 25, tol 1e-3),
    the members of one chunk of all 10 neurons stop after different sweep
    counts, each its count alone, and score what they score alone and in
    vlgp_tpu at rtol 1e-8 (an exit on the chunk's norm gives them all the
    same count and moves their scores)."""
    jres, tres = lono_state(max_iter=25, estep_tol=1e-3)
    ref = jms.leave_one_neuron_out(jres, batch=3)
    alone = tms.leave_one_neuron_out(tres, batch=1)
    sweeps_alone = [c["sweeps"][0] for c in tms.LONO_CHUNKS]
    out = tms.leave_one_neuron_out(tres, batch=YDIM)
    (chunk,) = tms.LONO_CHUNKS
    assert len(set(chunk["sweeps"])) > 1, chunk
    assert max(chunk["sweeps"]) < 25
    assert chunk["sweeps"] == sweeps_alone
    assert_scores(out, alone, RTOL64)
    assert_scores(out, ref, RTOL64)


def test_float32_chunks_match_one_at_a_time():
    """float32 on the CPU: chunks of 3 and of all 10 neurons against one
    neuron at a time, within RTOL32."""
    _, tres = lono_state("float32")
    alone = tms.leave_one_neuron_out(tres, batch=1)
    for batch in (3, YDIM):
        assert_scores(tms.leave_one_neuron_out(tres, batch=batch), alone, RTOL32)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("method", ["VB", "MAP"])
def test_one_member_all_channels_equals_estep(dtype, method):
    """estep_members with one member and every channel weight 1 gives
    estep's mu, w, v and dmu bit for bit from the same state, after the
    same sweeps."""
    from vlgp_tpu_torch.config import default_config, make_params
    from vlgp_tpu_torch.data import pack_trials
    from vlgp_tpu_torch.models.gp import make_cholesky

    trials, a, _ = pin_trials(ntrial=3, length=90)
    td = getattr(torch, dtype)
    config = default_config(dtype=dtype, method=method)
    params = make_params(YDIM, 2, 1, ["poisson"] * 8 + ["gaussian"] * 2, a=a,
                         b=np.full((1, YDIM), -1.5), noise=np.full(YDIM, 0.8),
                         omega=np.full(2, 1e-2), dtype=td, device="cpu")
    data = pack_trials(trials, 2, 1, dtype=td, device="cpu")
    G = make_cholesky(data.nbin, params)
    data = tv.update_v(tv.update_w(data, params, config), params, G, config)
    control.TRIPS["estep_sweeps"] = 0
    ref = tv.estep(data, params, G, config)
    state = tuple(getattr(data, f).permute(2, 0, 1) for f in ("mu", "w", "v", "dmu"))
    out, sweeps = tv.estep_members(data, params, G, config, torch.ones(1, YDIM, dtype=td),
                                   state)
    assert sweeps.tolist() == [control.TRIPS["estep_sweeps"]]
    for t, f in zip(out, ("mu", "w", "v", "dmu")):
        assert torch.equal(t.permute(1, 2, 0), getattr(ref, f)), f
