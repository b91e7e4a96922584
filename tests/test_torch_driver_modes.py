"""The fused and block EM drivers of vlgp_tpu_torch (``fit(fused=True)``,
``fit(block=k)``) on the CPU, against vlgp_tpu's drivers and against the
port's own eager fit, in float64 on the regression-pin workload
(tests/_torch_parity.py; every start given, so both packages begin from
the same state).  Mirrors tests/test_modes.py:184-320.

On the CPU the drivers run the EM step eagerly (``models.driver._EagerSteps``),
so ``fused=True`` repeats the eager fit bit for bit.  Against vlgp_tpu the
params and the posterior agree to 1e-10 relative: both run the same exact
float64 routes and differ only in the order of their sums (measured gaps
~1e-12 after 7 iterations).
"""
import datetime
import functools

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import vlgp_tpu
import vlgp_tpu_torch
from vlgp_tpu_torch.models import driver as tdriver
from vlgp_tpu_torch.ops import control

from _torch_dist_worker import free_port
from _torch_parity import np_of, pin_trials

torch.set_num_threads(1)

RTOL = 1e-10
# default hyper_interval=2, so every block=3 case crosses the cadence at
# block boundaries (blocks start at iterations 0, 3, 6)
CASES = {
    # 7 iterations, ELBO per iteration
    "fused": dict(fused=True, max_iter=7, track_elbo=True),
    # blocks of 3, 3 and a tail of 1; ELBO per block
    "block3": dict(block=3, max_iter=7, track_elbo=True),
    # tol=10 passes the norms test at min_iter=4, mid-block: converged_at 4
    # while it counts the block through 6, which skips its H-step, so the
    # closing H-step runs
    "block3_converged": dict(block=3, max_iter=7, min_iter=4, tol=10.0),
}


def _kw(a, **extra):
    return {**dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), dtype="float64",
                   min_iter=2), **extra}


@functools.lru_cache(maxsize=None)
def _fits(case):
    trials, a, _ = pin_trials()
    kw = _kw(a, **CASES[case])
    return (vlgp_tpu.fit(trials, 2, **kw),
            vlgp_tpu_torch.fit(trials, 2, device="cpu", **kw))


def _rel(port, ref):
    ref = np.asarray(ref)
    return float(np.max(np.abs(np_of(port) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("case", list(CASES))
def test_driver_mode_matches_jax(case):
    """Params and posterior at 1e-10 relative, and the runtime bookkeeping
    equal: it, converged_at, one em_elapsed per iteration, final_hstep and
    the length of the ELBO record."""
    jr, tr = _fits(case)
    for name in ("a", "b", "noise", "omega", "sigma"):
        assert _rel(getattr(tr.params, name), getattr(jr.params, name)) < RTOL, name
    for name in ("mu", "v"):
        assert _rel(getattr(tr.data, name), getattr(jr.data, name)) < RTOL, name
    for key in ("it", "converged_at", "final_hstep"):
        assert tr.runtime.get(key) == jr.runtime.get(key), key
    assert len(tr.runtime["em_elapsed"]) == len(jr.runtime["em_elapsed"]) == tr.runtime["it"]
    assert tr.runtime["e_elapsed"] == tr.runtime["m_elapsed"] == []
    if "elbo" in jr.runtime:
        assert len(tr.runtime["elbo"]) == len(jr.runtime["elbo"])
        np.testing.assert_allclose(tr.runtime["elbo"], jr.runtime["elbo"], rtol=RTOL)
    if case == "block3_converged":
        assert tr.runtime["converged_at"] == 4 and tr.runtime["it"] == 6
        assert tr.runtime["final_hstep"] is True
    if case == "block3":
        assert len(tr.runtime["elbo"]) == 3  # blocks of 3, 3 and 1


@pytest.mark.parametrize("mode", [dict(fused=True), dict(block=3)])
def test_driver_mode_repeats_eager_fit_bit_for_bit(mode):
    """On the CPU the fused and block drivers run the eager step: the fit
    equals the port's eager fit bit for bit, callbacks see the same states
    at their boundaries, and runtime["counts"] equals the host counters'
    growth over the eager EM loop."""
    trials, a, _ = pin_trials()
    kw = _kw(a, max_iter=6)
    seen = {"eager": [], "mode": []}

    def record(name):
        return lambda d, p, c: seen[name].append((d.mu.clone(), p.a.clone()))

    ref = vlgp_tpu_torch.fit(trials, 2, device="cpu", callbacks=[record("eager")], **kw)
    got = vlgp_tpu_torch.fit(trials, 2, device="cpu", callbacks=[record("mode")], **mode, **kw)
    for name in ("a", "b", "noise", "omega", "sigma"):
        assert torch.equal(getattr(got.params, name), getattr(ref.params, name)), name
    for name in ("mu", "v", "w"):
        assert torch.equal(getattr(got.data, name), getattr(ref.data, name)), name
    assert got.runtime["final_hstep"] is ref.runtime["final_hstep"] is True
    step = 3 if "block" in mode else 1
    assert len(seen["mode"]) == len(seen["eager"]) // step
    for (mu, a_), (mu_ref, a_ref) in zip(seen["mode"], seen["eager"][step - 1::step]):
        assert torch.equal(mu, mu_ref) and torch.equal(a_, a_ref)
    counts = got.runtime["counts"]
    assert set(counts) == set(control.TRIPS) | set(tdriver.spd.FALLBACKS)
    assert counts == ref.runtime["counts"]
    assert counts["estep_sweeps"] > 6 and counts["mstep_iters"] > 6


def test_block_driver_hyper_interval_across_boundaries():
    """hyper_interval=3 with block=2: the H-step runs at iterations 0 and 3,
    which fall at the start and in the middle of blocks; the fit equals the
    eager fit bit for bit and the step-level cadence of vlgp_tpu's driver."""
    trials, a, _ = pin_trials()
    kw = _kw(a, max_iter=5, hyper_interval=3)
    ref = vlgp_tpu_torch.fit(trials, 2, device="cpu", **kw)
    got = vlgp_tpu_torch.fit(trials, 2, device="cpu", block=2, **kw)
    assert torch.equal(got.params.omega, ref.params.omega)
    assert torch.equal(got.data.mu, ref.data.mu)
    # 5 iterations end on iteration 4, which skipped its H-step
    assert got.runtime["final_hstep"] is ref.runtime["final_hstep"] is True
    assert got.runtime["it"] == 5 and len(got.runtime["em_elapsed"]) == 5


def test_capture_refusals_are_checked_before_the_fit():
    """On a CUDA device a step that cannot be captured raises before any
    work: a gloo group (its CUDA collectives read the host).  The svd
    loading constraint passes the check: on the card it runs the
    svd_loading kernel, which reads nothing back (ops/linalg.py).  The
    checks need no card; on the CPU the same configurations run."""
    svd = vlgp_tpu_torch.default_config(constrain_loading="svd")
    tdriver.check_capturable(svd, tdriver.Dist(), torch.device("cuda"))
    tdriver.check_capturable(svd, tdriver.Dist(), torch.device("cpu"))
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                             world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="nccl"):
            tdriver.check_capturable(svd, tdriver.Dist(data=tdist.group.WORLD),
                                     torch.device("cuda"))
    finally:
        tdist.destroy_process_group()
    trials, a, _ = pin_trials(ntrial=1, length=60)
    res = vlgp_tpu_torch.fit(trials, 2, device="cpu", fused=True,
                             **_kw(a, max_iter=2, constrain_loading="svd"))
    assert np.isfinite(np_of(res.data.mu)).all()
