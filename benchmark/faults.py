"""Faults planted in the program's timed path, each of which a cell's check
must turn into ``correct: false``: the CPU tests plant them at a tiny size
(``tests/test_bench_harness.py``) and ``control.py --faults`` reads them at a
cell's own size.  Each takes ``patch(obj, name, value)``, which replaces an
attribute for the fault's life (pytest's ``monkeypatch.setattr``).  They
patch the eager driver: a fused fit's captured graphs hold what was
captured, so a run with a fault fits with ``fused`` off."""
from __future__ import annotations

import torch


def estep_unchanged(patch):
    """Every E-step returns its state unchanged."""
    from vlgp_tpu_torch.models import driver

    def estep(data, params, G, config, dist=None, xinv=None, return_xinv=False, **kw):
        return (data, xinv) if return_xinv else data

    patch(driver, "estep", estep)


def estep_two_sweeps(patch):
    """Every E-step, the final inference's too, stops after 2 sweeps."""
    from vlgp_tpu_torch.models import driver

    real = driver.estep

    def estep(*a, niter=None, **kw):
        return real(*a, niter=2, **kw)

    patch(driver, "estep", estep)


def mstep_half_batch(patch):
    """The M-step's sums over the first half of the segments alone."""
    from vlgp_tpu_torch.models import driver

    real = driver.mstep

    def mstep(data, params, config, niter=None, dist=None):
        keep = torch.ones_like(data.mask)
        keep[data.mask.shape[0] // 2:] = 0
        kw = {} if dist is None else {"dist": dist}
        return real(data.replace(mask=data.mask * keep), params, config, niter, **kw)

    patch(driver, "mstep", mstep)


def hstep_unchanged(patch):
    """Every H-step returns omega and sigma unchanged."""
    from vlgp_tpu_torch.models import driver

    def hstep(data, params, *a, **kw):
        return params

    patch(driver, "hstep", hstep)


def estep_answer_altered(patch):
    """Each E-step's posterior mean 1% off where it is produced."""
    from vlgp_tpu_torch.models import driver

    real = driver.estep

    def estep(*a, **kw):
        out = real(*a, **kw)
        data, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
        data = data.replace(mu=data.mu * 1.01)
        return (data, *rest) if rest else data

    patch(driver, "estep", estep)


def final_answer_altered(patch):
    """The final inference's posterior mean 1% off."""
    from vlgp_tpu_torch import api

    real = api.infer

    def infer(data, params, G, config):
        out = real(data, params, G, config)
        return out.replace(mu=out.mu * 1.01)

    patch(api, "infer", infer)


def lono_estep_unchanged(patch):
    """The members' E-step returns its start."""
    from vlgp_tpu_torch.models import vlgp

    def estep_members(data, params, G, config, cmask, state, niter=None):
        return state, torch.zeros(cmask.shape[0], dtype=torch.int64, device=cmask.device)

    patch(vlgp, "estep_members", estep_members)


def lono_two_sweeps(patch):
    """The members' E-step stops after 2 sweeps."""
    from vlgp_tpu_torch.models import vlgp

    real = vlgp.estep_members

    def estep_members(*a, niter=None, **kw):
        return real(*a, niter=2, **kw)

    patch(vlgp, "estep_members", estep_members)


def lono_half_batch(patch):
    """The members see the first half of the trials alone."""
    from vlgp_tpu_torch import model_selection

    real = model_selection.infer_members

    def infer_members(data, *a, **kw):
        keep = torch.ones_like(data.mask)
        keep[data.mask.shape[0] // 2:] = 0
        return real(data.replace(mask=data.mask * keep), *a, **kw)

    patch(model_selection, "infer_members", infer_members)


def lono_answer_altered(patch):
    """Each member's posterior mean 1% off where it is produced."""
    from vlgp_tpu_torch import model_selection

    real = model_selection.infer_members

    def infer_members(*a, **kw):
        mu, v, sweeps = real(*a, **kw)
        return mu * 1.01, v, sweeps

    patch(model_selection, "infer_members", infer_members)


# each fault a cell of the kind can have (one card: no exchange between
# chips to leave out)
BY_KIND = {
    "fit": (estep_unchanged, estep_two_sweeps, mstep_half_batch, hstep_unchanged,
            estep_answer_altered, final_answer_altered),
    "lono": (lono_estep_unchanged, lono_two_sweeps, lono_half_batch, lono_answer_altered),
}


class Patches:
    """``patch`` for use outside pytest; ``undo()`` puts every attribute back."""

    def __init__(self):
        self.saved = []

    def __call__(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)
