"""Traffic of kind ``fit``: a closed loop of one client calling ``fit`` back
to back on host NumPy trials, rotating over ``datasets`` datasets drawn from
the seed; ``fused`` picks the driver.  Set-up makes the datasets and runs
one fit, which builds the kernels and captures the graphs."""
from __future__ import annotations

import time

import numpy as np
import torch

import checks
from datasets import make_datasets, r2_aligned
from drive import BaseLoop, sync, z


class Loop(BaseLoop):
    """Whole fits, each from host trials."""

    def setup(self):
        run = self.run
        cfg = run.config
        self.data = make_datasets(cfg["data"], run.args.seed, int(run.traffic["datasets"]))
        self.kw = fit_kwargs(cfg, run.traffic, self.device)
        res = self.V.fit(self.data[0]["trials"], cfg["fit"]["n_factors"], a=self.data[0]["a"],
                         **self.kw)
        sync(self.device)
        self.capture_seen = float(res.runtime.get("capture_s", 0.0))
        run.build_s = self._build_s()
        self.snaps = {}
        self.checked = None

    def item(self, i: int) -> dict:
        ds = self.data[i % len(self.data)]
        callbacks = [self._snapshot()] if i == self.check_index else []
        t0 = time.perf_counter()
        res = self.V.fit(ds["trials"], self.run.config["fit"]["n_factors"], a=ds["a"],
                         callbacks=callbacks, **self.kw)
        sync(self.device)
        wall = time.perf_counter() - t0
        rt = res.runtime
        # a cached captured step reports its capture's seconds in every fit:
        # what this fit spent capturing is the growth
        capture = float(rt.get("capture_s", 0.0))
        spent, self.capture_seen = capture - self.capture_seen, capture
        rec = dict(wall=wall, em=float(sum(rt["em_elapsed"])), iters=len(rt["em_elapsed"]),
                   capture=spent,
                   counts={k: int(v) for k, v in rt.get("counts", {}).items()},
                   hsteps=self._hsteps(rt), mu=res.data.mu, dataset=i % len(self.data))
        if i == self.check_index:
            self.checked = dict(dataset=rec["dataset"],
                                result=dict(mu=z(res.data.mu), v=z(res.data.v),
                                            dmu=z(res.data.dmu), omega=res.params.omega,
                                            sigma=res.params.sigma))
        return rec

    def _hsteps(self, rt) -> int:
        s = self.run.config["settings"]
        return sum(1 for it in range(len(rt["em_elapsed"]))
                   if s["Hstep"] and it % max(1, s["hyper_interval"]) == 0)

    def _snapshot(self):
        """A callback that keeps the plain state after the first, the second
        and the last iteration (the driver hands it copies)."""
        calls = [0]

        def cb(d, p, config):
            st = checks.plain_state(d, p)
            if calls[0] < 2:
                self.snaps[calls[0]] = st
            self.snaps["last"] = st
            calls[0] += 1

        return cb

    def summary(self) -> dict:
        """R^2 of every fit, and whether each fit's posterior is finite."""
        z = self.data[0]["z"]
        r2, nonfinite = [], 0
        for rec in self.run.items:
            mu = rec.pop("mu")
            nonfinite += int(not bool(torch.isfinite(mu).all()))
            m = mu.double().cpu().numpy()
            r2.append(r2_aligned(m.reshape(-1, m.shape[-1]), np.tile(z, (m.shape[0], 1))))
        self.nonfinite = nonfinite
        return dict(r2=r2)

    def release(self):
        """Drop what the program holds before the reference runs."""
        self.kw = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def failed(self) -> int:
        return self.nonfinite

    def check(self) -> dict:
        ds = self.data[self.checked["dataset"]]
        nums = checks.fit_numbers(ds, self.run.config, self.snaps, self.checked["result"],
                                  self.device)
        if self.run.args.control:
            ctl = checks.fit_control_numbers(ds, self.run.config, self.snaps,
                                             self.checked["result"], self.device)
            nums.update({f"control.{k}": v for k, v in ctl.items()})
        nums["fits_nonfinite"] = float(self.nonfinite)
        return nums


def fit_kwargs(config: dict, traffic: dict, device) -> dict:
    """``fit``'s keyword arguments besides the trials, the latent count and
    the initial loading: the configuration's prior and settings, stated in
    full."""
    f, s = config["fit"], dict(config["settings"])
    Y, Z = config["data"]["neurons"], f["n_factors"]
    s["omega_bound"] = tuple(s["omega_bound"])
    return dict(lik=f["lik"], b=np.full((1, Y), f["b"], np.float32),
                omega=np.full(Z, f["omega"], np.float32), rank=f["rank"], gp_noise=f["gp_noise"],
                dt=f["dt"], fused=bool(traffic.get("fused", False)), device=device, **s)


