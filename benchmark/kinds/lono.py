"""Traffic of kind ``lono``: a closed loop of one client calling
``model_selection.leave_one_neuron_out`` back to back, ``batch`` neurons a
chunk, on a model the benchmark states (the generating loading, the
configuration's bias and omega).  Set-up runs one pass."""
from __future__ import annotations

import time

import numpy as np
import torch

import checks
from datasets import make_datasets
from drive import BaseLoop, sync


class Loop(BaseLoop):
    """Whole leave-one-neuron-out passes over every neuron."""

    def setup(self):
        run = self.run
        V, cfg = self.V, run.config
        self.ds = make_datasets(cfg["data"], run.args.seed, 1)[0]
        m = checks.lono_model(self.ds, cfg)
        s = dict(cfg["settings"])
        s["omega_bound"] = tuple(s["omega_bound"])
        config = V.default_config(**s)
        f = cfg["fit"]
        data = V.pack_trials(self.ds["trials"], f["n_factors"], 1, dtype=config.tdtype,
                             device=self.device)
        params = V.make_params(cfg["data"]["neurons"], f["n_factors"], 1, f["lik"], a=m["a"],
                               b=m["b"], omega=m["omega"], sigma=m["sigma"], rank=f["rank"],
                               gp_noise=f["gp_noise"], dt=f["dt"], dtype=config.tdtype,
                               device=self.device)
        self.result = V.FitResult(data=data, params=params, config=config, factor_model=None,
                                  G=torch.empty(0, device=self.device), runtime={})
        self.batch = int(run.traffic["batch"])
        from vlgp_tpu_torch.ops import control
        self.trips = control.TRIPS
        V.model_selection.leave_one_neuron_out(self.result, batch=self.batch)
        sync(self.device)
        run.build_s = self._build_s()
        self.scores = None

    def item(self, i: int) -> dict:
        r0 = self.trips["lono_rounds"]
        t0 = time.perf_counter()
        scores = self.V.model_selection.leave_one_neuron_out(self.result, batch=self.batch)
        wall = time.perf_counter() - t0  # the scores are on the host: the pass has ended
        chunks = [dict(c) for c in self.V.model_selection.LONO_CHUNKS]
        if i == self.check_index:
            self.scores = dict(scores)
            self.sweeps = {n: k for c in chunks for n, k in zip(c["neurons"], c["sweeps"])}
        return dict(wall=wall, rounds=self.trips["lono_rounds"] - r0, chunks=chunks,
                    nonfinite=int(not np.all(np.isfinite(list(scores.values())))))

    def summary(self) -> dict:
        return {}

    def release(self):
        self.result = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def failed(self) -> int:
        return sum(rec["nonfinite"] for rec in self.run.items)

    def check(self) -> dict:
        cfg, dev = self.run.config, self.device
        niter = cfg["settings"]["max_iter"]
        trails, ran = checks.lono_reference(self.ds, cfg, dev, torch.float64, extra=1)
        nums = {"lono.score": checks.lono_gap(self.scores, trails, ran, niter),
                "lono.sweeps_apart": float(max(abs(self.sweeps[n] - ran[n]) for n in ran)),
                "passes_nonfinite": float(self.failed())}
        if self.run.args.control:
            ctl = checks.at_exit(*checks.lono_reference(self.ds, cfg, dev, torch.float32,
                                                        tf32=True))
            nums["control.lono.score"] = checks.lono_gap(ctl, trails, ran, niter)
        return nums
