"""Is vlgp_tpu_torch.fit reproducible from one seed on the card?

    python3 tools/torch_init_repro.py OUT.npz [--against PREV.npz]

On the flagship workload of ``chip_smoke.py`` (100 trials x 1000 bins x 100
neurons, seed 0) with no ``mu``, as the command line reads it:

- the factor-analysis subsample of ``init.initialize`` (10,000 of 100,000
  rows from a generator seeded with ``Config.seed``), twice as
  ``init._subsample_rows`` draws it and twice as ``initialize`` drew it before,
  ``torch.multinomial(mask / mask.sum(), k, replacement=True)``;
- ``fit`` with a, b and noise given (no factor analysis, so no draw), twice;
- ``fit`` with the command line's settings (5 factors, ``max_iter=20``,
  ``min_iter=5``, float32; factor analysis starts it), twice.

Prints, for each pair, whether it is equal bit for bit (and how many draws
moved), and saves the draws and posterior means to OUT.npz.  With
``--against``, compares them with another process's file.  Needs a CUDA
device.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def draw(trials, device, multinomial=False):
    """The subsample rows that ``initialize`` draws for these trials, or
    with ``multinomial`` those of a multinomial draw weighted by the mask."""
    from vlgp_tpu_torch.config import Config
    from vlgp_tpu_torch.data import pack_trials
    from vlgp_tpu_torch.init import _subsample_rows

    data = pack_trials(trials, cs.ZDIM, 1, dtype=torch.float32, device=device)
    mask = data.mask.reshape(-1)
    k = min(max(int(mask.shape[0] * 0.1), 50), mask.shape[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(Config().seed)
    if multinomial:
        return torch.multinomial(mask / mask.sum(), k, replacement=True,
                                 generator=gen).cpu().numpy()
    return _subsample_rows(mask, k, gen).cpu().numpy()


def compare(name, a, b):
    same = a.shape == b.shape and np.array_equal(a, b)
    moved = int(np.sum(a != b)) if a.shape == b.shape else -1
    print(json.dumps({"pair": name, "bitwise_equal": bool(same), "elements_differing": moved,
                      "max_abs_diff": float(np.abs(a.astype(np.float64) - b).max())
                      if a.shape == b.shape else None}), flush=True)
    return same


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_init_repro.py needs a CUDA device")
    import vlgp_tpu_torch

    out = pathlib.Path(sys.argv[1])
    against = sys.argv[sys.argv.index("--against") + 1] if "--against" in sys.argv else None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    trials, a, _ = cs.make_workload()
    for t in trials:
        del t["mu"]
    res = {f"draw_{i}": draw(trials, device) for i in (1, 2)}
    res.update({f"draw_multinomial_{i}": draw(trials, device, True) for i in (1, 2)})
    given = dict(a=a, b=np.full((1, cs.YDIM), -2.0), noise=np.ones(cs.YDIM))
    for i in (1, 2):
        r = vlgp_tpu_torch.fit(trials, cs.ZDIM, **given)
        res[f"mu_given_{i}"] = r.data.mu.cpu().numpy()
    for i in (1, 2):
        r = vlgp_tpu_torch.fit(trials, cs.ZDIM, lik="poisson", max_iter=20, min_iter=5,
                               dtype="float32")
        res[f"mu_cli_{i}"] = r.data.mu.cpu().numpy()
        res[f"fm_a_cli_{i}"] = r.factor_model.a.cpu().numpy()
    for key in ("draw", "draw_multinomial", "mu_given", "mu_cli", "fm_a_cli"):
        compare(f"{key}: call 1 vs call 2 (one process)", res[f"{key}_1"], res[f"{key}_2"])
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **res)
    if against is not None:
        prev = np.load(against)
        for key in res:
            compare(f"{key}: this process vs {against}", res[key], prev[key])


if __name__ == "__main__":
    main()
