"""Command-line interface (counterpart of ``vlgp_tpu/cli.py``).

    python -m vlgp_tpu_torch fit <input.npz> <output.npz> <n_factors> [options]
    python -m vlgp_tpu_torch transform <input.npz> <fitted.npz> <output.npz>

Input format: an ``.npz`` holding either a single stacked array ``y`` of
shape (ntrial, nbin, ydim) or per-trial arrays ``y0, y1, ...``, or a
reference-saved trial list.  Both subcommands run on the CUDA device unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np


def _load_trials(path: str):
    z = np.load(path, allow_pickle=True)
    if hasattr(z, "files"):
        if "y" in z.files and np.asarray(z["y"]).ndim == 3:
            return [{"y": np.asarray(y)} for y in z["y"]]
        keys = sorted(
            (k for k in z.files if k.startswith("y")),
            key=lambda k: int(k[1:]) if k[1:].isdigit() else 0,
        )
        if keys and all(np.asarray(z[k]).ndim == 2 for k in keys):
            return [{"y": np.asarray(z[k])} for k in keys]
    else:
        arr = np.asarray(z)
        if arr.ndim == 3 and arr.dtype != object:
            return [{"y": y} for y in arr]
    # fall back to the reference CLI's input format: a pickled list of
    # trial dicts saved via vlgp.util.save (__main__.py:18-21)
    from .utils.io import load_reference_trials

    try:
        return load_reference_trials(path)
    except Exception as e:
        raise SystemExit(
            f"no trials found in {path} (expected stacked 'y', per-trial "
            f"'y0..', or a reference-saved trial list): {e}"
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vlgp_tpu_torch",
        description="variational Latent Gaussian Process (PyTorch, CUDA)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    pfit = sub.add_parser("fit", help="fit the model (reference __main__.py:6-22)")
    pfit.add_argument("fin", type=str, help="path to input trials (.npz)")
    pfit.add_argument("fout", type=str, help="path to output result (.npz)")
    pfit.add_argument("n_factors", type=int, help="number of latent factors")
    pfit.add_argument("--max-iter", type=int, default=20)
    pfit.add_argument("--min-iter", type=int, default=5)
    pfit.add_argument("--lik", type=str, default="poisson",
                      choices=["poisson", "gaussian"])
    pfit.add_argument("--dtype", type=str, default="float32")
    pfit.add_argument("--fused", action="store_true",
                      help="run each EM iteration as one captured CUDA graph")
    pfit.add_argument("--block", type=int, default=1,
                      help="this many EM iterations per host read of the norms "
                           "(values > 1 imply --fused)")
    pfit.add_argument("--path", type=str, default=None,
                      help="periodic parameter snapshots to this path")
    pfit.add_argument("--quiet", action="store_true")

    ptr = sub.add_parser("transform", help="infer latents for new trials")
    ptr.add_argument("fin", type=str)
    ptr.add_argument("fitted", type=str)
    ptr.add_argument("fout", type=str)

    for p in (pfit, ptr):
        p.add_argument("--device", type=str, default="cuda",
                       help="torch device to run on (default: cuda)")

    args = parser.parse_args(argv)

    import vlgp_tpu_torch

    if args.cmd == "fit":
        trials = _load_trials(args.fin)
        print(f"Loaded {len(trials)} trials from {args.fin}")
        result = vlgp_tpu_torch.fit(
            trials,
            args.n_factors,
            lik=args.lik,
            max_iter=args.max_iter,
            min_iter=args.min_iter,
            dtype=args.dtype,
            fused=args.fused,
            block=args.block,
            path=args.path,
            verbose=not args.quiet,
            device=args.device,
        )
        out = vlgp_tpu_torch.save(result, args.fout)
        print(f"Saved {out}")
        return 0

    if args.cmd == "transform":
        trials = _load_trials(args.fin)
        fitted = vlgp_tpu_torch.load(args.fitted, device=args.device)
        out_trials = vlgp_tpu_torch.transform(trials, fitted, device=args.device)
        mus = {f"mu{i}": t["mu"] for i, t in enumerate(out_trials)}
        np.savez(pathlib.Path(args.fout).with_suffix(".npz"), **mus)
        print(f"Saved {args.fout}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
