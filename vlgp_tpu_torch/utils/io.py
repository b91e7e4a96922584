"""Persistence: save/load results and parameters (counterpart of
``vlgp_tpu/utils/io.py``).

Results serialize to the same flat ``.npz`` layout as ``vlgp_tpu.save``
(arrays keyed ``data.*``, ``params.*``, ``fm.*`` and ``G``, plus a JSON
header stored as uint8), with the same dtypes, so each package reads the
other's files.  Training-time checkpoints are ``torch.save`` files of plain
tensor dicts in place of ``vlgp_tpu``'s orbax checkpoints.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import numpy as np
import torch

from ..config import Config, Params, _resolve_device
from ..data import TrialSet
from ..init import FactorModel

__all__ = [
    "save",
    "load",
    "save_params",
    "load_params",
    "load_reference",
    "load_reference_trials",
    "from_reference_result",
]

_TRIAL_FIELDS = ("y", "x", "mask", "mu", "w", "v", "dmu", "trial_idx", "start", "lengths")
_PARAM_FIELDS = ("a", "b", "noise", "sigma", "omega", "poisson", "da", "db")
_FM_FIELDS = ("mean", "a", "psi")
_SCALAR_FIELDS = ("gp_noise", "dt", "rank", "likelihood_kind")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _jsonable(x):
    """``x`` with tensors, NumPy arrays and NumPy scalars turned into JSON
    types (``json.dumps`` takes none of them)."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


def _scalars(params: Params) -> dict:
    return {f: getattr(params, f) for f in _SCALAR_FIELDS}


def save(result, path) -> pathlib.Path:
    """Save a :class:`~vlgp_tpu_torch.api.FitResult` to ``<path>.npz``."""
    path = pathlib.Path(path).with_suffix(".npz")
    arrays = {}
    for f in _TRIAL_FIELDS:
        arrays[f"data.{f}"] = _np(getattr(result.data, f))
    for f in _PARAM_FIELDS:
        arrays[f"params.{f}"] = _np(getattr(result.params, f))
    if result.factor_model is not None:
        for f in _FM_FIELDS:
            arrays[f"fm.{f}"] = _np(getattr(result.factor_model, f))
    arrays["G"] = _np(result.G)
    header = {
        "config": dataclasses.asdict(result.config),
        "scalars": _scalars(result.params),
        "runtime": _jsonable(result.runtime),
    }
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load(path, device=None):
    """Load a result back into a FitResult, every tensor on ``device``
    (default: the CUDA device; raises when there is none, so pass
    ``device="cpu"`` to load on the CPU).

    Accepts both this layout (written by :func:`save` or ``vlgp_tpu.save``)
    and the reference implementation's pickled result files
    (``vlgp/util.py:181-208``: ``np.save`` of the whole ``{'trials',
    'params', 'config'}`` dict to ``.npy``, or ``np.savez`` of its top-level
    keys).  Reference files require unpickling (``allow_pickle=True``); only
    load files you trust.
    """
    from ..api import FitResult  # local import to avoid a cycle

    device = _resolve_device(device, "load")
    path = pathlib.Path(path)
    if not path.exists():
        raise FileNotFoundError(str(path))
    if path.suffix == ".npy":
        return from_reference_result(_load_reference_object(path), device=device)
    with np.load(path) as z:
        if "header" not in z.files:
            return from_reference_result(_load_reference_object(path), device=device)

        def t(key):
            return torch.from_numpy(z[key]).to(device)

        header = json.loads(bytes(z["header"].tobytes()).decode())
        cfg = header["config"]
        if isinstance(cfg.get("omega_bound"), list):
            cfg["omega_bound"] = tuple(cfg["omega_bound"])
        data = TrialSet(**{f: t(f"data.{f}") for f in _TRIAL_FIELDS})
        params = Params(**{f: t(f"params.{f}") for f in _PARAM_FIELDS}, **header["scalars"])
        fm = None
        if "fm.mean" in z.files:
            fm = FactorModel(**{f: t(f"fm.{f}") for f in _FM_FIELDS})
        G = t("G")
    return FitResult(
        data=data,
        params=params,
        config=Config(**cfg),
        factor_model=fm,
        G=G,
        runtime=header.get("runtime", {}),
    )


# ---------------------------------------------------------------------------
# Reference-format migration shims (vlgp/util.py:181-208, __main__.py:18-21).
# The reference pickles its result/trials dicts via np.save; these loaders
# unpickle (trusted files only) and convert into the typed containers.
# ---------------------------------------------------------------------------

_REF_CONFIG_KEYS = (
    "constrain_loading", "use_hessian", "eps", "tol", "min_iter", "method",
    "learning_rate", "max_iter", "Eniter", "Mniter", "Hstep", "da_bound",
    "db_bound", "dmu_bound", "omega_bound", "window", "saving_interval",
)


def _load_reference_object(path):
    """np.load a reference-``save``d ``.npy``/``.npz`` back to a dict/list."""
    path = pathlib.Path(path)
    obj = np.load(path, allow_pickle=True)
    if path.suffix == ".npz" or hasattr(obj, "files"):
        out = {}
        with obj:
            for k in obj.files:
                v = obj[k]
                out[k] = v[()] if v.dtype == object and v.ndim == 0 else v
        return out
    if isinstance(obj, np.ndarray) and obj.dtype == object:
        return obj[()] if obj.ndim == 0 else list(obj)
    return obj


def _config_from_reference(rconfig: dict) -> Config:
    """Map a reference config dict (preprocess.py:84-112) onto :class:`Config`.

    Reference-only keys (``callbacks``, the never-read ``parallel``,
    ``runtime``) are dropped; falsy constraints normalize to ``"none"``.
    """
    kw = {}
    for k in _REF_CONFIG_KEYS:
        if k in rconfig:
            kw[k] = rconfig[k]
    for k in ("constrain_loading", "constrain_latent"):
        v = rconfig.get(k, None)
        if v is None:
            continue
        if not v or v == "none":
            kw[k] = "none"
        elif v is True:
            kw[k] = "both"
        else:
            kw[k] = str(v)
    if isinstance(kw.get("omega_bound"), (list, np.ndarray)):
        kw["omega_bound"] = tuple(float(x) for x in kw["omega_bound"])
    for k in ("use_hessian", "Hstep"):
        if k in kw:
            kw[k] = bool(kw[k])
    for k in ("min_iter", "max_iter", "Eniter", "Mniter", "window"):
        if k in kw:
            kw[k] = int(kw[k])
    for k in ("eps", "tol", "learning_rate", "da_bound", "db_bound",
              "dmu_bound", "saving_interval"):
        if k in kw:
            kw[k] = float(kw[k])
    # the reference computes everything in float64 and its config has no
    # dtype key: float32 would round the migrated params and posteriors
    kw.setdefault("dtype", "float64")
    return Config(**kw)


def from_reference_result(rez, device=None):
    """Convert a reference result dict ``{'trials', 'params', 'config'}``
    (the object its ``api.fit`` returns and ``util.save`` pickles) into a
    :class:`~vlgp_tpu_torch.api.FitResult` on ``device`` (default: the CUDA
    device; raises when there is none)."""
    from ..api import FitResult  # local import to avoid a cycle
    from ..config import make_params
    from ..data import pack_trials
    from ..models.gp import make_cholesky

    device = _resolve_device(device, "from_reference_result")
    if not isinstance(rez, dict) or "trials" not in rez or "params" not in rez:
        raise ValueError(
            "not a reference result (expected dict with 'trials' and 'params')"
        )
    trials = list(rez["trials"])
    rp = dict(rez["params"])
    config = _config_from_reference(dict(rez.get("config", {})))

    zdim = int(rp.get("zdim", np.asarray(rp["a"]).shape[0]))
    xdim = int(rp.get("xdim", np.asarray(rp["b"]).shape[0]))
    lik = rp.get("likelihood", "poisson")
    if isinstance(lik, np.ndarray):
        lik = [str(l) for l in lik]
    ydim = np.asarray(trials[0]["y"]).shape[-1]
    params = make_params(
        ydim, zdim, xdim, lik,
        a=np.asarray(rp["a"], np.float64) if rp.get("a") is not None else None,
        b=np.asarray(rp["b"], np.float64) if rp.get("b") is not None else None,
        noise=rp.get("noise"), sigma=rp.get("sigma"), omega=rp.get("omega"),
        rank=int(rp.get("rank", 50)),
        gp_noise=float(rp.get("gp_noise", 1e-4)),
        dt=float(rp.get("dt", 1.0)),
        dtype=config.tdtype,
        device=device,
    )

    data = pack_trials(trials, zdim, xdim, dtype=config.tdtype, device=device)
    # the reference's trial dicts carry the posterior state too — keep it
    lengths = _np(data.lengths)
    extra = {}
    for field in ("w", "v", "dmu"):
        if all(field in t and t[field] is not None for t in trials):
            buf = np.zeros_like(_np(data.mu))
            for i, t in enumerate(trials):
                buf[i, : lengths[i]] = np.asarray(t[field], buf.dtype)
            extra[field] = torch.from_numpy(buf).to(device)
    if extra:
        data = data.replace(**extra)

    G = make_cholesky(data.nbin, params)
    return FitResult(
        data=data, params=params, config=config, factor_model=None, G=G,
        runtime=dict(rez.get("config", {}).get("runtime", {})),
        _trials_in=trials,
    )


def load_reference(path, device=None):
    """Load a reference-``save``d *result* file into a FitResult on
    ``device`` (default: the CUDA device; raises when there is none)."""
    return from_reference_result(_load_reference_object(path), device=device)


def load_reference_trials(path):
    """Load a reference-style *trials* file (the CLI input format,
    ``vlgp/__main__.py:18-21``): a pickled list of trial dicts with ``y``
    (and optional ``ID``/``x``/``mu``).  Returns a list of trial dicts."""
    obj = _load_reference_object(path)
    if isinstance(obj, dict) and "trials" in obj:
        obj = obj["trials"]
    if isinstance(obj, dict) and "y" in obj:
        obj = [obj]
    trials = list(obj)
    if not trials or not all(isinstance(t, dict) and "y" in t for t in trials):
        raise ValueError(f"no trial dicts with 'y' found in {path}")
    return trials


def save_params(params: Params, path) -> pathlib.Path:
    """Save :class:`Params` to ``<path>.npz`` (``vlgp_tpu``'s layout: one
    array per field and the scalar fields as JSON in ``_scalars``)."""
    path = pathlib.Path(path).with_suffix(".npz")
    arrays = {f: _np(getattr(params, f)) for f in _PARAM_FIELDS}
    arrays["_scalars"] = np.frombuffer(json.dumps(_scalars(params)).encode(), dtype=np.uint8)
    np.savez(path, **arrays)
    return path


def load_params(path, device=None) -> Params:
    """Load :class:`Params` saved by :func:`save_params` (or
    ``vlgp_tpu``'s) onto ``device`` (default: the CUDA device; raises when
    there is none)."""
    device = _resolve_device(device, "load_params")
    with np.load(pathlib.Path(path)) as z:
        scalars = json.loads(bytes(z["_scalars"].tobytes()).decode())
        return Params(**{f: torch.from_numpy(z[f]).to(device) for f in _PARAM_FIELDS},
                      **scalars)


def _tensor_fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)}


def save_checkpoint(path, params: Params, data: Optional[TrialSet] = None,
                    step: int = 0) -> pathlib.Path:
    """Checkpoint params (and optionally the posterior state) to
    ``<path>/step_<step>``: one ``torch.save`` file of plain tensor dicts.
    Restore with :func:`restore_checkpoint`."""
    path = pathlib.Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tree = {"params": _tensor_fields(params)}
    if data is not None:
        tree["posterior"] = {"mu": data.mu, "w": data.w, "v": data.v}
    out = path / f"step_{step}"
    torch.save(tree, out)
    return out


def restore_checkpoint(path, params_like: Params,
                       data_like: Optional[TrialSet] = None):
    """Restore a checkpoint saved by :func:`save_checkpoint`.

    ``params_like`` gives the scalar fields and the device (and
    ``data_like`` asks for the posterior, on its device).  Returns
    (params, posterior_dict_or_None).
    """
    tree = torch.load(pathlib.Path(path).resolve(), map_location=params_like.a.device,
                      weights_only=True)
    params = params_like.replace(**tree["params"])
    posterior = None
    if data_like is not None:
        posterior = {k: v.to(data_like.mu.device) for k, v in tree["posterior"].items()}
    return params, posterior
