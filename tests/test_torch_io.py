"""vlgp_tpu_torch.utils.io, callback and base against vlgp_tpu: each package
reads the other's result and params files (every array equal, float64 on
the CPU), the reference-format shims, checkpoints, fit(path=...) and the
VLGP wrapper, on the regression-pin workload (4 trials x 120 bins x 10
neurons x 2 latents)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import vlgp_tpu
import vlgp_tpu_torch
from vlgp_tpu.utils import io as jio
from vlgp_tpu_torch.utils import io as tio

from _torch_parity import assert_close, factor_models, np_of, pin_state, pin_trials
from test_torch_ichol import assert_factor_close

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _port_fit():
    """A port fit of the pin trials started by factor analysis (so it
    carries a factor model), float64, 2 EM iterations."""
    trials, _, _ = pin_trials()
    for t in trials:
        del t["mu"]
    return vlgp_tpu_torch.fit(trials, 2, max_iter=2, min_iter=1, dtype="float64", device="cpu")


def _jax_result():
    """A vlgp_tpu FitResult holding the pin state (w from update_w), a
    factor model and a runtime dict."""
    (seg, params, G, config), _ = pin_state("float64")
    jfm, _ = factor_models()
    return vlgp_tpu.FitResult(data=seg, params=params, config=config, factor_model=jfm, G=G,
                              runtime={"it": 3, "e_elapsed": [0.5, 0.25], "converged_at": 3})


def _groups(res):
    out = {f"data.{f}": getattr(res.data, f) for f in jio._TRIAL_FIELDS}
    out.update({f"params.{f}": getattr(res.params, f) for f in jio._PARAM_FIELDS})
    if res.factor_model is not None:
        out.update({f"fm.{f}": getattr(res.factor_model, f) for f in jio._FM_FIELDS})
    out["G"] = res.G
    return out


def _assert_same_result(a, b):
    """Two FitResults (of either package) hold equal arrays of equal dtypes,
    config, scalars and runtime."""
    ga, gb = _groups(a), _groups(b)
    assert ga.keys() == gb.keys()
    for k in ga:
        xa, xb = np_of(ga[k]), np_of(gb[k])
        assert xa.dtype == xb.dtype, k
        np.testing.assert_array_equal(xa, xb, err_msg=k)
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    for f in tio._SCALAR_FIELDS:
        assert getattr(a.params, f) == getattr(b.params, f), f
    assert a.runtime == b.runtime


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_load_across_packages(direction, tmp_path):
    """A file written by one package's save loads in the other's load with
    every array equal (rtol 0), the same config, scalars and runtime; saving
    the loaded result again writes the same arrays, dtypes and header."""
    if direction == "port_to_jax":
        src = _port_fit()
        path = vlgp_tpu_torch.save(src, tmp_path / "r")
        loaded = vlgp_tpu.load(path)
        again = jio.save(loaded, tmp_path / "again")
    else:
        src = _jax_result()
        path = vlgp_tpu.save(src, tmp_path / "r")
        loaded = vlgp_tpu_torch.load(path, device="cpu")
        assert loaded.data.mu.device.type == "cpu"
        again = tio.save(loaded, tmp_path / "again")
    _assert_same_result(src, loaded)
    with np.load(path) as z1, np.load(again) as z2:
        assert sorted(z1.files) == sorted(z2.files)
        for k in z1.files:
            assert z1[k].dtype == z2[k].dtype, k
            np.testing.assert_array_equal(z1[k], z2[k], err_msg=k)


def test_save_converts_runtime_to_json(tmp_path):
    """Tensors and NumPy scalars in the runtime dict are written as JSON
    numbers and lists."""
    res = dataclasses.replace(_port_fit(), runtime={"it": np.int64(2), "t": torch.tensor(0.5),
                                                    "series": (np.float32(1.5), 2.0)})
    out = vlgp_tpu_torch.load(vlgp_tpu_torch.save(res, tmp_path / "r"), device="cpu")
    assert out.runtime == {"it": 2, "t": 0.5, "series": [1.5, 2.0]}


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_load_params_across_packages(direction, tmp_path):
    (_, jparams, _, _), (_, tparams, _, _) = pin_state("float64")
    if direction == "port_to_jax":
        src, loaded = tparams, jio.load_params(tio.save_params(tparams, tmp_path / "p"))
    else:
        src, loaded = jparams, tio.load_params(jio.save_params(jparams, tmp_path / "p"),
                                               device="cpu")
    for f in jio._PARAM_FIELDS:
        a, b = np_of(getattr(src, f)), np_of(getattr(loaded, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in tio._SCALAR_FIELDS:
        assert getattr(src, f) == getattr(loaded, f), f


@pytest.mark.parametrize("loader", ["load", "load_params", "load_reference"])
def test_load_without_device_needs_cuda(loader, monkeypatch, tmp_path):
    """The loaders put tensors on the card unless the caller asks for the
    CPU: with no CUDA device they raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if loader == "load":
        path = vlgp_tpu_torch.save(_port_fit(), tmp_path / "r")
    elif loader == "load_params":
        path = tio.save_params(_port_fit().params, tmp_path / "p")
    else:
        path = _write_reference(tmp_path, "npy")[1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(tio, loader)(path)


def _reference_result(ntrial=3, length=60, ydim=6, zdim=2):
    """A reference-style fitted result dict (``vlgp/preprocess.py``'s
    config and params keys; trial dicts with the posterior state)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(zdim, ydim)) * 0.5
    trials = []
    for i in range(ntrial):
        z = np.column_stack((np.sin(np.linspace(0, 6, length)),
                             np.cos(np.linspace(0, 6, length))))
        y = rng.poisson(np.exp(z @ a - 1.5)).astype(float)
        trials.append({"ID": i, "y": y, "x": np.ones((length, 1, ydim)),
                       "mu": z + rng.normal(size=z.shape) * 0.1,
                       "w": rng.uniform(0.5, 1.5, size=(length, zdim)),
                       "v": rng.uniform(0.1, 0.2, size=(length, zdim))})
    config = {"max_iter": 7, "min_iter": 2, "window": 30, "constrain_loading": "fro",
              "constrain_latent": False, "Hstep": 1, "omega_bound": np.array([5e-4, 5e-2]),
              "eps": 1e-8, "callbacks": [], "parallel": False, "runtime": {"it": 7}}
    params = {"a": a, "b": np.full((1, ydim), -1.5), "noise": np.ones(ydim),
              "sigma": np.ones(zdim), "omega": np.array([1e-2, 2e-2]), "rank": 30,
              "gp_noise": 1e-4, "dt": 1.0, "likelihood": np.array(["poisson"] * ydim),
              "zdim": zdim, "xdim": 1}
    return {"trials": trials, "params": params, "config": config}


def _write_reference(tmp_path, ext):
    """A reference result saved as ``vlgp.util.save`` does (util.py:181-208):
    ``np.save`` of the whole dict, or ``np.savez`` of its top-level keys."""
    rez = _reference_result()
    if ext == "npy":
        path = tmp_path / "result.npy"
        np.save(path, np.asarray(rez, dtype=object), allow_pickle=True)
    else:
        path = tmp_path / "result_z.npz"
        np.savez(path, **{k: np.asarray(v, dtype=object) for k, v in rez.items()})
    return rez, path


@pytest.mark.parametrize("ext", ["npy", "npz"])
def test_load_reference_matches_jax(ext, tmp_path):
    """tests/test_io_reference.py's checks against the port: a
    reference-pickled result loads through ``load`` and ``load_reference``
    into the same state as vlgp_tpu.load gives (float64, the posterior state
    kept), and transform runs under the migrated params."""
    rez, path = _write_reference(tmp_path, ext)
    jres = vlgp_tpu.load(path)
    for res in (vlgp_tpu_torch.load(path, device="cpu"),
                vlgp_tpu_torch.load_reference(path, device="cpu")):
        assert isinstance(res, vlgp_tpu_torch.FitResult)
        assert dataclasses.asdict(res.config) == dataclasses.asdict(jres.config)
        assert res.config.dtype == "float64" and res.config.window == 30
        assert res.params.rank == 30 and res.runtime == {"it": 7}
        assert res.data.ntrial == len(rez["trials"])
        groups, jgroups = _groups(res), _groups(jres)
        # every array read from the file is equal; each package builds G
        # itself, so G is compared as the kernel G G'
        assert_factor_close(groups.pop("G"), jgroups.pop("G"))
        for k in groups:
            assert_close(groups[k], np_of(jgroups[k]), rtol=0, err_msg=k)
        np.testing.assert_array_equal(np_of(res.data.w[0]), rez["trials"][0]["w"])
        out = vlgp_tpu_torch.transform([{"y": t["y"]} for t in rez["trials"]], res,
                                       device="cpu")
        assert np.isfinite(out[0]["mu"]).all()


def test_load_reference_trials(tmp_path):
    rez = _reference_result()
    np.save(tmp_path / "trials.npy", np.asarray(rez["trials"], dtype=object),
            allow_pickle=True)
    trials = vlgp_tpu_torch.load_reference_trials(tmp_path / "trials.npy")
    assert len(trials) == len(rez["trials"])
    np.testing.assert_array_equal(trials[0]["y"], rez["trials"][0]["y"])


def test_checkpoint_round_trip(tmp_path):
    res = _port_fit()
    path = tio.save_checkpoint(tmp_path / "ckpt", res.params, res.data, step=3)
    assert path.name == "step_3"
    like = dataclasses.replace(res.params, a=torch.zeros_like(res.params.a))
    params, post = tio.restore_checkpoint(path, like, res.data)
    for f in jio._PARAM_FIELDS:
        assert torch.equal(getattr(params, f), getattr(res.params, f)), f
    for k in ("mu", "w", "v"):
        assert torch.equal(post[k], getattr(res.data, k)), k
    assert tio.restore_checkpoint(path, like)[1] is None


def test_fit_with_path_snapshots_params(tmp_path, monkeypatch):
    """fit(path=..., saving_interval=0) wires vlgp_tpu's Saver cadence: a
    snapshot after every EM iteration and one forced at the end
    (vlgp_tpu/api.py:201-207, :249-250); the file holds the returned
    params."""
    from vlgp_tpu_torch import callback

    written = []
    save = callback.save_params
    monkeypatch.setattr(callback, "save_params", lambda p, path: written.append(save(p, path)))
    trials, a, _ = pin_trials()
    res = vlgp_tpu_torch.fit(trials, 2, a=a, b=np.full((1, 10), -1.5), noise=np.ones(10),
                             max_iter=3, dtype="float64", device="cpu",
                             path=str(tmp_path / "snap"), saving_interval=0)
    assert len(written) == res.runtime["it"] + 1
    assert set(written) == {tmp_path / "snap.npz"}
    snap = tio.load_params(tmp_path / "snap.npz", device="cpu")
    for f in jio._PARAM_FIELDS:
        assert torch.equal(getattr(snap, f), getattr(res.params, f)), f


def test_saver_interval(tmp_path, monkeypatch):
    """Saver: nothing before the interval has passed, at once with force."""
    from vlgp_tpu_torch.callback import Saver

    params = _port_fit().params
    saver = Saver(tmp_path / "s", saving_interval=3600.0)
    saver(None, params, None)
    assert not (tmp_path / "s.npz").exists()
    saver.save(None, params, None, force=True)
    assert (tmp_path / "s.npz").exists()


def test_vlgp_model_fit_transform_save_load(tmp_path):
    """base.VLGP: fit and transform match the API's, and the params saved
    by the model load back equal."""
    from vlgp_tpu_torch.base import VLGP

    trials, a, _ = pin_trials()
    kw = dict(a=a, b=np.full((1, 10), -1.5), noise=np.ones(10), max_iter=2,
              dtype="float64", device="cpu")
    model = VLGP(2, **kw)
    assert not model.isfitted
    with pytest.raises(ValueError, match="not fitted"):
        model.transform(trials)
    out = model.fit(trials)
    ref = vlgp_tpu_torch.fit(trials, 2, **kw)
    assert model.isfitted and model.weight is model.params.a
    np.testing.assert_array_equal(out[0]["mu"], ref.trials[0]["mu"])
    new, _, _ = pin_trials(seed=11, ntrial=2, length=90)
    np.testing.assert_array_equal(model.transform(new)[1]["mu"],
                                  vlgp_tpu_torch.transform(new, ref, device="cpu")[1]["mu"])
    loaded = VLGP.load(model.save(tmp_path / "m"), device="cpu")
    for f in jio._PARAM_FIELDS:
        assert torch.equal(getattr(loaded.params, f), getattr(model.params, f)), f
