"""python -m vlgp_tpu_torch against python -m vlgp_tpu: the same
subcommands, arguments and defaults plus --device, fit on each input
format, and transform of new trials under a fitted file, in float64 on the
CPU, on the regression-pin workload (4 trials x 120 bins x 10 neurons x
2 latents)."""
import functools
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import vlgp_tpu
import vlgp_tpu_torch
from vlgp_tpu import cli as jcli
from vlgp_tpu_torch import cli as tcli

from _torch_parity import RTOL64, assert_close, pin_trials

REPO = pathlib.Path(__file__).resolve().parent.parent
# the CLI's settings at a small size: 2 EM iterations in float64
FIT_ARGS = ["2", "--max-iter", "2", "--min-iter", "1", "--dtype", "float64", "--quiet"]

torch.set_num_threads(1)


def _trials():
    trials, _, _ = pin_trials()
    return [{"y": t["y"]} for t in trials]


@functools.lru_cache(maxsize=None)
def _in_process_fit():
    """vlgp_tpu_torch.fit with the arguments the CLI passes for FIT_ARGS."""
    return vlgp_tpu_torch.fit(_trials(), 2, lik="poisson", max_iter=2, min_iter=1,
                              dtype="float64", fused=False, block=1, path=None,
                              verbose=False, device="cpu")


def _write_trials(tmp_path, fmt, trials):
    ys = [t["y"] for t in trials]
    if fmt == "stacked":
        path = tmp_path / "in.npz"
        np.savez(path, y=np.stack(ys))
    elif fmt == "per_trial":
        path = tmp_path / "in.npz"
        np.savez(path, **{f"y{i}": y for i, y in enumerate(ys)})
    else:  # the reference CLI's input: a pickled list of trial dicts
        path = tmp_path / "in.npy"
        np.save(path, np.asarray([{"ID": i, "y": y} for i, y in enumerate(ys)], dtype=object),
                allow_pickle=True)
    return str(path)


@pytest.mark.parametrize("fmt", ["stacked", "per_trial", "reference"])
def test_cli_fit_input_formats(fmt, tmp_path):
    """fit reads each input format and writes the in-process fit's result,
    bit for bit, in a file that vlgp_tpu.load reads too; --path writes the
    parameter snapshot."""
    fin = _write_trials(tmp_path, fmt, _trials())
    fout, snap = tmp_path / "out.npz", tmp_path / "snap"
    assert tcli.main(["fit", fin, str(fout), *FIT_ARGS, "--path", str(snap),
                      "--device", "cpu"]) == 0
    res, ref = vlgp_tpu_torch.load(fout, device="cpu"), _in_process_fit()
    assert torch.equal(res.data.mu, ref.data.mu) and torch.equal(res.params.a, ref.params.a)
    np.testing.assert_array_equal(np.asarray(vlgp_tpu.load(fout).data.mu), res.data.mu.numpy())
    assert (tmp_path / "snap.npz").exists()


def test_cli_transform_matches_jax_cli(tmp_path):
    """transform of new trials (their mu from the fit's factor model) under
    a file fitted by the port's CLI: vlgp_tpu's CLI transform on the same
    files gives the same mu0.. (rtol 1e-8, float64)."""
    fitted = tmp_path / "fit.npz"
    tcli.main(["fit", _write_trials(tmp_path, "stacked", _trials()), str(fitted), *FIT_ARGS,
               "--device", "cpu"])
    new, _, _ = pin_trials(seed=11, ntrial=3, length=90)
    (tmp_path / "new").mkdir()
    fin = _write_trials(tmp_path / "new", "per_trial", new)
    assert tcli.main(["transform", fin, str(fitted), str(tmp_path / "mu_t"),
                      "--device", "cpu"]) == 0
    assert jcli.main(["transform", fin, str(fitted), str(tmp_path / "mu_j")]) == 0
    with np.load(tmp_path / "mu_t.npz") as zt, np.load(tmp_path / "mu_j.npz") as zj:
        assert sorted(zt.files) == ["mu0", "mu1", "mu2"] == sorted(zj.files)
        for k in zt.files:
            assert zt[k].shape == (90, 2) and zt[k].dtype == np.float64
            assert_close(zt[k], zj[k], rtol=RTOL64, atol=RTOL64 * np.abs(zj[k]).max(),
                         err_msg=k)


def _options(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 0
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


@pytest.mark.parametrize("cmd", ["fit", "transform"])
def test_cli_arguments_match_jax(cmd, capsys, monkeypatch, tmp_path):
    """Each subcommand takes vlgp_tpu's options plus --device, and fit hands
    fit the same arguments and defaults as vlgp_tpu's CLI does."""
    assert _options(tcli.main, [cmd, "--help"], capsys) == \
        _options(jcli.main, [cmd, "--help"], capsys) | {"--device"}
    if cmd == "transform":
        return
    calls = {}
    for name, pkg in (("jax", vlgp_tpu), ("port", vlgp_tpu_torch)):
        monkeypatch.setattr(pkg, "fit", lambda trials, k, _n=name, **kw:
                            calls.setdefault(_n, (len(trials), k, kw)))
        monkeypatch.setattr(pkg, "save", lambda result, path: path)
    fin = _write_trials(tmp_path, "stacked", _trials())
    jcli.main(["fit", fin, "out", "3"])
    tcli.main(["fit", fin, "out", "3"])
    n, k, kw = calls["port"]
    assert kw.pop("device") == "cuda"
    assert (n, k, kw) == calls["jax"]
    assert kw["max_iter"] == 20 and kw["min_iter"] == 5 and kw["dtype"] == "float32"


@pytest.mark.parametrize("flag", [["--fused"], ["--block", "2"]])
def test_cli_unported_modes_raise(flag, tmp_path, monkeypatch):
    """--fused and --block reach fit, as vlgp_tpu's CLI passes them, and
    the fit runs (on the CPU its steps are the eager ones)."""
    seen = {}
    fit = vlgp_tpu_torch.fit

    def spy(*args, **kw):
        seen.update(fused=kw["fused"], block=kw["block"])
        return fit(*args, **kw)

    monkeypatch.setattr(vlgp_tpu_torch, "fit", spy)
    fin = _write_trials(tmp_path, "stacked", _trials())
    tcli.main(["fit", fin, str(tmp_path / "out"), *FIT_ARGS, *flag, "--device", "cpu"])
    assert seen == ({"fused": True, "block": 1} if flag == ["--fused"]
                    else {"fused": False, "block": 2})
    assert vlgp_tpu_torch.load(tmp_path / "out.npz", device="cpu").params.a.shape[0] == 2


@pytest.mark.parametrize("cmd", ["fit", "transform"])
def test_cli_without_device_needs_cuda(cmd, monkeypatch, tmp_path):
    """Without --device the CLI runs on the card: with no CUDA device it
    raises instead of falling back to the CPU."""
    fin = _write_trials(tmp_path, "stacked", _trials())
    fitted = vlgp_tpu_torch.save(_in_process_fit(), tmp_path / "fit")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["fit", fin, str(tmp_path / "out"), *FIT_ARGS] if cmd == "fit"
            else ["transform", fin, str(fitted), str(tmp_path / "mu")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(argv)


def test_module_entry_point():
    """python -m vlgp_tpu_torch runs the CLI."""
    proc = subprocess.run([sys.executable, "-m", "vlgp_tpu_torch", "--help"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "{fit,transform}" in proc.stdout
