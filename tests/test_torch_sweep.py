"""Port parity for ops/sweep: the plain version of the fused E-step sweep
kernel against the JAX package's ``_sweep_pallas`` in interpret mode, and
``estep`` under the ``_SWEEP_FUSED`` switch against ``estep_sweep_fused``.

The TPU kernel multiplies in bf16x3 and the port in float32, so results
agree to the Newton-Schulz floor of tests/test_sweep_fused.py:69 (2e-4 of
max|mu| for mu and dmu, 2e-4 of each tensor's max for w, v and X), not bit
for bit.  Exit groups match, so both take the same trip counts.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_sweep_fused import _problem
from vlgp_tpu.models import vlgp as jv
from vlgp_tpu.ops import sweep as jsw
from vlgp_tpu_torch.models import vlgp as tv
from vlgp_tpu_torch.ops import spd as tspd
from vlgp_tpu_torch.ops import sweep as tsw

from _torch_parity import np_of, pin_state

torch.set_num_threads(1)

AGREE = 2e-4


@pytest.fixture(autouse=True)
def _fresh_counters():
    tspd.reset_counters()
    yield


@pytest.fixture(scope="module")
def pin32():
    """The pin workload in float32, in both packages (built once)."""
    return pin_state("float32")


def _t(x):
    return torch.tensor(np.asarray(x))


def _inputs(problem=None, ragged=False, yscale=None):
    """The JAX test problem as the kernel's operands (NumPy arrays)."""
    data, params, G, config = _problem(**(problem or {}))
    if ragged:  # tests/test_sweep_fused.py:134
        mask = np.asarray(data.mask).copy()
        mask[-2:, 10:] = 0.0
        data = data.replace(mask=jnp.asarray(mask), y=data.y * mask[..., None],
                            x=data.x * mask[..., None, None], mu=data.mu * mask[..., None],
                            w=data.w * mask[..., None], v=data.v * mask[..., None])
        data = jv.update_w(data, params, config)
    if yscale is not None:  # one exit group sees more spikes than the others
        y = np.asarray(data.y).copy()
        y[64:128] *= yscale
        data = data.replace(y=jnp.asarray(y))
    ops = dict(y=data.y, xb=jv._xb(data.x, params.b), mask=data.mask, a=params.a,
               noise=params.noise, poisson=params.poisson, G=G,
               muz=jv._zmajor(data.mu), wz=jv._zmajor(data.w), vz=jv._zmajor(data.v))
    return {k: np.asarray(v) for k, v in ops.items()}, config


def _run_both(ops, config, xinv=None, vb=True, niter=3, tol=0.0):
    kw = dict(niter=niter, tol=tol, dmu_bound=config.dmu_bound, ns_iters=config.ns_iters,
              ns_warm_iters=config.ns_warm_iters, vb=vb)
    args = [ops[k] for k in ("y", "xb", "mask", "a", "noise", "poisson", "G", "muz", "wz", "vz")]
    jout = jsw._sweep_pallas(*(jnp.asarray(x) for x in args),
                             None if xinv is None else jnp.asarray(xinv), interpret=True, **kw)
    Z, T, R = ops["G"].shape
    bs = tsw._pick_bs(Z, T, ops["y"].shape[-1], R)
    tout = tsw._sweep_plain(*(_t(x) for x in args), None if xinv is None else _t(xinv),
                            bs=bs, **kw)
    return [np.asarray(x) for x in jout], tout


def _assert_agree(jout, tout):
    mu_scale = np.abs(jout[0]).max()
    for i, name in enumerate(("mu", "w", "v", "dmu", "X")):
        scale = mu_scale if name in ("mu", "dmu") else np.abs(jout[i]).max()
        err = np.abs(np_of(tout[i]) - jout[i]).max()
        assert err <= AGREE * scale, (name, err, scale)


CASES = {
    # tests/test_sweep_fused.py:22 shape (S10 T16 Y6 Z2 R16), one group of 64
    "cold": dict(),
    "zeros_carry": dict(carry="zeros"),
    "real_carry": dict(carry="real"),
    "map": dict(vb=False),
    "ragged": dict(ragged=True),
    "adaptive": dict(niter=12, tol=1e-4),
    "T64_R50": dict(problem=dict(T=64, R=50), niter=16),
    # S130: three groups of 64; the middle one sees 3x the spikes and
    # sweeps longer, so the groups exit apart
    "groups_exit_apart": dict(problem=dict(S=130), yscale=3.0, niter=6, tol=1e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sweep_plain_matches_pallas(case):
    c = dict(CASES[case])
    ops, config = _inputs(c.pop("problem", None), c.pop("ragged", False), c.pop("yscale", None))
    carry = c.pop("carry", None)
    xinv = None
    if carry is not None:
        Z, _, R = ops["G"].shape
        S = ops["y"].shape[0]
        xinv = np.zeros((Z, S, R, R), np.float32)
        if carry == "real":  # the inverse a cold E-step leaves at its weights
            xinv = np.asarray(_run_both(ops, config)[0][4])
    jout, tout = _run_both(ops, config, xinv=xinv, **c)
    _assert_agree(jout, tout)
    assert float(tout[5].amax()) < tspd._RESID_TOL and float(jout[5]) < tspd._RESID_TOL
    counts = np_of(tout[6])
    if carry == "zeros":
        # the zeros carry fails its warm refine and both escalations, then
        # restarts cold: 4 passes before the first sweep
        assert counts[0, 1] == 4 + c.get("niter", 3)
    if case == "map":
        np.testing.assert_array_equal(np_of(tout[2]), ops["vz"])
    if case == "ragged":
        dead = ops["mask"] == 0.0
        assert np.abs(np_of(tout[0])[:, dead]).max() == 0
        assert np.abs(np_of(tout[1])[:, dead]).max() == 0
    if case == "groups_exit_apart":
        assert counts[:, 0].tolist() == [4, 6, 4]
    assert tspd.KERNEL_LAUNCHES["sweep"] == 0


def test_pick_bs_and_eligibility(pin32):
    """The exit groups of the JAX package (16 at the flagship E-step, none at
    the T = 1000 final inference) and the eligibility gate."""
    assert tsw._pick_bs(5, 50, 100, 40) == jsw._pick_bs(5, 50, 100, 40) == 16
    assert tsw._pick_bs(5, 1000, 100, 50) == jsw._pick_bs(5, 1000, 100, 50) == 0
    for shape in ((2, 16, 6, 16), (2, 64, 6, 50), (3, 33, 7, 128), (1, 200, 300, 8)):
        assert tsw._pick_bs(*shape) == jsw._pick_bs(*shape)
    data, params, G, _ = pin32[1]
    assert tsw.sweep_fused_eligible(data, params, G, tv.Dist())
    assert not tsw.sweep_fused_eligible(data, params, G.double(), tv.Dist())
    big = torch.zeros((G.shape[0], G.shape[1], 130))
    assert not tsw.sweep_fused_eligible(data, params, big, tv.Dist())


def _jax_fused_estep(jstate, xinv):
    """JAX's fused E-step with its per-sweep core as the fallback, in
    interpret mode (vlgp_tpu/models/vlgp.py:269-284)."""
    seg, params, G, config = jstate
    vb = config.method == "VB"

    def core():
        out, X = jv.estep(seg, params, G, config, xinv=xinv, return_xinv=True)
        return (jv._zmajor(out.mu), jv._zmajor(out.w), jv._zmajor(out.v),
                jv._zmajor(out.dmu), X)

    return jsw.estep_sweep_fused(
        seg.y, jv._xb(seg.x, params.b), seg.mask, params.a, params.noise, params.poisson,
        G, jv._zmajor(seg.mu), jv._zmajor(seg.w), jv._zmajor(seg.v), xinv,
        niter=config.Eniter, tol=config.estep_tol, dmu_bound=config.dmu_bound,
        ns_iters=config.ns_iters, ns_warm_iters=config.ns_warm_iters, vb=vb,
        fallback=core, interpret=True)


def test_estep_fused_matches_jax(monkeypatch, pin32):
    """estep with the switch on, from vem's zeros carry, against
    JAX's fused E-step on the pin workload."""
    jstate, port = pin32
    Z, R = jstate[2].shape[0], jstate[2].shape[-1]
    S = jstate[0].y.shape[0]
    xinv = np.zeros((Z, S, R, R), np.float32)
    ref = [np.asarray(x) for x in _jax_fused_estep(jstate, jnp.asarray(xinv))]
    monkeypatch.setattr(tv, "_SWEEP_FUSED", True)
    out, X = tv.estep(*port, xinv=torch.tensor(xinv), return_xinv=True)
    assert tspd.ROUTE_CALLS["sweep"] == 1 and tspd.FALLBACKS["sweep_core"] == 0
    got = [tv._zmajor(t) for t in (out.mu, out.w, out.v, out.dmu)] + [X]
    _assert_agree(ref, got)


def test_estep_fused_falls_back_to_core(monkeypatch, pin32):
    """One Newton-Schulz round per refine cannot meet 1e-2 even after the
    escalations and the cold restart: the E-step answers with the
    per-sweep composition and counts one ``sweep_core``."""
    data, params, G, config = pin32[1]
    config = config.replace(ns_iters=1, ns_warm_iters=1)
    want = tv.estep(data, params, G, config)
    assert tspd.ROUTE_CALLS["sweep"] == 0
    monkeypatch.setattr(tv, "_SWEEP_FUSED", True)
    got = tv.estep(data, params, G, config)
    assert tspd.ROUTE_CALLS["sweep"] == 1 and tspd.FALLBACKS["sweep_core"] == 1
    for name in ("mu", "w", "v", "dmu"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def test_sweep_cuda_wrapper_refuses_cpu_tensors():
    ops, config = _inputs()
    args = [_t(ops[k]) for k in ("y", "xb", "mask", "a", "noise", "poisson", "G", "muz",
                                 "wz", "vz")]
    with pytest.raises(ValueError, match="CUDA"):
        tsw._sweep_cuda(*args, None, niter=3, tol=0.0, dmu_bound=config.dmu_bound,
                        ns_iters=16, ns_warm_iters=4, vb=True, bs=64)
    assert tspd.KERNEL_LAUNCHES["sweep"] == 0


def _c_expr(src, pattern):
    """A C integer expression of the CUDA sources as Python (`/` on ints
    truncates)."""
    return re.search(pattern, src).group(1).replace("/", "//")


def test_python_geometry_matches_the_kernel_source():
    """The eligibility gate's shared-memory count and block size are the
    kernel's: the expressions of ``csrc/sweep.cu`` (region, bit sets,
    launch) and ``csrc/ns_common.cuh`` (tiles, stride, threads), read back
    from the sources and evaluated here, at every width and group count."""
    from vlgp_tpu_torch.ops import _build

    sweep_cu = (_build.CSRC / "sweep.cu").read_text()
    common = (_build.CSRC / "ns_common.cuh").read_text()
    tc = int(re.search(r"constexpr int TC = (\d+);", common).group(1))
    tiles = _c_expr(common, r"int tiles_per_side\(int R\) \{ return (.+?); \}")
    ld = _c_expr(common, r"int padded_ld\(int R\) \{ return (.+?); \}")
    threads = _c_expr(common, r"const int nb = tiles_per_side\(R\);\s*return (.+?);")
    ns = _c_expr(sweep_cu, r"const int ns = (.+?);")
    seg = _c_expr(sweep_cu, r"const int seg = (.+?);")
    stride = _c_expr(sweep_cu, r"int row_stride\(int Y\) \{ return (.+?); \}")
    smem = _c_expr(sweep_cu, r"const size_t smem = sizeof\(float\) \* (.+?);")
    assert "return ns > seg ? ns : seg;" in sweep_cu
    assert "const int nt = tiled_threads(R);" in sweep_cu
    assert re.search(r"cudaLaunchCooperativeKernel\([^;]*blocks, nt, args, smem", sweep_cu)
    stats = re.search(r"enum Stat \{([^}]*)\}", sweep_cu).group(1).split(",")
    assert [x.strip().lower() for x in stats] == list(tsw._STATS) + ["stats"]
    tiles_per_side = lambda R: eval(tiles, {"R": R})  # noqa: E731
    padded_ld = lambda R: eval(ld, {"R": R, "tiles_per_side": tiles_per_side})  # noqa: E731
    assert tsw._TC == tc
    for R in (1, 3, 16, 17, 40, 50, 100, 127, 128):
        nb = tiles_per_side(R)
        nt = eval(threads, {"nb": nb})
        assert tsw._threads(R) == nt
        for Z, T, Y in ((1, 1, 1), (2, 16, 6), (5, 50, 100), (5, 50, 1001), (12, 300, 40)):
            env = dict(Z=Z, T=T, Y=Y, R=R, nb=nb, nwarp=nt // 32, TC=tc, padded_ld=padded_ld,
                       row_stride=lambda Y: eval(stride, {"Y": Y}))
            region = max(eval(ns, env), eval(seg, env))
            for S, bs in ((64, 64), (2000, 16), (4096, 8), (96, 32)):
                got = eval(smem, dict(Z=Z, T=T, S=S, bs=bs, Y=Y, R=R,
                                      region_floats=lambda Z, T, Y, R: region))
                assert tsw._sweep_smem_bytes(Z, T, Y, R, S // bs) == 4 * got, (Z, T, Y, R, S)
    # the wrapper's scratch holds the shapes ``SweepArgs`` declares
    for Z, S, bs in ((1, 4, 4), (5, 2000, 16), (3, 96, 32)):
        sc = tsw._scratch(Z, S, S // bs, "cpu")
        for name in ("rmat", "npart", "rlast"):
            dims = re.search(rf"float\* {name};\s*// \(([^)]*)\)", sweep_cu).group(1)
            want = np.prod([eval(d.replace("/", "//"), {"S": S, "Z": Z, "bs": bs})
                            for d in dims.split(",")])
            assert sc[name].numel() == want and sc[name].dtype == torch.float32, name


def test_sweep_geometry_at_the_edge_widths():
    """Shared memory and eligibility at R = 1, 40 and 128, and at a Y whose
    row, not the Newton-Schulz buffers, sets the shared memory."""
    from types import SimpleNamespace

    # the flagship (Z5 T50 Y100 R40): 128 threads, ns_gram's 6916 floats,
    # 125 groups in 4 words each
    assert tsw._threads(40) == 128
    assert tsw._sweep_smem_bytes(5, 50, 100, 40, 125) == 4 * (6916 + 8) == 27696
    # Y = 600 at R = 40: the segment stage's vectors, a, a2 and a row each of
    # xb and y (604 floats: 151 16-byte words)
    assert tsw._sweep_smem_bytes(5, 50, 600, 40, 125) == 4 * (1050 + 600 + 6000 + 2 * 604 + 8)
    # R = 1: one warp; the Newton-Schulz buffers take 241 floats, a and rows of Y = 300 more
    assert tsw._threads(1) == 32
    assert tsw._sweep_smem_bytes(1, 1, 7, 1) == 4 * (241 + 2)
    assert tsw._sweep_smem_bytes(1, 1, 300, 1) == 4 * (5 + 3 + 600 + 2 * 300 + 2)
    # R = 128: 1024 threads and ns_gram's 223,488 bytes, under the 232,448 limit
    assert tsw._threads(128) == 1024
    assert tsw._sweep_smem_bytes(1, 4, 100, 128, 33) == 4 * (55872 + 4) <= tsw._SMEM_MAX
    # at R = 128 a, a2 and the rows of Y = 15000 would not fit
    big = tsw._sweep_smem_bytes(1, 1, 15000, 128)
    assert big == 4 * (5 + 384 + 30000 + 2 * 15004 + 2) > tsw._SMEM_MAX

    def eligible(S, T, Y, Z, R):
        data = SimpleNamespace(y=torch.zeros((S, T, Y)))
        params = SimpleNamespace(a=torch.zeros((Z, Y)))
        return tsw.sweep_fused_eligible(data, params, torch.zeros((Z, T, R)), tv.Dist())

    assert tsw._pick_bs(1, 1, 15000, 128) > 0
    assert eligible(20, 1, 100, 1, 128) and not eligible(20, 1, 15000, 1, 128)
    assert eligible(2000, 50, 100, 5, 40) and eligible(40, 8, 300, 2, 1)


def test_sweep_plain_groups_are_independent():
    """Exit groups do not see each other in ``_sweep_plain``: more spikes in
    the middle of three groups change none of the other two groups' outputs
    or counts by a bit.  The kernel's grid relies on this: any block may
    take any group's items, and a group's exit needs only its own norms."""
    ops, config = _inputs(dict(S=130))
    Z, T, R = ops["G"].shape
    bs = tsw._pick_bs(Z, T, ops["y"].shape[-1], R)
    assert bs == 64
    kw = dict(niter=8, tol=1e-3, dmu_bound=config.dmu_bound, ns_iters=config.ns_iters,
              ns_warm_iters=config.ns_warm_iters, vb=True, bs=bs)
    names = ("y", "xb", "mask", "a", "noise", "poisson", "G", "muz", "wz", "vz")
    base = tsw._sweep_plain(*(_t(ops[k]) for k in names), None, **kw)
    y = ops["y"].copy()
    y[bs:2 * bs] = y[bs:2 * bs] * 3.0 + 1.0
    moved = tsw._sweep_plain(*(_t(y if k == "y" else ops[k]) for k in names), None, **kw)
    keep = np.r_[0:bs, 2 * bs:130]
    for i, name in enumerate(("mu", "w", "v", "dmu", "X")):
        assert torch.equal(base[i][:, keep], moved[i][:, keep]), name
        assert not torch.equal(base[i][:, bs:2 * bs], moved[i][:, bs:2 * bs]), name
    for i in (5, 6):  # worst residual and counts per group
        assert torch.equal(base[i][[0, 2]], moved[i][[0, 2]])
    assert not torch.equal(base[6][1], moved[6][1])
