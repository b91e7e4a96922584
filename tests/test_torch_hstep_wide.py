"""The wide evaluation of ``hstep_search`` (``csrc/hstep.cu``, T above the
shared-memory limit: ``window=None``) emulated in torch on the CPU.

On the card one evaluation of ``gp_elbo_stats`` is shared by ``per``
blocks of a cluster: a right-looking Cholesky blocked by 64-wide panels
on M = [K | C | I] (T rounded up to the panel, the pad K = I, C = 0,
I = I), each step a solve of the panel's row block (the diagonal tile
factored by every block, its columns dealt to the threads) and an update
of the trailing tiles (64 x 64 x 64 tasks dealt to the blocks in turn),
then each lower tile's sum of L^-1 (.) L^-1 C and the first block's fixed
tree over them; the next diagonal tile's factor is taken by the first
block during each update.  ``_wide_objective`` below runs that panel order and tile
map in torch, block by block; M starts as NaN outside the tiles the
kernel writes, so a read of any other tile would show.  The kernel runs on
the card only; ``chip_smoke.py`` 6c holds it against the plain version
there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlgp_tpu.models import gp as jgp
from vlgp_tpu_torch.ops import golden as og

torch.set_num_threads(1)

P, NTW = 64, 256  # csrc/hstep.cu: panel width, threads per block


def _warp_tree(v):
    """A warp's xor shuffle tree (v (..., 32)): lane 0's sum."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _block_sum(v):
    """NTW per-thread values: each warp's tree, then the warps in order."""
    warps = _warp_tree(v.reshape(NTW // 32, 32))
    s = torch.zeros((), dtype=v.dtype)
    for x in warps:
        s = s + x
    return s


def _wide_objective(C, xlog, amp, gpn, dt, nseg, profile, per, seen=None):
    """-ll of gp_elbo_stats at log(omega) = xlog as the kernel's
    evaluate_wide computes it on ``per`` blocks; ``seen`` (a dict) gets the
    (phase, step, item) each block ran."""
    n, dtype = C.shape[0], C.dtype
    nt = -(-n // P)
    Tp = nt * P
    M = torch.full((Tp, 3 * Tp), float("nan"), dtype=dtype)
    # build: K's upper tiles (diagonal tiles whole), C, I's lower tiles
    t = torch.arange(n, dtype=dtype) * dt
    d = t[:, None] - t[None, :]
    K = torch.eye(Tp, dtype=dtype)
    K[:n, :n] = amp * torch.exp(-torch.exp(xlog) * (d * d))
    K[:n, :n] += gpn * torch.eye(n, dtype=dtype)
    Cp = torch.zeros((Tp, Tp), dtype=dtype)
    Cp[:n, :n] = C
    eye = torch.eye(Tp, dtype=dtype)
    for i in range(nt):
        rows = slice(i * P, (i + 1) * P)
        M[rows, i * P:Tp] = K[rows, i * P:]
        M[rows, 2 * Tp:2 * Tp + (i + 1) * P] = eye[rows, :(i + 1) * P]
    M[:, Tp:2 * Tp] = Cp

    def mark(block, item):
        if seen is not None:
            seen.setdefault(block, []).append(item)

    def factor(k):
        """Diagonal tile k: (U rows, 1 / diag(U), its log-diagonal sum over
        the real rows), None when a pivot is not > 0."""
        blk = slice(k * P, (k + 1) * P)
        a = M[blk, blk].clone()
        rinv = torch.empty(P, dtype=dtype)
        lg = torch.empty(P, dtype=dtype)
        for s in range(P):
            if not bool(a[s, s] > 0):
                return None
            rt = torch.sqrt(a[s, s])
            rinv[s], lg[s] = 1 / rt, torch.log(rt)
            u = a[s, s + 1:] * rinv[s]
            a[s + 1:, s + 1:] = a[s + 1:, s + 1:] - u[:, None] * u[None, :]
            a[s, s + 1:] = u
        real = torch.arange(k * P, (k + 1) * P) < n
        lg = torch.where(real, lg, torch.zeros((), dtype=dtype))
        return a, rinv, _warp_tree(lg[:32] + lg[32:])

    # update tasks take two column tiles in float32, one in float64
    jw = 2 if dtype == torch.float32 else 1
    logdet = torch.zeros((), dtype=dtype)
    fac = factor(0)  # every block's own at k = 0
    for k in range(nt):
        blk = slice(k * P, (k + 1) * P)
        if fac is None:
            return torch.tensor(float("nan"), dtype=dtype)
        a, rinv, tile_logdet = fac
        logdet = logdet + tile_logdet
        # the row block's columns (k + 1) P .. (2 nt + k + 1) P, unit u on
        # block (u // NTW) mod per
        c0 = (k + 1) * P
        units = torch.arange(2 * nt * P)
        for b in range(per):
            cols = c0 + units[(units // NTW) % per == b]
            if len(cols) == 0:
                continue
            V = M[blk][:, cols]
            for s in range(P):
                V[s] = V[s] * rinv[s]
                V[s + 1:] = V[s + 1:] - a[s, s + 1:, None] * V[s][None]
            M[k * P:(k + 1) * P, cols] = V
            mark(b, ("solve", k, len(cols)))
        if k + 1 == nt:
            break
        # the trailing update: task q (row block i > k, jw column tiles from
        # j in i .. 2 nt + k); task 0 (the next diagonal tile's) on block 0,
        # which then factors that tile, the others on blocks 1 .. per - 1 in
        # turn (all on block 0 when per = 1)
        tasks = [(i, list(range(j, min(j + jw, 2 * nt + k + 1))))
                 for i in range(k + 1, nt) for j in range(i, 2 * nt + k + 1, jw)]
        owner = [0 if per == 1 or q == 0 else 1 + (q - 1) % (per - 1) for q in range(len(tasks))]
        for b in range(per):
            for q, (i, js) in enumerate(tasks):
                if owner[q] != b:
                    continue
                for j in js:
                    ut = M[blk, i * P:(i + 1) * P]
                    op = M[blk, j * P:(j + 1) * P]
                    out = M[i * P:(i + 1) * P, j * P:(j + 1) * P]
                    M[i * P:(i + 1) * P, j * P:(j + 1) * P] = out - ut.T @ op
                    mark(b, ("update", k, (i, j)))
                if q == 0:
                    fac = factor(k + 1)
    # each lower tile's sum (thread t: row t // 4, 16 columns from 16 (t mod 4))
    lower = [(i, j) for i in range(nt) for j in range(i + 1)]
    part = torch.empty(len(lower), dtype=dtype)
    for b in range(per):
        for t in range(b, len(lower), per):
            i, j = lower[t]
            Y = M[i * P:(i + 1) * P, Tp + j * P:Tp + (j + 1) * P]
            Li = M[i * P:(i + 1) * P, 2 * Tp + j * P:2 * Tp + (j + 1) * P]
            prod = (Li * Y).reshape(NTW, 16)
            acc = torch.zeros(NTW, dtype=dtype)
            for c in range(16):
                acc = acc + prod[:, c]
            part[t] = _block_sum(acc)
            mark(b, ("tile", t))
    v = torch.zeros(NTW, dtype=dtype)
    for q in range(0, len(part), NTW):
        chunk = part[q:q + NTW]
        v[:len(chunk)] = v[:len(chunk)] + chunk
    tr = _block_sum(v)
    if profile:
        s = torch.clamp(tr / (nseg * n), 1e-2, 1e2)
        return -(-0.5 * tr / s - nseg * (0.5 * n * torch.log(s) + logdet))
    return -(-0.5 * tr - nseg * logdet)


def _statistic(T, seed, dtype):
    """A C like the H-step's: nseg times the covariance of SE draws plus a
    posterior term (chip_smoke.gp_statistic in numpy)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T, dtype=float)
    K = np.exp(-np.exp(rng.uniform(-6.0, -1.0)) * (t[:, None] - t[None]) ** 2) + 1e-3 * np.eye(T)
    draws = np.linalg.cholesky(K) @ rng.normal(size=(T, 64))
    return torch.tensor(100.0 * (draws @ draws.T / 64 + 0.05 * K), dtype=dtype)


def _jax_objective(C, xlog, amp, gpn, nseg, profile):
    T = C.shape[0]
    out = jgp.gp_elbo_stats(jnp.float64(xlog), jnp.asarray(C.double().numpy()), nseg, T,
                            amp, gpn, 1.0, profile_sigma=profile)
    return -float(out[0] if profile else out)


def _extended(C, xlog, amp, gpn, nseg, profile):
    """-ll of gp_elbo_stats in numpy's extended precision (64-bit
    significands, unblocked Cholesky and forward substitutions), and the
    scale of the terms it is the sum of, |0.5 tr / s| + nseg (|0.5 T log s|
    + |logdet|) (s = 1 with a fixed amplitude)."""
    n, ld = C.shape[0], np.longdouble
    t = np.arange(n).astype(ld)
    A = ld(amp) * np.exp(-np.exp(ld(xlog)) * (t[:, None] - t[None]) ** 2) + ld(gpn) * np.eye(
        n, dtype=ld)
    Y = np.asarray(C.double().numpy(), dtype=ld)
    E = np.eye(n, dtype=ld)
    for k in range(n):  # A's lower triangle becomes L; [Y | E] becomes [L^-1 C | L^-1]
        A[k, k] = np.sqrt(A[k, k])
        A[k + 1:, k] /= A[k, k]
        A[k + 1:, k + 1:] -= np.outer(A[k + 1:, k], A[k + 1:, k])
        Y[k] /= A[k, k]
        Y[k + 1:] -= np.outer(A[k + 1:, k], Y[k])
        E[k] /= A[k, k]
        E[k + 1:] -= np.outer(A[k + 1:, k], E[k])
    tr = np.sum(np.tril(E) * Y)
    logdet = np.sum(np.log(np.diagonal(A)))
    s = min(max(tr / (ld(nseg) * n), ld(1e-2)), ld(1e2)) if profile else ld(1)
    slog = 0.5 * n * np.log(s) if profile else ld(0)
    f = 0.5 * tr / s + nseg * (slog + logdet)
    return float(f), float(abs(0.5 * tr / s) + nseg * (abs(slog) + abs(logdet)))


# log omega at the box's ends and inside it (config.omega_bound)
XLOGS = (np.log(5e-4), np.log(5e-3), np.log(5e-2))


@pytest.mark.parametrize("T", [139, 200])
@pytest.mark.parametrize("profile", [True, False])
def test_wide_objective_f64_matches_jax(T, profile):
    """float64, a partial last panel (139 = 2 x 64 + 11, 200 = 3 x 64 + 8),
    the profiled and the fixed amplitude: within rtol 1e-10 of vlgp_tpu's
    gp_elbo_stats, relative to the scale of the objective's terms (0.5 tr
    and nseg logdet, _extended).  They can cancel: at T139, amplitude 1.3
    and omega 5e-2 they are +3.78e4 and -3.73e4, so f is 465 and a rounding
    of the terms weighs 80 times more against |f| (the emulation there lies
    1.2e-10 of |f| from the extended-precision value, 7e-13 of the terms'
    scale; test_wide_objective_f64_against_extended_precision)."""
    C = _statistic(T, T, torch.float64)
    amp = 1.0 if profile else 1.3
    for xlog in XLOGS:
        got = float(_wide_objective(C, torch.tensor(xlog, dtype=torch.float64), amp, 1e-4, 1.0,
                                    100.0, profile, per=3))
        ref = _jax_objective(C, xlog, amp, 1e-4, 100.0, profile)
        scale = max(abs(ref), _extended(C, xlog, amp, 1e-4, 100.0, profile)[1])
        assert abs(got - ref) <= 1e-10 * scale, (xlog, got, ref, scale)


@pytest.mark.parametrize("profile", [True, False])
def test_wide_objective_f64_against_extended_precision(profile):
    """The emulation's float64 objective and vlgp_tpu's against the same
    objective in extended precision (_extended) at T139: each within 1e-11
    of the scale of the terms (both below 5e-12 here), though the
    emulation lies 1.2e-10 from it relative to |f| at the box's rough end
    with a fixed amplitude (the cancellation in
    test_wide_objective_f64_matches_jax)."""
    C = _statistic(139, 139, torch.float64)
    amp = 1.0 if profile else 1.3
    for xlog in XLOGS:
        ref, scale = _extended(C, xlog, amp, 1e-4, 100.0, profile)
        emu = float(_wide_objective(C, torch.tensor(xlog, dtype=torch.float64), amp, 1e-4, 1.0,
                                    100.0, profile, per=2))
        jx = _jax_objective(C, xlog, amp, 1e-4, 100.0, profile)
        assert abs(emu - ref) <= 1e-11 * scale, (xlog, emu, ref, scale)
        assert abs(jx - ref) <= 1e-11 * scale, (xlog, jx, ref, scale)


@pytest.mark.parametrize("T", [139, 200])
def test_wide_objective_f32_as_close_as_the_plain_version(T):
    """float32 against vlgp_tpu's float64 objective.  tr(K^-1 C) carries
    ~cond(K) eps of rounding in any order of operations (cond(K) reaches
    ~1e4 T here, gp_noise 1e-4), so the float32 objective's error is held
    to that of the port's plain version (cuSOLVER's order on the card,
    LAPACK's here) on the same inputs: within 4 times the plain version's
    error plus 1e-6 of |f|, where 6c's HSTEP_FTOL rule judges the search by
    the plain version's error."""
    C64 = _statistic(T, T + 1, torch.float64)
    C = C64.float()
    for profile in (True, False):
        for xlog in XLOGS:
            ref = _jax_objective(C64, xlog, 1.0, 1e-4, 100.0, profile)
            got = float(_wide_objective(C, torch.tensor(xlog, dtype=torch.float32), 1.0, 1e-4,
                                        1.0, 100.0, profile, per=2))
            plain = og._objective(C[None], torch.tensor(100.0), torch.ones(1), 1e-4, 1.0,
                                  profile)(torch.tensor([xlog], dtype=torch.float32))
            err_plain = abs(float(plain[0]) - ref)
            assert abs(got - ref) <= 4 * err_plain + 1e-6 * abs(ref), (
                profile, xlog, got, ref, err_plain)


def test_wide_nonpositive_pivot_gives_nan():
    """A K that is not positive definite (gp_noise -0.5): the first
    non-positive pivot makes the objective NaN, as cholesky_ex's info > 0
    does in gp_elbo_stats; a positive one stays finite."""
    C = _statistic(139, 3, torch.float64)
    for gpn in (-0.5, -1e-3):
        xlog = torch.tensor(np.log(5e-4), dtype=torch.float64)
        got = _wide_objective(C, xlog, 1.0, gpn, 1.0, 100.0, True, per=4)
        assert bool(torch.isnan(got))
        assert np.isnan(_jax_objective(C, float(xlog), 1.0, gpn, 100.0, True))
    assert bool(torch.isfinite(_wide_objective(C, xlog, 1.0, 1e-4, 1.0, 100.0, True, per=4)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wide_objective_same_bits_for_every_block_count(dtype):
    """The tile map at 1, 2, 3, 5 and 16 blocks an evaluation (3 and 5
    split the tasks unevenly): every column of each step's solve, every
    update task and every lower tile's sum is run by exactly one block, the
    same set of them for every block count, and the objective is the same.
    The emulation computes each tile's operations alike whichever block
    runs it, so the equal objective holds here by construction once the
    map covers every tile once; that the kernel's blocks give the same bits
    is checked on the card (chip_smoke.py 6c, every plan's x)."""
    C = _statistic(200, 5, dtype)
    xlog = torch.tensor(np.log(2e-3), dtype=dtype)
    ref, ref_items = None, None
    for per in (1, 2, 3, 5, 16):
        seen = {}
        got = _wide_objective(C, xlog, 0.8, 1e-4, 1.0, 100.0, False, per, seen)
        items = sorted(item for block in seen.values() for item in block
                       if item[0] != "solve")
        assert len(items) == len(set(items))
        solved = {}
        for block in seen.values():
            for phase, k, count in (it for it in block if it[0] == "solve"):
                solved[k] = solved.get(k, 0) + count
        assert all(c == 2 * 4 * P for c in solved.values()) and len(solved) == 4
        if ref is None:
            ref, ref_items = got, items
        assert torch.equal(got, ref), (per, got, ref)
        assert items == ref_items
