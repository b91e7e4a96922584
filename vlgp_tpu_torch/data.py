"""Trial container, padding/masking, and segmentation.

Counterpart of ``vlgp_tpu/data.py``.  Trials are packed into one padded,
masked :class:`TrialSet` of tensors on one device.  Segmentation draws its
overlaps with the same NumPy generator as the JAX package, so both cut
identical segments from the same seed; the gathers and scatters run as
tensor indexing on the data's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["TrialSet", "pack_trials", "cut_trials", "scatter_segments", "unpack_trials"]


@dataclasses.dataclass(frozen=True)
class TrialSet:
    """Padded batch of trials (or segments).

    y     (N, T, ydim)        observations
    x     (N, T, xdim, ydim)  per-channel regressors (constant 1 by default)
    mask  (N, T)              1.0 on valid bins, 0.0 on padding
    mu    (N, T, zdim)        posterior mean of latents
    w     (N, T, zdim)        likelihood precision weights (core.py:419-442)
    v     (N, T, zdim)        marginal posterior variance (core.py:445-471)
    dmu   (N, T, zdim)        last E-step update (convergence check)
    trial_idx (N,) int32      parent trial index (segments) or arange (trials)
    start     (N,) int32      offset of this row within its parent trial
    lengths   (N,) int32      true (unpadded) length of each row
    """

    y: torch.Tensor
    x: torch.Tensor
    mask: torch.Tensor
    mu: torch.Tensor
    w: torch.Tensor
    v: torch.Tensor
    dmu: torch.Tensor
    trial_idx: torch.Tensor
    start: torch.Tensor
    lengths: torch.Tensor

    @property
    def ntrial(self) -> int:
        return self.y.shape[0]

    @property
    def nbin(self) -> int:
        return self.y.shape[1]

    @property
    def ydim(self) -> int:
        return self.y.shape[2]

    @property
    def zdim(self) -> int:
        return self.mu.shape[2]

    def replace(self, **kw) -> "TrialSet":
        return dataclasses.replace(self, **kw)


def pack_trials(
    trials: Sequence[dict],
    zdim: int,
    xdim: int = 1,
    *,
    dtype: torch.dtype = torch.float32,
    device="cpu",
    pad_multiple: int = 1,
) -> TrialSet:
    """Pack a reference-style list of trial dicts into a :class:`TrialSet`.

    Each trial dict must carry ``y`` of shape (length, ydim); optional keys
    ``x`` (length, xdim, ydim) or (length, xdim) and ``mu`` (length, zdim)
    are honored (preprocess.py:40-44).
    """
    n = len(trials)
    if n == 0:
        raise ValueError("no trials given")
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    lengths = np.array([np.asarray(t["y"]).shape[0] for t in trials], np.int32)
    ydim = np.asarray(trials[0]["y"]).shape[1]
    tmax = int(lengths.max())
    tmax = -(-tmax // pad_multiple) * pad_multiple

    y = np.zeros((n, tmax, ydim), np_dtype)
    x = np.zeros((n, tmax, xdim, ydim), np_dtype)
    mask = np.zeros((n, tmax), np_dtype)
    mu = np.zeros((n, tmax, zdim), np_dtype)
    for i, t in enumerate(trials):
        L = lengths[i]
        y[i, :L] = np.asarray(t["y"], np_dtype)
        if "x" in t and t["x"] is not None:
            xi = np.asarray(t["x"], np_dtype)
            if xi.ndim == 2:  # (length, xdim) -> broadcast over channels
                xi = np.repeat(xi[:, :, None], ydim, axis=2)
            x[i, :L] = xi
        else:
            x[i, :L, 0, :] = 1.0  # constant regressor (preprocess.py:44)
        if "mu" in t and t["mu"] is not None:
            mu[i, :L] = np.asarray(t["mu"], np_dtype)
        mask[i, :L] = 1.0

    def dev(a):
        return torch.from_numpy(a).to(device)

    return TrialSet(
        y=dev(y),
        x=dev(x),
        mask=dev(mask),
        mu=dev(mu),
        w=torch.zeros((n, tmax, zdim), dtype=dtype, device=device),
        v=torch.zeros((n, tmax, zdim), dtype=dtype, device=device),
        dmu=torch.zeros((n, tmax, zdim), dtype=dtype, device=device),
        trial_idx=dev(np.arange(n, dtype=np.int32)),
        start=dev(np.zeros(n, np.int32)),
        lengths=dev(lengths),
    )


def cut_trials(data: TrialSet, window: Optional[int], seed: int = 0) -> TrialSet:
    """Cut trials into window-sized segments with randomized overlap.

    Mirrors ``vlgp/util.py:457-499`` and ``vlgp_tpu.data.cut_trials``: each
    trial of valid length L yields ceil(L / window) segments; the overlap
    deficit is a multinomial draw from ``np.random.default_rng(seed)``.
    Segments are independent copies (see the JAX package's docstring for
    the last-write-wins reconciliation in :func:`scatter_segments`).
    """
    if not window:
        return data
    rng = np.random.default_rng(seed)
    lengths = data.lengths.cpu().numpy()
    n = data.ntrial

    idxs: List[int] = []
    starts: List[int] = []
    for i in range(n):
        L = int(lengths[i])
        nseg = max(1, -(-L // window))
        overlap = nseg * window - L
        start = np.cumsum(np.full(nseg, window, np.int64)) - window
        if nseg > 1 and overlap > 0:
            offset = np.cumsum(
                np.append([0], rng.multinomial(overlap, np.ones(nseg - 1) / (nseg - 1)))
            )
            start = start - offset
        start = np.maximum(start, 0)
        idxs.extend([i] * nseg)
        starts.extend(start.tolist())

    idxs_a = np.asarray(idxs, np.int32)
    starts_a = np.asarray(starts, np.int32)
    tmax = int(data.nbin)
    # segment k, offset j reads parent row idxs[k] at time starts[k] + j
    # (clamped; clamped reads land on masked bins and are zeroed)
    times = starts_a[:, None] + np.arange(window)[None, :]
    device = data.y.device
    rows = torch.from_numpy(idxs_a.astype(np.int64)).to(device)[:, None]
    cols = torch.from_numpy(np.minimum(times, tmax - 1)).to(device)
    in_range = torch.from_numpy(times < tmax).to(device)

    def gather(arr):
        out = arr[rows, cols]
        keep = in_range.reshape(in_range.shape + (1,) * (out.ndim - 2))
        return out * keep.to(out.dtype)

    seg_lengths = np.minimum(lengths[idxs_a] - starts_a, window).astype(np.int32)
    return TrialSet(
        y=gather(data.y),
        x=gather(data.x),
        mask=gather(data.mask),
        mu=gather(data.mu),
        w=gather(data.w),
        v=gather(data.v),
        dmu=gather(data.dmu),
        trial_idx=torch.from_numpy(idxs_a).to(device),
        start=torch.from_numpy(starts_a).to(device),
        lengths=torch.from_numpy(seg_lengths).to(device),
    )


def scatter_segments(full: TrialSet, segments: TrialSet) -> TrialSet:
    """Write segment posteriors back into the full-length trials,
    last-write-wins on overlapping bins (``vlgp_tpu.data.scatter_segments``)."""
    window = segments.nbin
    tmax = full.nbin
    idx = segments.trial_idx.cpu().numpy()
    start = segments.start.cpu().numpy()
    times = start[:, None] + np.arange(window)[None, :]  # (S, window)
    ok = times < tmax
    rows = np.broadcast_to(idx[:, None], times.shape)[ok]
    cols = times[ok]
    # each (trial, bin) is written by exactly one (the LAST) segment
    lin = rows.astype(np.int64) * tmax + cols
    _, first_of_rev = np.unique(lin[::-1], return_index=True)
    keep = lin.size - 1 - first_of_rev
    src_seg, src_t = np.nonzero(ok)
    device = full.mu.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)

    rows_t, cols_t = t(rows[keep]), t(cols[keep])
    seg_t, bin_t = t(src_seg[keep]), t(src_t[keep])

    def put(dst, src):
        out = dst.clone()
        out[rows_t, cols_t] = src[seg_t, bin_t]
        return out

    return full.replace(
        mu=put(full.mu, segments.mu),
        w=put(full.w, segments.w),
        v=put(full.v, segments.v),
    )


def unpack_trials(data: TrialSet, trials: Optional[Sequence[dict]] = None) -> List[dict]:
    """Convert a :class:`TrialSet` back to reference-style trial dicts of
    NumPy arrays."""
    out = []
    lengths = data.lengths.cpu().numpy()
    host = {k: getattr(data, k).cpu().numpy() for k in ("y", "x", "mu", "w", "v", "dmu")}
    for i in range(data.ntrial):
        L = int(lengths[i])
        d = dict(trials[i]) if trials is not None else {}
        d.update({k: a[i, :L] for k, a in host.items()})
        out.append(d)
    return out
