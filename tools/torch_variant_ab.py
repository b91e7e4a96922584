"""Time builds of one CUDA source of vlgp_tpu_torch on the card, in turns:

    python3 tools/torch_variant_ab.py OUT.json --source {mstep,hstep_stat,estep,ns_gram} \\
        --variant NAME[@FILE.cu][=FLAGS] [--variant ...]

Each variant is ``csrc/<source>.cu`` (``csrc/ns_inverse.cu`` for
``ns_gram``; or FILE.cu, e.g. the same source of
another tree unpacked with ``git archive``, next to its own headers)
compiled with the package's nvcc flags plus FLAGS (one string, split on
spaces, e.g. ``-DVLGP_MSTEP_GENERIC``) into ``vlgp_tpu_torch/_build/ab/``;
the builds run in parallel.  For each case the plain version and the
variants are timed in turns, plain, v1 .. vn, vn .. v1, plain ([median,
min, max] ms over 10 calls, each
between its own pair of CUDA events, ``chip_smoke.time_ms``), and each
variant's outputs are held against the first variant's (the largest gap,
and whether every output has its bits) and against the plain version's
in float64 on the same inputs (the largest gap relative to each output's
largest |value|; for the plain version's float32 output too).  Cases:

  * ``mstep``: ``mstep_stats``' pass (its partial sums, as the fit calls
    it; the outputs compared after the reduction; its device time a launch
    from the trace of 20 calls, ``device_us``) at the flagship's M-step
    shape (Z5 S2000 T50 Y100 X1, inputs drawn as chip_smoke's 6c draws
    them) and at Z3 and Z8; and ``mstep_update`` on the flagship's partial
    sums (264 chunks), called with the prototype the variant's own tree
    declares (the exit test's norms only where it has them), timed as
    replays of a captured call (``chip_smoke.graph_ms``) with its device
    time a launch from the trace of 20 eager calls (``device_us``);
  * ``hstep_stat``: the flagship's segments (Z5 S2000 T50 R40) and whole
    trials (Z5 S100 T1000 R50, ``window=None``), inputs as chip_smoke's 6d
    draws them;
  * ``estep``: ``estep_project`` and ``estep_step`` (from the plain s) at
    the flagship's segments (Z5 S2000 T50 Y100 R40) and the final
    inference's trials (Z5 S100 T1000 Y100 R50), or at ``--estep-shapes``
    (SxTxR, or BxSxTxR for B members on S segments, chip_smoke's
    ``members_case``, which a variant without the member axis refuses),
    Poisson channels, inputs as chip_smoke's 6e draws them
    (``estep_case``), contiguous; each timed
    as replays of a captured call (``chip_smoke.graph_ms``: the device
    time without the host's launch cost, which a call as short as these
    can exceed).
  * ``ns_gram``: the per-matrix design at the flagship's segments (Z5
    S2000 T50 R40, inputs as chip_smoke's phase 3 draws them,
    ``gram_case``) in every mode the fit runs (``chip_smoke.GRAM_MODES``),
    each as replays of a captured call; a variant whose library has the
    streaming path (``ns_gram_stream``) runs the launch plan's path, any
    other the block path.

A variant is compiled with ``-I csrc/`` too, so a FILE.cu under
``tools/variants/`` finds the package's headers; where nvcc prints
``-Xptxas -v``'s report (FLAGS ``-Xptxas -v``) the report goes into the
JSON line under ``nvcc``.  An ``estep`` variant built from a tree before
the launch plan (the first design's ``estep.cu``, no ``estep_smem``) is
called with that tree's prototypes, so both designs run on the same
inputs.  A variant that exports ``estep_stamps``
(``tools/variants/estep_block_stamped.cu``), or ``ns_gram_stamps``
(``tools/variants/ns_gram_stamped.cu``), is run once more per case
with its clock stamps read back: each block's SM, start, phase ends and
end (``%globaltimer``), summarised as blocks resident an SM, the SMs'
busy share of the launch and the mean time of each phase (``stamps``);
``estep_attrs`` / ``ns_gram_attrs`` add registers, spills and resident
blocks an SM.  A build
of the package's ``estep.cu`` with ``-DESTEP_CYCLES`` counts clock cycles
in its streaming kernels (``estep_cycles``, which other builds refuse):
the consumers' waits for a stage, the producer's waits for a free one and
``estep_step``'s phases, as shares of one consumer thread's loop a block
(``cycles``).

Prints one JSON line with the card's name and power limit.  Needs a CUDA
device and nvcc.
"""
import argparse
import ctypes
import importlib.util
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# the package library of each source
LIBRARY = {"mstep": "mstep", "hstep_stat": "hstep_stat", "estep": "estep",
           "ns_gram": "ns_inverse"}

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def parse_variant(spec, source):
    """NAME[@FILE.cu][=FLAGS] -> (name, source file, [flags])."""
    from vlgp_tpu_torch.ops import _build

    head, _, flags = spec.partition("=")
    name, _, path = head.partition("@")
    src = pathlib.Path(path).resolve() if path else _build.CSRC / f"{LIBRARY[source]}.cu"
    return name, src, flags.split()


def tree_signatures(src, source):
    """The ctypes prototypes of ``source``'s functions as the variant's own
    tree declares them (``ops/_build.py`` beside its ``csrc/``), or as this
    tree does for a FILE.cu outside a package."""
    from vlgp_tpu_torch.ops import _build

    table = pathlib.Path(src).resolve().parents[1] / "ops" / "_build.py"
    if not table.is_file():
        return _build._SIGNATURES[LIBRARY[source]]
    spec = importlib.util.spec_from_file_location(f"_variant_build_{abs(hash(table))}", table)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES[LIBRARY[source]]


def build_all(source, variants):
    """Compile every variant at once; {name: loaded library}."""
    from vlgp_tpu_torch.ops import _build

    outdir = _build.BUILD_DIR / "ab"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src, flags in variants:
        out = outdir / f"lib{LIBRARY[source]}_{name}.so"
        procs[name] = (out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I",
                                              str(_build.CSRC), "-o", str(out), str(src)],
                                             stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(out))
        lib.nvcc_log = err if "ptxas" in err else None
        sigs = tree_signatures(next(v[1] for v in variants if v[0] == name), source)
        lib.counts_cycles = False
        if source == "estep":
            lib.with_plan = hasattr(lib, "estep_smem")
            if not lib.with_plan:
                sigs = PLANLESS_ESTEP
        for fn, (argtypes, restype) in sigs.items():
            if source == "ns_gram" and not hasattr(lib, fn):
                continue  # a stamped build exports ns_gram alone
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.ns_error_string.argtypes = [ctypes.c_int]
        lib.ns_error_string.restype = ctypes.c_char_p
        if source == "estep" and lib.with_plan:  # a -DESTEP_CYCLES build counts
            lib.counts_cycles = lib.estep_cycles(0, None, 1) == 0
        if source == "mstep":
            # a tree before the exit test's norms declares mstep_update
            # without their three pointers (cn, norms, the ticket counter)
            have = len(sigs["mstep_update"][0])
            want = len(_build._SIGNATURES["mstep"]["mstep_update"][0])
            if have not in (want, want - 3):
                raise RuntimeError(f"variant {name}: mstep_update takes {have} arguments")
            lib.with_norms = have == want
        libs[name] = lib
    return libs


_p, _i, _d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the prototypes of estep.cu before the launch plan (the first design alone)
PLANLESS_ESTEP = {"estep_project": ([_p] * 9 + [_i] * 4 + [_p], _i),
              "estep_step": ([_p] * 14 + [_i] * 5 + [_d, _i, _p], _i)}


def estep_call(kind, args):
    """``estep_project`` or ``estep_step`` (``kind``) through the current
    variant: the package's wrapper where the variant has the member axis
    and the cluster path (``estep_cluster_resident``), a launch plan
    without them (the older prototypes: the streaming path where it fits,
    else the block path) or the planless prototype, on contiguous inputs.
    ``args`` ends with cm (B, Y) for members, which only the first takes."""
    from vlgp_tpu_torch.ops import _build
    from vlgp_tpu_torch.ops import estep as oe
    from vlgp_tpu_torch.ops.spd import _ptr

    lib = _build._libs["estep"]
    if hasattr(lib, "estep_cluster_resident"):
        return oe.estep_project(*args) if kind == "project" else oe.estep_step(*args)
    if len(args) > (8 if kind == "project" else 12):
        raise RuntimeError("this variant has no member axis")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if lib.with_plan:
        if kind == "project":
            y, xb, mask, a, mu, v, pois, noise = args
            (S, T, Y), Z = y.shape, a.shape[0]
            plan = oe.project_plan(S, T, Y, Z, y.dtype)
            s = torch.empty((Z, S, T), dtype=y.dtype, device=y.device)
            rc = lib.estep_project(*[_ptr(t) for t in (y, xb, mask, a, mu, v, pois, noise, s)],
                                   S * T, Y, Z, int(y.dtype == torch.float64),
                                   plan.units if plan.path == "stream" else 0, plan.stages,
                                   plan.grid, stream)
            outs = s
        else:
            G, s, mu, w, X, mask, a, xb, v, pois, noise, bound = args
            (Z, T, R), S, Y = G.shape, xb.shape[0], xb.shape[2]
            plan = oe.step_plan(S, T, Y, Z, R, G.dtype)
            stream_path = plan.path == "stream"
            outs = [torch.empty_like(mu) for _ in range(3)]
            rc = lib.estep_step(*[_ptr(t) for t in (G, s, mu, w, X, mask, a, xb, v, pois, noise,
                                                    *outs)],
                                S, T, Y, Z, R, float(bound), int(G.dtype == torch.float64),
                                plan.units if stream_path else 0, plan.stages if stream_path else 0,
                                plan.grid if stream_path else 0, stream)
        if rc != 0:
            raise RuntimeError(f"estep_{kind} failed: {lib.ns_error_string(rc).decode()}")
        return outs
    if kind == "project":
        y, xb, mask, a, mu, v, pois, noise = args
        S, T, Y = y.shape
        s = torch.empty((a.shape[0], S, T), dtype=y.dtype, device=y.device)
        rc = lib.estep_project(*[_ptr(t) for t in (y, xb, mask, a, mu, v, pois, noise, s)],
                               S * T, Y, a.shape[0], int(y.dtype == torch.float64), stream)
        outs = s
    else:
        G, s, mu, w, X, mask, a, xb, v, pois, noise, bound = args
        (Z, T, R), S, Y = G.shape, xb.shape[0], xb.shape[2]
        outs = [torch.empty_like(mu) for _ in range(3)]
        rc = lib.estep_step(*[_ptr(t) for t in (G, s, mu, w, X, mask, a, xb, v, pois, noise,
                                                *outs)],
                            S, T, Y, Z, R, float(bound), int(G.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"estep_{kind} failed: {lib.ns_error_string(rc).decode()}")
    return outs


def stamp_summary(fetch, nb, last, run):
    """One more call of ``run`` with a stamped variant's clock table read
    back (``fetch(buf, reset)``: the table of ``nb`` blocks of 10 slots, the
    SM in slot 0, the start in 1, phase ends up to ``last``): blocks, the
    launch's span, blocks resident an SM (the most at once, and the
    time-weighted mean while the SM is busy), the SMs' busy share of the
    span, and each phase's mean time a block, in us."""
    ns = 10
    buf = (ctypes.c_ulonglong * (nb * ns))()
    fetch(buf, 1)
    run()
    torch.cuda.synchronize()
    fetch(buf, 0)
    rows = np.frombuffer(buf, dtype=np.uint64).reshape(nb, ns)
    live = rows[rows[:, 1] != 0]
    t = live[:, 1:last + 1].astype(np.float64)
    t -= t[:, 0].min()
    span = float(t[:, -1].max())
    peak, mean_res, busy = [], [], []
    for sm in np.unique(live[:, 0]):
        iv = t[live[:, 0] == sm][:, [0, -1]]
        ev = sorted([(a, 1) for a in iv[:, 0]] + [(b, -1) for b in iv[:, 1]])
        n = top = 0
        prev, area, on = 0.0, 0.0, 0.0
        for x, d in ev:
            if n > 0:
                area += n * (x - prev)
                on += x - prev
            n += d
            top = max(top, n)
            prev = x
        peak.append(top)
        mean_res.append(area / on if on else 0.0)
        busy.append(on / span if span else 0.0)
    dur = t[:, -1] - t[:, 0]
    return {"blocks": int(len(live)), "sms": int(len(peak)), "span_us": span / 1e3,
            "block_us_median": float(np.median(dur)) / 1e3,
            "resident_max": int(max(peak)), "resident_mean": float(np.mean(mean_res)),
            "sm_busy_share": float(np.mean(busy)),
            "phase_us_mean": [float(x) / 1e3 for x in np.diff(t, axis=1).mean(0)]}


# slots 2 and 3 hold the producer's loop and waits, or on estep_step's
# cluster path the consumer's cluster barriers and its sums of the chunks
CYCLE_SLOTS = ("consumer", "consumer_wait", "producer|cluster_barriers",
               "producer_wait|chunk_sums", "items", "A", "B", "C", "D", "E", "refresh_and_stores",
               "G_copy")


def cycle_summary(lib, which, run):
    """One more call of ``run`` with the ``-DESTEP_CYCLES`` build's counters
    read back (``which``: 0 estep_project, 1 estep_step): blocks, tiles or
    segments a block, the consumer thread's cycles a block, and each
    counter's mean as a share of them."""
    nb, ns = 264, len(CYCLE_SLOTS)
    buf = (ctypes.c_ulonglong * (nb * ns))()
    lib.estep_cycles(which, buf, 1)
    run()
    torch.cuda.synchronize()
    lib.estep_cycles(which, buf, 0)
    a = np.frombuffer(buf, dtype=np.uint64).reshape(nb, ns).astype(np.float64)
    live = a[a[:, 4] > 0]
    tot = float(live[:, 0].mean())
    return {"blocks": int(len(live)), "items_per_block": float(live[:, 4].mean()),
            "consumer_cycles": tot,
            "share": {n: float(live[:, i].mean()) / tot for i, n in enumerate(CYCLE_SLOTS)
                      if i != 4 and live[:, i].any()}}


def run_update(part, n, a, b, noise):
    """(a_new, b_new, noise, da, db) of the current variant's
    ``mstep_update`` on ``mstep_stats``' partial sums, float32, Newton mode."""
    from vlgp_tpu_torch.ops import _build
    from vlgp_tpu_torch.ops import mstep as om
    from vlgp_tpu_torch.ops.spd import _ptr

    lib = _build._libs["mstep"]
    Z, Y = a.shape
    X = b.shape[0]
    _, chunks, entries = part.part.shape
    red = torch.empty((Y, entries), dtype=a.dtype, device=a.device)
    outs = [torch.empty_like(a), torch.empty_like(b), torch.empty_like(noise),
            torch.empty_like(a), torch.empty_like(b)]
    extra = []
    handle = torch.cuda.current_stream(a.device).cuda_stream
    if lib.with_norms:
        extra = [torch.empty((Y, 4), dtype=a.dtype, device=a.device),
                 torch.empty((4,), dtype=a.dtype, device=a.device), om._ticket(a.device, handle)]
    stream = ctypes.c_void_p(handle)
    rc = lib.mstep_update(_ptr(part.part), chunks, None, _ptr(red), _ptr(n), _ptr(a), _ptr(b),
                          _ptr(noise), None, *[_ptr(t) for t in outs + extra], Y, Z, X, 1, 1e-8,
                          1.0, 5.0, 5.0, 0, stream)
    if rc != 0:
        raise RuntimeError(f"mstep_update failed: {lib.ns_error_string(rc).decode()}")
    return outs


def gram_call(G, w, iters, x0, resid_only, want_v):
    """``ns_gram`` through the current variant: the launch plan's path where
    its library has the streaming path, else the block path; [X, the
    residuals, v] without the outputs the mode does not write."""
    from vlgp_tpu_torch.ops import _build, spd

    plan = None if hasattr(_build._libs["ns_inverse"], "ns_gram_stream") else spd.BLOCK_PLAN
    return [t for t in spd._ns_gram_cuda(G, w, iters, x0, resid_only, want_v, plan=plan)
            if t is not None]


def gram_plain(G, w, iters, x0, resid_only, want_v):
    from vlgp_tpu_torch.ops import spd

    return [t for t in spd._ns_gram_plain(G, w, iters, x0, resid_only, want_v) if t is not None]


def device_us(fn, kernel):
    """The device time in us of one call of ``fn``: the kernels whose name
    holds ``kernel`` in the trace of 20 calls, over 20."""
    _, _, by_name = cs.trace_kernels(lambda: [fn() for _ in range(20)])
    return 1e6 * sum(t for k, t in by_name.items() if kernel in k) / 20


def rel(got, ref):
    return max(cs._rel(g.double(), r.double())[0] for g, r in zip(got, ref))


def cases(source, device, gen, estep_shapes=((2000, 50, 40), (100, 1000, 50))):
    """[(tag, timed: () -> None, run: () -> outputs, plain64: () -> float64
    outputs, plain: () -> float32 outputs)] of the source's cases; ``timed``
    is the main path's call (mstep_stats' pass alone, its partial sums)."""
    out = []
    if source == "mstep":
        from vlgp_tpu_torch.ops import mstep as om

        for S, T, Y, Z, X in ((2000, 50, 100, 5, 1), (2000, 50, 100, 3, 1),
                              (2000, 50, 100, 8, 1)):
            args = cs.mstep_case(S, T, Y, Z, X, torch.float32, device, gen.manual_seed(0))
            a64 = [t.double() for t in args]
            out.append((f"mstep_stats Z{Z} S{S} T{T} Y{Y} X{X}",
                        lambda a=args: om.mstep_stats(*a, partial=True),
                        lambda a=args: om.mstep_stats(*a),
                        lambda a=a64: om._mstep_stats_plain(*a, True),
                        lambda a=args: om._mstep_stats_plain(*a, True), cs.time_ms,
                        lambda a=args: device_us(lambda: om.mstep_stats(*a, partial=True),
                                                 "mstep_stats")))
        # the update on the flagship's partial sums, each variant's from its
        # own stats kernel (the layout of the partials is the variant's)
        args = cs.mstep_case(2000, 50, 100, 5, 1, torch.float32, device, gen.manual_seed(0))
        y, x, mask, mu, v, a, b = args
        n = torch.sum(mask)
        noise = torch.full((100,), 0.5, dtype=torch.float32, device=device)
        stats = om._mstep_stats_plain(*args, True)
        stats64 = [t.double() for t in stats]
        parts = {}

        def upd():
            from vlgp_tpu_torch.ops import _build

            lib = _build._libs["mstep"]
            if id(lib) not in parts:
                parts[id(lib)] = om.mstep_stats(*args, partial=True)
            return parts[id(lib)], n, a, b, noise

        out.append(("mstep_update Z5 Y100 X1 (264 chunks' partial sums)",
                    lambda: run_update(*upd()), lambda: run_update(*upd()),
                    lambda: om._mstep_update_plain(stats64, n.double(), a.double(), b.double(),
                                                   noise.double(), None, True, 1e-8, 1.0, 5.0,
                                                   5.0)[:5],
                    lambda: om._mstep_update_plain(stats, n, a, b, noise, None, True, 1e-8, 1.0,
                                                   5.0, 5.0)[:5],
                    cs.graph_ms, lambda: device_us(lambda: run_update(*upd()), "mstep_update")))
    elif source == "estep":
        from vlgp_tpu_torch.ops import estep as oe

        def up(args):
            return [t.double() if torch.is_tensor(t) and t.is_floating_point() else t
                    for t in args]

        for shape in estep_shapes:
            if len(shape) == 4:  # B members on S base segments
                B, S, T, R = shape
                proj, step, cm = cs.members_case(S, T, 100, 5, R, B, torch.float32, device,
                                                 gen.manual_seed(0))
                proj, step = proj + [cm], step + [cm]
            else:
                (S, T, R), B = shape, 1
                proj, step = cs.estep_case(S, T, 100, 5, R, 1, torch.float32, device,
                                           gen.manual_seed(0))
            proj = [t.contiguous() for t in proj]
            step = [step[0], oe._estep_project_plain(*proj)] + step[2:]
            step = [t.contiguous() if torch.is_tensor(t) else t for t in step]
            p64, s64 = up(proj), up(step)
            S = f"B{B} S{S}" if B > 1 else S
            out.append((f"estep_project Z5 S{S} T{T} Y100",
                        lambda a=proj: estep_call("project", a),
                        lambda a=proj: [estep_call("project", a)],
                        lambda a=p64: [oe._estep_project_plain(*a)],
                        lambda a=proj: [oe._estep_project_plain(*a)], cs.graph_ms, None))
            out.append((f"estep_step Z5 S{S} T{T} Y100 R{R}", lambda a=step: estep_call("step", a),
                        lambda a=step: list(estep_call("step", a)),
                        lambda a=s64: list(oe._estep_step_plain(*a)),
                        lambda a=step: list(oe._estep_step_plain(*a)), cs.graph_ms, None))
    elif source == "ns_gram":
        G, w, w_warm, X0 = cs.gram_case(5, 2000, 50, 40, device, gen.manual_seed(0))
        for mode, (iters, use_x0, resid_only, want_v) in cs.GRAM_MODES.items():
            args = (G, w_warm if use_x0 and not resid_only else w, iters,
                    X0 if use_x0 else None, resid_only, want_v)
            a64 = tuple(t.double() if torch.is_tensor(t) else t for t in args)
            out.append((f"ns_gram {mode} Z5 S2000 T50 R40", lambda a=args: gram_call(*a),
                        lambda a=args: gram_call(*a), lambda a=a64: gram_plain(*a),
                        lambda a=args: gram_plain(*a), cs.graph_ms, None))
    else:
        from vlgp_tpu_torch.ops import hstat as oh

        for Z, S, T, R in ((5, 2000, 50, 40), (5, 100, 1000, 50)):
            args = cs.hstat_case(Z, S, T, R, torch.float32, device, gen.manual_seed(0))
            a64 = [t.double() for t in args]
            run = (lambda a=args: oh.hstep_stat(*a))
            out.append((f"hstep_stat Z{Z} S{S} T{T} R{R}", run, run,
                        lambda a=a64: oh._hstep_stat_plain(*a),
                        lambda a=args: oh._hstep_stat_plain(*a), cs.time_ms, None))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--source", choices=tuple(LIBRARY), required=True)
    ap.add_argument("--variant", action="append", required=True)
    ap.add_argument("--estep-shapes", default="2000x50x40,100x1000x50",
                    help="SxTxR (or BxSxTxR: B members) of the estep cases, comma-separated "
                         "(Z5 Y100)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("torch_variant_ab.py needs a CUDA device")
    from vlgp_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load_library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    variants = [parse_variant(v, opts.source) for v in opts.variant]
    libs = build_all(opts.source, variants)
    names = [v[0] for v in variants]
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    result = {"card": card, "source": opts.source,
              "variants": {n: [str(s), f] for n, s, f in variants}}
    result["nvcc"] = {n: lib.nvcc_log for n, lib in libs.items() if lib.nvcc_log}
    for n, lib in libs.items():
        if hasattr(lib, "estep_attrs"):
            at = (ctypes.c_int * 9)()
            lib.estep_attrs(at)
            result.setdefault("attrs", {})[n] = {
                k: dict(zip(("registers", "local_bytes", "blocks_per_sm"), at[3 * i:3 * i + 3]))
                for i, k in enumerate(("estep_project", "estep_step_256", "estep_step_512"))}
        if hasattr(lib, "ns_gram_attrs"):
            at = (ctypes.c_int * 3)()
            lib.ns_gram_attrs(at)
            result.setdefault("attrs", {})[n] = {
                "ns_gram_kernel R40": dict(zip(("registers", "local_bytes", "blocks_per_sm"), at))}
    shapes = [tuple(int(x) for x in c.split("x")) for c in opts.estep_shapes.split(",")]
    key = LIBRARY[opts.source]
    real = _build._libs[key]
    try:
        for tag, timed, run, plain64, plain, timer, dev_us in cases(opts.source, device, gen,
                                                                    shapes):
            ref64 = plain64()
            entry = {"plain_float32_vs_float64": rel(plain(), ref64),
                     "plain_ms": [timer(plain)]}
            first = None
            for name in names + names[::-1]:
                _build._libs[key] = libs[name]
                got = run()
                if first is None:
                    first = got
                entry.setdefault(name, {"vs_first": rel(got, first), "vs_float64": rel(got, ref64),
                                        "bits_as_first": all(cs.same_bits(g, f)
                                                             for g, f in zip(got, first)),
                                        "ms": []})
                entry[name]["ms"].append(timer(timed))
                if dev_us is not None:
                    entry[name].setdefault("device_us", []).append(dev_us())
                if libs[name].counts_cycles:
                    entry[name].setdefault("cycles", []).append(
                        cycle_summary(libs[name], int(tag.startswith("estep_step")), timed))
                lib = libs[name]
                if hasattr(lib, "estep_stamps"):
                    which = int(tag.startswith("estep_step"))
                    lib.estep_stamps.argtypes = [_i, _p, _i]
                    entry[name].setdefault("stamps", []).append(stamp_summary(
                        lambda buf, reset, w=which: lib.estep_stamps(w, buf, reset), 4096,
                        8 if which else 4, timed))
                if hasattr(lib, "ns_gram_stamps"):
                    lib.ns_gram_stamps.argtypes = [_p, _i]
                    entry[name].setdefault("stamps", []).append(
                        stamp_summary(lib.ns_gram_stamps, 10240, 8, timed))
            entry["plain_ms"].append(timer(plain))
            result[tag] = entry
            print(tag, json.dumps(entry), flush=True)
    finally:
        _build._libs[key] = real
    line = json.dumps(result)
    print(line)
    pathlib.Path(opts.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
