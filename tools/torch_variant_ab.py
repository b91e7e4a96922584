"""Time builds of one CUDA source of vlgp_tpu_torch on the card, in turns:

    python3 tools/torch_variant_ab.py OUT.json --source {mstep,hstep_stat,estep} \\
        --variant NAME[@FILE.cu][=FLAGS] [--variant ...]

Each variant is ``csrc/<source>.cu`` (or FILE.cu, e.g. the same source of
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
    inference's trials (Z5 S100 T1000 Y100 R50), Poisson channels, inputs
    as chip_smoke's 6e draws them (``estep_case``), contiguous.

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

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def parse_variant(spec, source):
    """NAME[@FILE.cu][=FLAGS] -> (name, source file, [flags])."""
    from vlgp_tpu_torch.ops import _build

    head, _, flags = spec.partition("=")
    name, _, path = head.partition("@")
    src = pathlib.Path(path).resolve() if path else _build.CSRC / f"{source}.cu"
    return name, src, flags.split()


def tree_signatures(src, source):
    """The ctypes prototypes of ``source``'s functions as the variant's own
    tree declares them (``ops/_build.py`` beside its ``csrc/``), or as this
    tree does for a FILE.cu outside a package."""
    from vlgp_tpu_torch.ops import _build

    table = pathlib.Path(src).resolve().parents[1] / "ops" / "_build.py"
    if not table.is_file():
        return _build._SIGNATURES[source]
    spec = importlib.util.spec_from_file_location(f"_variant_build_{abs(hash(table))}", table)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._SIGNATURES[source]


def build_all(source, variants):
    """Compile every variant at once; {name: loaded library}."""
    from vlgp_tpu_torch.ops import _build

    outdir = _build.BUILD_DIR / "ab"
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src, flags in variants:
        out = outdir / f"lib{source}_{name}.so"
        procs[name] = (out, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
                                              str(out), str(src)], stderr=subprocess.PIPE,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        lib = ctypes.CDLL(str(out))
        sigs = tree_signatures(next(v[1] for v in variants if v[0] == name), source)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.ns_error_string.argtypes = [ctypes.c_int]
        lib.ns_error_string.restype = ctypes.c_char_p
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


def device_us(fn, kernel):
    """The device time in us of one call of ``fn``: the kernels whose name
    holds ``kernel`` in the trace of 20 calls, over 20."""
    _, _, by_name = cs.trace_kernels(lambda: [fn() for _ in range(20)])
    return 1e6 * sum(t for k, t in by_name.items() if kernel in k) / 20


def rel(got, ref):
    return max(cs._rel(g.double(), r.double())[0] for g, r in zip(got, ref))


def cases(source, device, gen):
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

        for S, T, R in ((2000, 50, 40), (100, 1000, 50)):
            proj, step = cs.estep_case(S, T, 100, 5, R, 1, torch.float32, device,
                                       gen.manual_seed(0))
            proj = [t.contiguous() for t in proj]
            step = [step[0], oe._estep_project_plain(*proj)] + step[2:]
            step = [t.contiguous() if torch.is_tensor(t) else t for t in step]
            p64, s64 = up(proj), up(step)
            out.append((f"estep_project Z5 S{S} T{T} Y100", lambda a=proj: oe.estep_project(*a),
                        lambda a=proj: [oe.estep_project(*a)],
                        lambda a=p64: [oe._estep_project_plain(*a)],
                        lambda a=proj: [oe._estep_project_plain(*a)], cs.time_ms, None))
            out.append((f"estep_step Z5 S{S} T{T} Y100 R{R}", lambda a=step: oe.estep_step(*a),
                        lambda a=step: list(oe.estep_step(*a)),
                        lambda a=s64: list(oe._estep_step_plain(*a)),
                        lambda a=step: list(oe._estep_step_plain(*a)), cs.time_ms, None))
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
    ap.add_argument("--source", choices=("mstep", "hstep_stat", "estep"), required=True)
    ap.add_argument("--variant", action="append", required=True)
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
    real = _build._libs[opts.source]
    try:
        for tag, timed, run, plain64, plain, timer, dev_us in cases(opts.source, device, gen):
            ref64 = plain64()
            entry = {"plain_float32_vs_float64": rel(plain(), ref64),
                     "plain_ms": [timer(plain)]}
            first = None
            for name in names + names[::-1]:
                _build._libs[opts.source] = libs[name]
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
            entry["plain_ms"].append(timer(plain))
            result[tag] = entry
            print(tag, json.dumps(entry), flush=True)
    finally:
        _build._libs[opts.source] = real
    line = json.dumps(result)
    print(line)
    pathlib.Path(opts.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
