"""Time the three launches of ns_gram's long-T design one by one on the card:

    python3 tools/torch_ns_gram_pieces.py [OUT.json] [--variant NAME=FLAGS ...]

``ns_gram_pairs`` runs its Gram GEMM, its Newton-Schulz solve and its v
GEMM as one C call, so this script compiles a copy of
``vlgp_tpu_torch/csrc/ns_inverse.cu`` with more C entry points appended
into ``vlgp_tpu_torch/_build/pieces/``: ``exp_gram`` and ``exp_v`` run the
tiled path's GEMMs (the tiled kernels) at a tile shape of 128 x 128, 128 x
64, 64 x 128 or 64 x 64, ``exp_pairs`` one GEMM of the streaming path
(``launch_pairs``) under the plan of ``ops/spd.py:pairs_stream_plan``, and
``exp_solve`` the solve.  It prints what ``-Xptxas -v`` says of the GEMM
kernels, and one JSON line with the card's name and power limit and, per
case, [median, min, max] ms over 10 calls, each between its own pair of CUDA
events (``chip_smoke.time_ms``): ``torch.matmul`` on the same operands in
full FP32 (the yardstick, and a check: each output of either product is
one FMA chain over k, so the bits agree), the tiled path at every tile
shape, the streaming path and the tiled path at the tile the tiled path picks in
turns (tiled, stream, stream, tiled), and the solve in probe + v, warm 4 +
v and cold 16 beside ``ns_packed``'s probe, at Z5 S2500 T1000 R50 (a
leave-one-neuron-out chunk), Z5 S100 T1000 R50 (the final inference) and
Z5 S500 T200 R50; the streaming GEMM also with 4-byte copies of A in place
of the tensor boxes, and at every other tile shape.  Each ``--variant
NAME=FLAGS`` compiles one more copy with those nvcc flags (e.g.
``cyc=-DPG_DIAG_CYCLES``, which prints block 0's cycle split), all builds
at once, and its streaming GEMMs are timed in the same turns (tiled, the
package's build, each variant, the other tile shapes, then back in reverse
order), their outputs checked against torch.matmul bit for bit.  Needs a
CUDA device and nvcc.
"""
import ctypes
import functools
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

TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
SHAPES = ((5, 2500, 1000, 50), (5, 100, 1000, 50), (5, 500, 200, 50))

_ENTRIES = "\n".join(
    ['extern "C" {']
    + [f"int exp_{kind}(const float* G, const float* A, float* C, int Z, int S, int T, int R, "
       f"int tile, void* stream) {{\n  cudaStream_t st = (cudaStream_t)stream;\n  switch (tile) {{"
       + "".join(f"\n    case {i}: return (int)launch_{fn}<{bm}, {bn}>(G, A, C, Z, S, T, R, st);"
                 for i, (bm, bn) in enumerate(TILES))
       + "\n  }\n  return (int)cudaErrorInvalidValue;\n}"
       for kind, fn in (("gram", "gram_pairs"), ("v", "v_pairs"))]
    + ["""int exp_pairs(int kind, const float* G, const float* A, float* C, int Z, int S, int T,
              int R, int shape, int grid, int stages, int copy16, void* stream) {
  return (int)launch_pairs(kind, shape, G, A, C, Z, S, T, R, grid, stages, copy16,
                           (cudaStream_t)stream);
}
int exp_solve(float* Ap, const float* x0, float* X, float* resid, int B, int R, int iters,
              int resid_only, int want_v, void* stream) {
  const size_t smem = packed_smem(R);
  cudaError_t err = cudaFuncSetAttribute(ns_gram_solve_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ns_gram_solve_kernel<<<B, tiled_threads(R), smem, (cudaStream_t)stream>>>(
      Ap, x0, X, resid, R, iters, resid_only, want_v);
  return (int)cudaGetLastError();
}
}
"""])


def build(variants=()):
    """Compile ns_inverse.cu with the entry points above, as it is and once
    per (name, flags) variant, all at once; returns [(name, library)]."""
    from vlgp_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "pieces"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "ns_inverse.cu").read_text()
    anchor = '}  // namespace\n\nextern "C" {'
    if anchor not in src:
        raise RuntimeError("ns_inverse.cu has no anonymous-namespace end to append after")
    src = src.replace(anchor, '}  // namespace\n\n' + _ENTRIES + '\nextern "C" {', 1)
    (out / "ns_inverse_pieces.cu").write_text(src)
    builds = [("stream", [])] + [(name, flags.split()) for name, flags in variants]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                               "-I", str(_build.CSRC), "-o",
                               str(out / f"libns_inverse_pieces_{name}.so"),
                               str(out / "ns_inverse_pieces.cu")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, flags in builds]
    libs = []
    for (name, _), proc in zip(builds, procs):
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: {err[-4000:]}")
        lines = err.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    k in line for k in ("pairs_kernel", "v_kernel", "solve_kernel", "gemm_kernel")):
                print(name, "|", line.split("'")[1], "|", lines[i + 2].strip(), "|",
                      lines[i + 3].strip(), flush=True)
        lib = ctypes.CDLL(str(out / f"libns_inverse_pieces_{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in ("exp_gram", "exp_v"):
            getattr(lib, fn).argtypes = [p] * 3 + [i] * 5 + [p]
        lib.exp_pairs.argtypes = [i] + [p] * 3 + [i] * 8 + [p]
        lib.exp_solve.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.ns_packed.argtypes = [p] * 4 + [i] * 5 + [p]
        libs.append((name, lib))
    return libs


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("torch_ns_gram_pieces.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    variants = [args[k + 1].split("=", 1) for k, a in enumerate(args) if a == "--variant"]
    outfile = next((a for k, a in enumerate(args)
                    if not a.startswith("--") and (k == 0 or args[k - 1] != "--variant")), None)
    libs = build(variants)
    lib = libs[0][1]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    from vlgp_tpu_torch.ops import spd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    ptr = lambda t: None if t is None else ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream_ = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"card": smi.splitlines()[0]}
    for Z, S, T, R in SHAPES:
        tag = f"Z{Z} S{S} T{T} R{R}"
        gen.manual_seed(0)
        G = cs.realistic_factor(Z, T, R, dev)
        w = torch.rand((Z, S, T), generator=gen, device=dev)
        P = R * (R + 1) // 2
        i, j = torch.triu_indices(R, R, device=dev)
        K = (G[:, :, i] * G[:, :, j]).contiguous()
        Xp = torch.randn((Z, S, P), generator=gen, device=dev)
        ref_A, ref_v = torch.matmul(w, K), torch.matmul(Xp, K.mT)
        out[f"{tag} torch.matmul(w, K)"] = cs.time_ms(lambda: torch.matmul(w, K))
        out[f"{tag} torch.matmul(Xp, K')"] = cs.time_ms(lambda: torch.matmul(Xp, K.mT))
        A = torch.empty((Z, S, P), device=dev)
        v = torch.empty((Z, S, T), device=dev)
        plan = spd.pairs_stream_plan(Z, S, T, R, nsm)
        out[f"{tag} plan"] = plan._asdict()
        for kind, gemm, ops, C, ref in ((0, plan.gram, (G, w), A, ref_A),
                                        (1, plan.v, (G, Xp), v, ref_v)):
            name = ("gram", "v")[kind]
            M_, N_, K_ = (S, P, T) if kind == 0 else (S, T, P)

            def stream(lib=lib, kind=kind, gemm=gemm, ops=ops, C=C):
                return lib.exp_pairs(kind, ptr(ops[0]), ptr(ops[1]), ptr(C), Z, S, T, R,
                                     gemm.shape, gemm.grid, gemm.stages,
                                     int(gemm.copy == "tma"), stream_())

            tile = 0 if Z * -(-M_ // 128) * -(-N_ // 128) >= 2 * nsm else 1  # wide_tiles
            exp = (lib.exp_gram, lib.exp_v)[kind]

            def tiled(exp=exp, ops=ops, C=C, tile=tile):
                return exp(ptr(ops[0]), ptr(ops[1]), ptr(C), Z, S, T, R, tile, stream_())

            # the plan's GEMM in every build, then every other tile shape
            runs = {f"tiled {TILES[tile][0]}x{TILES[tile][1]}": tiled}
            for vname, vlib in libs:
                runs[f"{vname} (plan)"] = functools.partial(stream, vlib)
            runs["stream 4-byte copies"] = functools.partial(stream, lib,
                                                             gemm=gemm._replace(copy="async4"))
            for shape in range(len(spd._PAIRS_SHAPES)):
                cand = spd._pairs_candidate(kind, shape, Z, M_, N_, K_, R, nsm)
                if cand is not None and shape != gemm.shape:
                    g = cand[1]
                    runs[f"stream {g.bm}x{g.bn} ({g.grid} blocks, {g.stages} stages)"] = (
                        functools.partial(stream, lib, gemm=g))
            for which, fn in list(runs.items())[1:]:
                C.fill_(float("nan"))
                rc = fn()
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"{tag} {name} {which}: launch failed {rc}")
                out[f"{tag} {name} {which} bits equal torch.matmul"] = torch.equal(C, ref)
            order = list(runs) + list(runs)[::-1]
            for turn, which in enumerate(order):
                out[f"{tag} {name} {which} turn {turn}"] = cs.time_ms(runs[which])
        for tile, (bm, bn) in enumerate(TILES):
            rc = (lib.exp_gram(ptr(G), ptr(w), ptr(A), Z, S, T, R, tile, stream_()),
                  lib.exp_v(ptr(G), ptr(Xp), ptr(v), Z, S, T, R, tile, stream_()))
            torch.cuda.synchronize()
            if any(rc):
                raise RuntimeError(f"{tag} tile {bm}x{bn}: launch failed {rc}")
            out[f"{tag} {bm}x{bn} bits equal torch.matmul (gram, v)"] = [
                torch.equal(A, ref_A), torch.equal(v, ref_v)]
            out[f"{tag} {bm}x{bn} gram"] = cs.time_ms(
                lambda: lib.exp_gram(ptr(G), ptr(w), ptr(A), Z, S, T, R, tile, stream_()))
            out[f"{tag} {bm}x{bn} v"] = cs.time_ms(
                lambda: lib.exp_v(ptr(G), ptr(Xp), ptr(v), Z, S, T, R, tile, stream_()))
        B = Z * S
        Ap = (ref_A / ref_A.abs().amax() * 0.1).contiguous()  # I + A well inside NS's reach
        X = torch.empty((B, R, R), device=dev)
        resid = torch.empty(B, device=dev)
        x0 = (0.9 * torch.eye(R, device=dev)).expand(B, R, R).contiguous()
        for mode, (x, Xo, iters, probe, want_v) in (("probe + v", (x0, None, 0, 1, 1)),
                                                     ("warm 4 + v", (x0, X, 4, 0, 1)),
                                                     ("cold 16", (None, X, 16, 0, 0))):
            buf = Ap.clone()
            out[f"{tag} solve {mode}"] = cs.time_ms(lambda: lib.exp_solve(
                ptr(buf), ptr(x), ptr(Xo), ptr(resid), B, R, iters, probe, want_v, stream_()))
        M = torch.zeros((B, R, R), device=dev)
        M[:, i, j] = Ap.reshape(B, P)
        M[:, j, i] = Ap.reshape(B, P)
        out[f"{tag} ns_packed probe"] = cs.time_ms(lambda: lib.ns_packed(
            ptr(M), ptr(x0), None, ptr(resid), B, R, 0, 1, 1, stream_()))
    line = json.dumps(out)
    print(line)
    if outfile:
        pathlib.Path(outfile).write_text(line + "\n")


if __name__ == "__main__":
    main()
