"""Time mstep_stats' two builds on the card, in turns:

    python3 tools/torch_mstep_ab.py [OUT.json]

``vlgp_tpu_torch/csrc/mstep.cu`` launches, for Z <= 8, a copy of the stats
kernel with Z fixed at compile time (its loops over the latents unrolled);
compiled with ``-DVLGP_MSTEP_GENERIC`` it launches the copy that reads Z
at run time, as it does for any Z above 8.  This script builds both into
``vlgp_tpu_torch/_build/ab/``, checks that they give the same partial sums
within float32 rounding, and times each ([median, min, max] ms over 10
calls, each between its own pair of CUDA events, ``chip_smoke.time_ms``)
in the order generic, specialized, specialized, generic at the flagship's
M-step shape (Z5 S2000 T50 Y100 X1, inputs drawn as chip_smoke's 6c
draws them) and at Z3 and Z8.  Prints one JSON line with the card's name
and power limit.  Needs a CUDA device and nvcc.
"""
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

SHAPES = ((2000, 50, 100, 5, 1), (2000, 50, 100, 3, 1), (2000, 50, 100, 8, 1))


def build(tag, flags):
    from vlgp_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "ab" / f"libmstep_{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
                    str(_build.CSRC / "mstep.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in _build._SIGNATURES["mstep"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.ns_error_string.argtypes = [ctypes.c_int]
    lib.ns_error_string.restype = ctypes.c_char_p
    return lib


def main():
    from vlgp_tpu_torch.ops import _build
    from vlgp_tpu_torch.ops import mstep as om

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    libs = {"generic": build("generic", ["-DVLGP_MSTEP_GENERIC"]),
            "specialized": build("specialized", [])}
    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    out = {"card": card}
    for S, T, Y, Z, X in SHAPES:
        args = cs.mstep_case(S, T, Y, Z, X, torch.float32, device, gen.manual_seed(0))
        parts, times = {}, {}
        for tag in ("generic", "specialized", "specialized", "generic"):
            _build._libs["mstep"] = libs[tag]
            parts[tag] = om.mstep_stats(*args, partial=True).part
            times.setdefault(tag, []).append(cs.time_ms(
                lambda: om.mstep_stats(*args, partial=True)))
        d = float((parts["generic"] - parts["specialized"]).abs().max()
                  / parts["generic"].abs().max())
        out[f"Z{Z} S{S} T{T} Y{Y} X{X}"] = {"rel_gap": d, **times}
        print(f"Z{Z}: {times} gap {d:.2e}", flush=True)
    _build._libs.pop("mstep")
    line = json.dumps(out)
    print(line)
    if len(sys.argv) > 1:
        pathlib.Path(sys.argv[1]).write_text(line + "\n")


if __name__ == "__main__":
    main()
