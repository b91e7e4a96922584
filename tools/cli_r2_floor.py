"""Recovery R^2 of a command-line fit of chip_smoke.py's flagship workload,
cut down, by either package:

    python3 tools/cli_r2_floor.py PACKAGE NTRIAL LENGTH YDIM [--device DEV]

PACKAGE is ``vlgp_tpu`` or ``vlgp_tpu_torch``.  Writes the first NTRIAL
trials of ``chip_smoke.make_workload(length=LENGTH, ydim=YDIM)`` (seed 0,
5 latents, ``y`` only) as a stacked npz, runs ``python3 -m PACKAGE fit
in.npz out.npz 5`` at the command line's defaults (``--device DEV`` is
passed to ``vlgp_tpu_torch``), reads ``data.mu`` from the result (both
packages write one npz layout) and prints one JSON line with the
lstsq-aligned R^2 against the true latents and the fit's wall seconds.
Files go to a temporary directory inside the checkout, removed at the end.
"""
import importlib.util
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def main():
    args = list(sys.argv[1:])
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        del args[i:i + 2]
    package, ntrial, length, ydim = args[0], int(args[1]), int(args[2]), int(args[3])
    trials, _, zt = cs.make_workload(ntrial=ntrial, length=length, ydim=ydim)
    with tempfile.TemporaryDirectory(prefix=".cli_r2_", dir=HERE) as tmp:
        fin, fout = pathlib.Path(tmp) / "in.npz", pathlib.Path(tmp) / "out.npz"
        np.savez(fin, y=np.stack([t["y"] for t in trials]))
        cmd = [sys.executable, "-m", package, "fit", str(fin), str(fout), str(cs.ZDIM), "--quiet"]
        if device is not None:
            cmd += ["--device", device]
        tic = time.perf_counter()
        subprocess.run(cmd, cwd=HERE, check=True)
        wall = time.perf_counter() - tic
        with np.load(fout) as z:
            mu = z["data.mu"].reshape(-1, cs.ZDIM)
            header = json.loads(bytes(z["header"].tobytes()).decode())
    print(json.dumps({"package": package, "ntrial": ntrial, "length": length, "ydim": ydim,
                      "zdim": cs.ZDIM, "device": device, "em_iterations": header["runtime"]["it"],
                      "r2": cs.r2_aligned(mu, zt), "wall_s": wall}))


if __name__ == "__main__":
    main()
