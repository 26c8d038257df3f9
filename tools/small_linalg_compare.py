#!/usr/bin/env python3
"""Time the small-matrix Jacobi kernel (orbslam_jpminipc_torch/csrc/
small_linalg.cu) against another build of it, an earlier commit's source,
on the main path's calls, in one process on one card.

    git archive <commit> | tar -x -C chip_archive/parent     # .gitignore lists it
    python3 tools/small_linalg_compare.py \
        --other chip_archive/parent/orbslam_jpminipc_torch/csrc/small_linalg.cu

The calls are chip_smoke.py's `_sl_main_path_calls`: every eigh and svd of
one `solve_pnp` (a relocalization candidate's RANSAC, 256 hypotheses),
`solve_sim3` and `initialize` on seeded scenes, recorded on the card. Both
libraries are built with the wrapper's nvcc flags and launched through the
same ctypes call. Per case (each call alone, and one `solve_pnp`'s calls
as one): CUDA-event ms (median of batches) and device ms
(torch.profiler), taken in the order other, this, this, other; the bound
(chip_smoke.py:_sl_bound, from the plain version's sweeps on the same
input); torch.linalg's ms on the same inputs (it also reads the host); the
largest difference between the two builds' eigenvalues or singular values
relative to |A|; and the card's name and power limit. One JSON line per case, all of them in
chiprun_out/small_linalg_compare.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sl_eigh_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.sl_eigh_launch.restype = i32
    lib.sl_svd_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.sl_svd_launch.restype = i32
    return lib


def _launch(torch, lib, kind, A, kw):
    """One launch of `lib`'s kernel on A (batch, n, n), as the wrapper does."""
    from orbslam_jpminipc_torch.solvers import small_linalg as plain

    batch, n = A.shape[0], A.shape[-1]
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "eigh":
        w = torch.empty((batch, n), device=A.device)
        V = torch.empty((batch, n, n), device=A.device)
        err = lib.sl_eigh_launch(A.data_ptr(), w.data_ptr(), V.data_ptr(), batch, n,
                                 plain.EIGH_SWEEPS, int(kw.get("lapack_signs", False)),
                                 A.device.index, stream)
        out = (w, V)
    else:
        U = torch.empty((batch, n, n), device=A.device)
        S = torch.empty((batch, n), device=A.device)
        Vt = torch.empty((batch, n, n), device=A.device)
        err = lib.sl_svd_launch(A.data_ptr(), U.data_ptr(), S.data_ptr(), Vt.data_ptr(), batch,
                                n, plain.SVD_SWEEPS, A.device.index, stream)
        out = (U, S, Vt)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="the other build's small_linalg.cu")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "small_linalg_compare.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("small_linalg_compare needs a CUDA device")
    import chip_smoke as cs
    from orbslam_jpminipc_torch.ops import small_linalg_cuda as k
    from orbslam_jpminipc_torch.solvers import small_linalg as plain
    from orbslam_jpminipc_torch.utils import nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    other_src = Path(args.other).resolve()
    builds = {"this": k.library_path(), "other": nvcc.library_path(
        other_src, k.NVCC_FLAGS, "libsmall_linalg_other")}
    logs = {"this": nvcc.compile_library(k.SOURCE, k.NVCC_FLAGS, builds["this"]),
            "other": nvcc.compile_library(other_src, k.NVCC_FLAGS, builds["other"])}
    libs = {name: _bind(path) for name, path in builds.items()}
    for name, text in logs.items():
        print(f"[build] {name}: {text.strip()}", flush=True)

    calls = cs._sl_main_path_calls(torch)
    cases = [(f"{site} {kind} {A.shape[-1]}x{A.shape[-1]} x{A.shape[0]}", [(kind, A, kw)])
             for site, kind, A, kw in calls]
    cases.insert(0, ("solve_pnp, its calls as one",
                     [(kind, A, kw) for site, kind, A, kw in calls if site == "solve_pnp"]))
    rows = []
    for label, group in cases:
        run = {name: (lambda lib=lib: [_launch(torch, lib, kind, A, kw)
                                       for kind, A, kw in group]) for name, lib in libs.items()}
        times = {"this": [], "other": []}
        for name in ("other", "this", "this", "other"):
            times[name].append((cs._event_ms(torch, run[name], n=10, batch=5, warm=3),
                                cs._device_ms(torch, run[name], n=5)))
        # the values' largest difference relative to |A| (eigenvalues or
        # singular values; the vectors are held by chip_smoke.py)
        diff = 0.0
        for (kind, A, kw), a, b in zip(group, run["this"](), run["other"]()):
            x, y = (a[0], b[0]) if kind == "eigh" else (a[1], b[1])
            scale = torch.linalg.matrix_norm(A.double()).clamp_min(1e-30)[:, None]
            d = (x.double() - y.double()).abs() / scale
            ok = torch.isfinite(d)
            diff = max(diff, float(d[ok].max()) if ok.any() else 0.0)
        bound = {"bytes": 0, "operations": 0, "bytes_ms": 0.0, "operations_ms": 0.0}
        for kind, A, kw in group:
            s0 = dict(plain.SWEEPS)
            (plain.eigh_small if kind == "eigh" else plain.svd_small)(A, **kw)
            b = cs._sl_bound(kind, A.shape[0], A.shape[-1], plain.SWEEPS[kind] - s0[kind])
            for key in bound:
                bound[key] += b[key]

        def library():
            for kind, A, kw in group:
                (torch.linalg.eigh if kind == "eigh" else torch.linalg.svd)(A)

        mean = lambda xs: sum(xs) / len(xs)
        row = {"case": label, "launches": len(group),
               "this_ms": mean([t[0] for t in times["this"]]),
               "this_device_ms": mean([t[1] for t in times["this"]]),
               "other_ms": mean([t[0] for t in times["other"]]),
               "other_device_ms": mean([t[1] for t in times["other"]]),
               "runs": times, "library_ms": cs._event_ms(torch, library, n=5, batch=2, warm=2),
               "bound_ms": max(bound["bytes_ms"], bound["operations_ms"]),
               "bound_by": "bytes" if bound["bytes_ms"] >= bound["operations_ms"]
               else "operations", **bound, "max_diff_rel": diff, "card": smi}
        row["device_speedup"] = row["other_device_ms"] / max(row["this_device_ms"], 1e-12)
        rows.append(row)
        print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "other": str(other_src), "builds": logs, "rows": rows}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
