"""Native (C++) runtime for the sequential map-graph maintenance loops
(counterpart of orbslam_jpminipc_tpu/native/__init__.py).

`mapgraph.cpp` (a copy of the reference package's source) walks the
MapState's numpy buffers in place: redundant-keyframe culling, local-BA
observation assembly and batched AddObservation. It is host code, not a
device kernel. At first use it is built with g++ into build/torch_kernels/
under the checkout (named by a hash of the source and flags) and loaded
with ctypes; without a toolchain the pure-Python loops of the callers
apply, with the same result. `load_library` does the same for the other
host sources here (`png_unfilter.cpp`, used by io/png.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("mapgraph.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# no -march=native: the library must load on whichever host the checkout
# (and its build directory) lands on
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path(src: Path = _SRC) -> Path:
    tag = hashlib.sha256(src.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{tag}.so"


def _build(src: Path, so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except Exception as e:  # noqa: BLE001
        print(f"[native] {src.name} build failed ({e}); using the Python version",
              file=sys.stderr)
        return False


def load_library(src: Path):
    """Build `src` (at first use) and load it with ctypes; None without a
    toolchain."""
    so = library_path(src)
    if not so.exists() and not _build(src, so):
        return None
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:
        print(f"[native] {so.name} load failed ({e})", file=sys.stderr)
        return None


def get_lib():
    """The loaded library, or None (the Python fallbacks apply)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        lib = load_library(_SRC)
        if lib is None:
            _failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.cull_redundant_keyframes.restype = ctypes.c_int
        lib.cull_redundant_keyframes.argtypes = [
            i32p, ctypes.c_int, i32p, i32p, u8p, i32p, i32p, u8p, i32p, i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, i32p,
        ]
        lib.build_ba_obs.restype = ctypes.c_int
        lib.build_ba_obs.argtypes = [
            i64p, ctypes.c_int, i32p, i32p, i32p, ctypes.c_int,
            i32p, i32p, i32p, i32p, i32p, ctypes.c_int,
        ]
        lib.add_observations.restype = ctypes.c_int
        lib.add_observations.argtypes = [
            i32p, i32p, ctypes.c_int, ctypes.c_int,
            i32p, i32p, i32p, u8p, ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pu8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def cull_redundant_keyframes_native(state, candidates, redundancy=0.9):
    """Native KeyFrameCulling over the MapState's buffers. Returns the list
    of erased keyframes, or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    cands = np.ascontiguousarray(np.asarray(candidates, np.int32))
    out = np.empty(max(len(cands), 1), np.int32)
    state._covis_cache = None  # C++ erases KFs/observations directly
    n = lib.cull_redundant_keyframes(
        _p32(cands), len(cands),
        _p32(state.kf_point), _p32(state.kf_level), _pu8(state.kf_valid.view(np.uint8)),
        _p32(state.mp_obs_kf), _p32(state.mp_obs_feat), _pu8(state.mp_valid.view(np.uint8)),
        _p32(state.mp_gen), _p32(state.kf_parent),
        state.max_kf, state.n_feat, state.max_mp, state.max_obs,
        ctypes.c_float(redundancy), _p32(out),
    )
    return [int(x) for x in out[:n]]


def build_ba_obs_native(state, pts, kf_index_of, max_out):
    """Native local-BA observation assembly. Returns arrays
    (obs_kf, obs_pt, obs_feat, src_p, src_k) of length n, or None."""
    lib = get_lib()
    if lib is None:
        return None
    pts64 = np.ascontiguousarray(np.asarray(pts, np.int64))
    kidx = np.ascontiguousarray(np.asarray(kf_index_of, np.int32))
    outs = [np.empty(max_out, np.int32) for _ in range(5)]
    n = lib.build_ba_obs(
        _p64(pts64), len(pts64),
        _p32(state.mp_obs_kf), _p32(state.mp_obs_feat), _p32(kidx),
        state.max_obs, *[_p32(o) for o in outs], max_out,
    )
    return tuple(o[:n] for o in outs)


def add_observations_native(state, kf, feats, points):
    """Native batch AddObservation. Returns the inserted count, or None."""
    lib = get_lib()
    if lib is None:
        return None
    f32 = np.ascontiguousarray(np.asarray(feats, np.int32))
    p32 = np.ascontiguousarray(np.asarray(points, np.int32))
    state._covis_cache = None  # C++ writes kf_point/mp_obs directly
    return lib.add_observations(
        _p32(f32), _p32(p32), len(f32), int(kf),
        _p32(state.kf_point), _p32(state.mp_obs_kf), _p32(state.mp_obs_feat),
        _pu8(state.mp_valid.view(np.uint8)), state.n_feat, state.max_obs,
    )
