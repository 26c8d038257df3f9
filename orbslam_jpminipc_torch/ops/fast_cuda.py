"""Build, bind and launch the CUDA FAST-9/16 + 3x3 nonmax + cell-select kernel.

The kernel (csrc/fast.cu) replaces the reference package's Pallas TPU
kernel, orbslam_jpminipc_tpu/ops/fast_pallas.py:fast_detect_tpu, and the
per-cell high/low threshold select the extractor does around it. Its plain
PyTorch version is ops/fast.py (`level_scores`: `fast_score_map` +
`nonmax_3x3` + `border_mask` + `cell_select`), and the two are
bit-identical.

`fast_level_scores` scores every level of a pyramid in one launch;
`fast_detect` is the same kernel over one level without the select.

The source is compiled at first use with nvcc into a shared library with a
plain C interface (for sm_90a, into build/torch_kernels/ under the checkout,
named by a hash of the source and flags) and loaded with ctypes. Nothing is
built or imported from the GPU toolchain when this module is imported.

`LAUNCHES` counts the kernel launches made by the two wrappers. A launch
recorded into a captured program (utils/program.py) counts at each replay of
that program, where the kernel runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from ..utils.program import count_launch

LAUNCHES = 0

TILE = 32        # the kernel's tile edge: the cell edge it can vote over
MAX_LEVELS = 16  # rows of the level table passed by value (csrc/fast.cu)

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "fast.cu"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class _Level(ctypes.Structure):  # FastLevel in csrc/fast.cu
    _fields_ = [("inp", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("H", ctypes.c_int), ("W", ctypes.c_int), ("tiles_x", ctypes.c_int),
                ("tile_begin", ctypes.c_int), ("tile_end", ctypes.c_int),
                ("vec", ctypes.c_int)]


class _Table(ctypes.Structure):  # FastTable in csrc/fast.cu
    _fields_ = [("lv", _Level * MAX_LEVELS), ("n_levels", ctypes.c_int),
                ("n_tiles", ctypes.c_int)]


_lock = threading.Lock()
_lib = None
# what nvcc printed for the last build of this process (ptxas register and
# shared-memory report); empty when the library was already built
build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path() -> Path:
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libfast_{tag}.so"


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        build_log = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}:\n"
                    f"{proc.stdout}{proc.stderr}")
            build_log = proc.stdout + proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.fast_levels_launch.argtypes = [
            ctypes.POINTER(_Table), ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fast_levels_launch.restype = ctypes.c_int
        lib.fast_max_levels.argtypes = []
        lib.fast_max_levels.restype = ctypes.c_int
        if lib.fast_max_levels() != MAX_LEVELS:
            raise RuntimeError("csrc/fast.cu and fast_cuda.py disagree on the table's size")
        lib.fast_error_string.argtypes = [ctypes.c_int]
        lib.fast_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check_levels(levels, name: str) -> tuple:
    """Raise on what the kernel does not take; the levels' shapes."""
    index, shapes = None, []
    for img in levels:
        if not isinstance(img, torch.Tensor) or not img.is_cuda:
            dev = img.device if isinstance(img, torch.Tensor) else type(img).__name__
            raise ValueError(f"{name} needs a CUDA tensor, got {dev}")
        shape = tuple(img.shape)
        if (img.dtype != torch.float32 or len(shape) != 2 or 0 in shape
                or not img.is_contiguous()):
            raise ValueError(
                f"{name} needs a contiguous non-empty 2-D float32 tensor, got "
                f"{img.dtype} {shape} contiguous={img.is_contiguous()}")
        if index is None:
            index = img.get_device()
        elif img.get_device() != index:
            raise ValueError(f"{name}: the levels lie on several devices")
        shapes.append(shape)
    return tuple(shapes)


def _count(n: int):
    global LAUNCHES
    LAUNCHES += n


def _launch(levels, shapes, threshold: float, fast_th: float | None,
            border: int) -> list[torch.Tensor]:
    """One launch over `levels` (checked by the caller, which passes their
    shapes); the per-cell select runs in the kernel when `fast_th` is given."""
    lib = build()
    dev = levels[0].device
    offsets, total = [], 0
    for h, w in shapes:
        offsets.append(total)
        total += h * w
    flat = torch.empty(total, dtype=torch.float32, device=dev)
    tab = _Table()
    base, tile = flat.data_ptr(), 0
    for lv, img, (h, w), off in zip(tab.lv, levels, shapes, offsets):
        ptr = img.data_ptr()
        lv.inp, lv.out = ptr, base + 4 * off
        lv.H, lv.W, lv.tiles_x = h, w, -(-w // TILE)
        lv.tile_begin = tile
        tile += lv.tiles_x * -(-h // TILE)
        lv.tile_end = tile
        # 16-byte copies need aligned rows: see csrc/fast.cu
        lv.vec = int(w % 4 == 0 and ptr % 16 == 0)
    tab.n_levels, tab.n_tiles = len(shapes), tile
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fast_levels_launch(
        ctypes.byref(tab), float(threshold), float(0.0 if fast_th is None else fast_th),
        max(int(border), 0), int(fast_th is not None), dev.index, stream)
    if err != 0:
        raise RuntimeError(
            f"fast_levels_launch failed: {lib.fast_error_string(err).decode()}")
    count_launch(_count)
    return [flat.as_strided(shape, (shape[1], 1), off) for shape, off in zip(shapes, offsets)]


def fast_level_scores(levels, fast_th: float, fast_min_th: float, border: int = 0,
                      cell: int = TILE) -> list[torch.Tensor]:
    """The extractor's score map of every pyramid level, in one launch.

    `levels` are CUDA (H, W) float32 images of any sizes. Per level: the
    nonmax-suppressed FAST-9/16 score at `fast_min_th`, zero within `border`
    pixels of the edge, and in each `cell` x `cell` cell that holds a corner
    with score + 1 > `fast_th` only those corners. The outputs are views of
    one allocation. With `cell` equal to the kernel's tile (32) the select
    runs inside the kernel; for another `cell` the kernel writes the
    low-threshold maps and the select follows as tensor operations.
    Launches on the current stream.
    """
    levels = list(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fast_level_scores takes 1 to {MAX_LEVELS} levels, got {len(levels)}")
    shapes = _check_levels(levels, "fast_level_scores")
    # the reference kernel's contract (fast_pallas.py asserts it); real FAST
    # thresholds are >= 7
    if not fast_min_th > 0:
        raise ValueError(f"FAST threshold must be positive, got {fast_min_th}")
    if cell < 1:
        raise ValueError(f"cell must be positive, got {cell}")
    if cell == TILE:
        return _launch(levels, shapes, fast_min_th, fast_th, border)
    from .fast import cell_select

    return [cell_select(lo, fast_th, cell)
            for lo in _launch(levels, shapes, fast_min_th, None, border)]


def fast_detect(img: torch.Tensor, threshold: float, border: int = 0) -> torch.Tensor:
    """Nonmax-suppressed FAST-9/16 score map of a CUDA (H, W) float32 image,
    zero within `border` pixels of the edge. Launches on the current stream."""
    shapes = _check_levels((img,), "fast_detect")
    if not threshold > 0:
        raise ValueError(f"FAST threshold must be positive, got {threshold}")
    return _launch([img], shapes, threshold, None, border)[0]
