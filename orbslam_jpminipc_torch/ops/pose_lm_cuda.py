"""Build, bind and launch the pose LM kernel (csrc/pose_lm.cu): the whole
chi^2-regating pose optimization of `solvers/pose_opt.py` (every round and
iteration) as one launch, one thread block a problem.

It takes the place of the plain version, `pose_opt.optimize_pose_plain`,
some 280 small kernels an iteration, on every CUDA caller of
`pose_opt.optimize_pose`: the fused step's passes, the host path's
tracking programs and relocalization's candidate and refinement rungs. The
reference leaves the solve to XLA (`lax.while_loop`); there is no Pallas
kernel. On a CUDA tensor `optimize_pose` launches the kernel (raising on
what it does not take); on a CPU tensor it runs the plain version. Nothing
falls back.

The source is compiled at first use with nvcc into a shared library with a
plain C interface (for sm_90a, into build/torch_kernels/ under the
checkout) and loaded with ctypes; nothing is built when this module is
imported. `LAUNCHES` counts the kernel's launches, and the tracer's counter
`pose_lm_launches` with it (a launch captured into a program counts at
each replay of it, utils/program.py:count_launch).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..solvers import pose_opt as plain
from ..utils import nvcc
from ..utils.program import count_launch
from ..utils.tracing import get_tracer

LAUNCHES = 0

MAX_PROBLEMS = 16  # rows of the problem table passed by value (csrc/pose_lm.cu)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "pose_lm.cu"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int


class _Problem(ctypes.Structure):  # PoseLmProblem in csrc/pose_lm.cu
    _fields_ = [("R0", _ptr), ("t0", _ptr), ("xw", _ptr), ("uv", _ptr), ("w", _ptr),
                ("valid", _ptr), ("K4", _ptr), ("n", _i32), ("R", _ptr), ("t", _ptr),
                ("inliers", _ptr), ("n_inliers", _ptr), ("chi2", _ptr)]


class _Batch(ctypes.Structure):  # PoseLmBatch in csrc/pose_lm.cu
    _fields_ = [("p", _Problem * MAX_PROBLEMS), ("count", _i32), ("n_rounds", _i32),
                ("huber_rounds", _i32)]


_lock = threading.Lock()
_lib = None
_tracer = get_tracer()
# what nvcc printed for the last build of this process (ptxas registers,
# shared memory, spills); empty when the library was already built
build_log = ""


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, "libpose_lm")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        build_log = nvcc.compile_library(SOURCE, NVCC_FLAGS, so)
        lib = ctypes.CDLL(str(so))
        lib.pose_lm_launch.argtypes = [ctypes.POINTER(_Batch), _i32, _ptr]
        lib.pose_lm_launch.restype = _i32
        lib.pose_lm_max_problems.restype = _i32
        if lib.pose_lm_max_problems() != MAX_PROBLEMS:
            raise RuntimeError("csrc/pose_lm.cu and pose_lm_cuda.py disagree on the table's size")
        lib.pose_lm_error_string.argtypes = [_i32]
        lib.pose_lm_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _count(n: int):
    global LAUNCHES
    LAUNCHES += n
    _tracer.count("pose_lm_launches", n)


def _check(args: dict, use_huber_rounds: int, n_rounds: int):
    """Raise on what the kernel does not take (on either device, so that a
    CPU run refuses what a card would)."""
    if not 0 <= n_rounds <= len(plain._ROUND_ITERS):
        raise ValueError(f"optimize_pose runs 0 to {len(plain._ROUND_ITERS)} rounds, "
                         f"got {n_rounds}")
    if use_huber_rounds < 0:
        raise ValueError(f"use_huber_rounds must not be negative, got {use_huber_rounds}")
    n = args["xw"].shape[0] if args["xw"].dim() == 2 else -1
    shapes = {"R0": (3, 3), "t0": (3,), "xw": (n, 3), "uv": (n, 2), "inv_sigma2": (n,),
              "valid": (n,), "K4": (4,)}
    devices = {x.device for x in args.values()}
    if len(devices) != 1:
        raise ValueError(f"optimize_pose: the inputs lie on several devices {devices}")
    cuda = next(iter(devices)).type == "cuda"
    for name, x in args.items():
        dtype = torch.bool if name == "valid" else torch.float32
        if tuple(x.shape) != shapes[name] or x.dtype != dtype:
            raise ValueError(f"optimize_pose: {name} must be {dtype} of shape {shapes[name]} "
                             f"(N = xw's rows), got {x.dtype} {tuple(x.shape)}")
        if cuda and not x.is_contiguous():
            raise ValueError(f"optimize_pose: {name} must be contiguous on the card")
    return cuda


def optimize_pose(R0, t0, xw, uv, inv_sigma2, valid, K4, use_huber_rounds: int = 2,
                  n_rounds: int = 4) -> plain.PoseOptResult:
    """`pose_opt.optimize_pose`: one launch of the kernel on CUDA tensors,
    the plain version on CPU tensors. Shapes: R0 (3, 3), t0 (3,), xw (N, 3),
    uv (N, 2), inv_sigma2 (N,) float32, valid (N,) bool, K4 (4,) float32;
    on the card contiguous, on one device. Launches on the current stream."""
    args = {"R0": R0, "t0": t0, "xw": xw, "uv": uv, "inv_sigma2": inv_sigma2,
            "valid": valid, "K4": K4}
    if not _check(args, use_huber_rounds, n_rounds):
        if R0.device.type != "cpu":
            raise ValueError(f"optimize_pose runs on CUDA or the CPU, got {R0.device}")
        return plain.optimize_pose_plain(R0, t0, xw, uv, inv_sigma2, valid, K4,
                                         use_huber_rounds=use_huber_rounds, n_rounds=n_rounds)
    dev = R0.device
    n = xw.shape[0]
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(3, dtype=torch.float32, device=dev)
    inliers = torch.empty(n, dtype=torch.bool, device=dev)
    n_inliers = torch.empty((), dtype=torch.int64, device=dev)
    chi2 = torch.empty((), dtype=torch.float32, device=dev)
    batch = _Batch()
    p = batch.p[0]
    p.R0, p.t0, p.xw, p.uv = R0.data_ptr(), t0.data_ptr(), xw.data_ptr(), uv.data_ptr()
    p.w, p.valid, p.K4, p.n = inv_sigma2.data_ptr(), valid.data_ptr(), K4.data_ptr(), n
    p.R, p.t, p.inliers = R.data_ptr(), t.data_ptr(), inliers.data_ptr()
    p.n_inliers, p.chi2 = n_inliers.data_ptr(), chi2.data_ptr()
    batch.count, batch.n_rounds, batch.huber_rounds = 1, n_rounds, use_huber_rounds
    lib = build()
    err = lib.pose_lm_launch(ctypes.byref(batch), dev.index,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_lm_launch failed: {lib.pose_lm_error_string(err).decode()}")
    count_launch(_count)
    return plain.PoseOptResult(R=R, t=t, inliers=inliers, n_inliers=n_inliers, chi2=chi2)
