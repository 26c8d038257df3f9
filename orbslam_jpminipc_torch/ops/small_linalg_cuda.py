"""Build, bind and launch the batched small-matrix Jacobi kernel
(csrc/small_linalg.cu): `eigh_small` and `svd_small`, the
eigendecompositions and SVDs of the port's solvers (EPnP, whose
pseudo-inverse is `solvers/small_linalg.py:pinv_from_svd` of one, the Sim3
RANSAC, the H/F initializer).

They replace the reference's `jnp.linalg.eigh`, `svd` and `pinv` inside its
jitted solvers; torch.linalg's forms check their result on the host, so a
program holding them could neither run without a wait nor be captured. On
a CUDA tensor each function launches the kernel (raising on what it does
not take); on a CPU tensor it runs the plain version,
solvers/small_linalg.py, the same algorithm in torch operations. Nothing
falls back to torch.linalg.

The source is compiled at first use with nvcc into a shared library with a
plain C interface (for sm_90a, into build/torch_kernels/ under the
checkout) and loaded with ctypes; nothing is built when this module is
imported. `LAUNCHES` counts the kernel's launches (a launch captured into a
program counts at each replay of it, utils/program.py:count_launch).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from ..solvers import small_linalg as plain
from ..utils import nvcc
from ..utils.program import count_launch

LAUNCHES = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "small_linalg.cu"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# what nvcc printed for the last build of this process (ptxas registers,
# shared memory, spills); empty when the library was already built
build_log = ""


def library_path() -> Path:
    return nvcc.library_path(SOURCE, NVCC_FLAGS, "libsmall_linalg")


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; idempotent."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        build_log = nvcc.compile_library(SOURCE, NVCC_FLAGS, so)
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sl_eigh_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.sl_eigh_launch.restype = i32
        lib.sl_svd_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.sl_svd_launch.restype = i32
        lib.sl_max_n.restype = i32
        lib.sl_max_svd_n.restype = i32
        if (lib.sl_max_n(), lib.sl_max_svd_n()) != (plain.MAX_N, plain.MAX_SVD_N):
            raise RuntimeError("csrc/small_linalg.cu and solvers/small_linalg.py disagree "
                               "on the largest sizes")
        lib.sl_error_string.argtypes = [i32]
        lib.sl_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _count(n: int):
    global LAUNCHES
    LAUNCHES += n


def _matrices(A: torch.Tensor, name: str, max_n: int) -> torch.Tensor:
    """A as a contiguous (batch, n, n) float32 CUDA tensor; raises on what
    the kernel does not take."""
    n = A.shape[-1] if A.dim() >= 2 else 0
    if A.dim() < 2 or A.shape[-2] != n or not 1 <= n <= max_n:
        raise ValueError(f"{name} takes (..., n, n) with 1 <= n <= {max_n}, got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError(f"{name} takes float32, got {A.dtype}")
    return A.reshape(-1, n, n).contiguous()


def _check(err: int):
    if err != 0:
        raise RuntimeError(f"small_linalg launch failed: {build().sl_error_string(err).decode()}")


def eigh_small(A: torch.Tensor, max_sweeps: int = plain.EIGH_SWEEPS,
               lapack_signs: bool = False):
    """(w, V) of symmetric (..., n, n) float32 A, n <= 12: eigenvalues
    ascending, eigenvectors as columns; `lapack_signs` (n = 3): LAPACK
    ssyev's eigenvector signs (solvers/small_linalg.py:eigh_small for the
    conventions)."""
    if not A.is_cuda:
        if A.device.type != "cpu":
            raise ValueError(f"eigh_small runs on CUDA or the CPU, got {A.device}")
        return plain.eigh_small(A, max_sweeps, lapack_signs)
    lead, n = A.shape[:-2], A.shape[-1]
    if lapack_signs and n != 3:
        raise ValueError(f"lapack_signs takes n = 3, got {n}")
    X = _matrices(A, "eigh_small", plain.MAX_N)
    batch = X.shape[0]
    w = torch.empty((batch, n), dtype=torch.float32, device=A.device)
    V = torch.empty((batch, n, n), dtype=torch.float32, device=A.device)
    if batch:
        lib = build()
        _check(lib.sl_eigh_launch(X.data_ptr(), w.data_ptr(), V.data_ptr(), batch, n,
                                  int(max_sweeps), int(lapack_signs), A.device.index,
                                  torch.cuda.current_stream(A.device).cuda_stream))
        count_launch(_count)
    return w.reshape(*lead, n), V.reshape(*lead, n, n)


def svd_small(A: torch.Tensor, max_sweeps: int = plain.SVD_SWEEPS):
    """(U, S, Vt) of square (..., n, n) float32 A, n <= 4: singular values
    descending (solvers/small_linalg.py:svd_small for the conventions)."""
    if not A.is_cuda:
        if A.device.type != "cpu":
            raise ValueError(f"svd_small runs on CUDA or the CPU, got {A.device}")
        return plain.svd_small(A, max_sweeps)
    lead, n = A.shape[:-2], A.shape[-1]
    X = _matrices(A, "svd_small", plain.MAX_SVD_N)
    batch = X.shape[0]
    U = torch.empty((batch, n, n), dtype=torch.float32, device=A.device)
    S = torch.empty((batch, n), dtype=torch.float32, device=A.device)
    Vt = torch.empty((batch, n, n), dtype=torch.float32, device=A.device)
    if batch:
        lib = build()
        _check(lib.sl_svd_launch(X.data_ptr(), U.data_ptr(), S.data_ptr(), Vt.data_ptr(),
                                 batch, n, int(max_sweeps), A.device.index,
                                 torch.cuda.current_stream(A.device).cuda_stream))
        count_launch(_count)
    return U.reshape(*lead, n, n), S.reshape(*lead, n), Vt.reshape(*lead, n, n)
