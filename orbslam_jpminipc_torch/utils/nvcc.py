"""Compile a CUDA source into a shared library with a plain C interface.

The port's hand-written CUDA sources (csrc/) are built at first use with
nvcc, for sm_90a, into build/torch_kernels/ under the checkout, named by a
hash of the source and the flags, and loaded with ctypes by their wrappers.
Nothing is built when a module is imported.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def nvcc() -> str:
    """The nvcc of the CUDA toolkit torch names, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def library_path(source: Path, flags, prefix: str) -> Path:
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{prefix}_{tag}.so"


def compile_library(source: Path, flags, so: Path) -> str:
    """Build `so` from `source` unless it exists; what nvcc printed ("" when
    the library was there already). Raises when nvcc fails."""
    if so.exists():
        return ""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *flags, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return proc.stdout + proc.stderr
