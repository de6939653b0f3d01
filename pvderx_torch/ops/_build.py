"""Build and load the CUDA kernels of `pvderx_torch.ops` (csrc/*.cu).

The library is compiled with nvcc at first use into ``ops/_build/`` (listed
in .gitignore), named by a hash of its source and flags, and loaded with
``ctypes``: the sources have a plain C interface and include no PyTorch
header, so a build takes seconds. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).parent / "csrc" / "window.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: list[ctypes.CDLL] = []   # the library once loaded in this process


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpvderx_window_{tag.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source and flags are already built.
    The compiler's register/spill report is kept beside it (`ptxas_report`)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def ptxas_report() -> str:
    """What ptxas printed for the built library (registers, spills)."""
    return library_path().with_suffix(".ptxas.txt").read_text()


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entries.
    Later calls return the loaded library without touching the disk."""
    if _lib:
        return _lib[0]
    with _lock:
        if not _lib:
            lib = ctypes.CDLL(str(build()))
            fn = lib.pvderx_rk4_window
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.pvderx_error_string.argtypes = [ctypes.c_int]
            lib.pvderx_error_string.restype = ctypes.c_char_p
            _lib.append(lib)
        return _lib[0]


def error_string(err: int) -> str:
    return load().pvderx_error_string(err).decode()
