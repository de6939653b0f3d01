"""Build and load the CUDA kernels of `pvderx_torch.ops` (csrc/*.cu).

Every ``csrc/*.cu`` is compiled with nvcc at first use, one nvcc process per
source, all started together, and the objects are linked into one shared
library in ``ops/_build/`` (listed in .gitignore). The library is named by a
hash of every ``*.cu`` and ``*.cuh`` under ``csrc/`` and of the flags, so an
edit to a shared header builds a new library. It is loaded with ``ctypes``:
the sources have a plain C interface and include no PyTorch header, so a
build takes seconds. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_PTR, _INT, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (argtypes, restype) of every extern "C" entry of csrc/*.cu
ENTRIES = {
    # (y, t0, p, u, out, n, n_ph, n_sub, h, h/2, h/6, stream)
    "pvderx_rk4_window": ([_PTR] * 5 + [_INT] * 3 + [_F32] * 3 + [_PTR], _INT),
    # (y, t0, p, u, out, n, m, n_ph, n_sub, h, h/2, h/6, stream)
    "pvderx_rk4_fleet_window": (
        [_PTR] * 5 + [_INT] * 4 + [_F32] * 3 + [_PTR], _INT),
    # (y_hi, y_lo, t0, p, u, out_hi, out_lo, n, n_ph, n_sub, h_hi, h_lo,
    #  stream)
    "pvderx_rk4_window_df": (
        [_PTR] * 7 + [_INT] * 3 + [_F32] * 2 + [_PTR], _INT),
    "pvderx_error_string": ([_INT], ctypes.c_char_p),
}

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


def library_path(src_dir: Path = CSRC) -> Path:
    """Where the library built from ``src_dir`` lives: named by a hash of the
    flags and of every source and header there (name and content)."""
    tag = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        tag.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"libpvderx_kernels_{tag.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless these sources and flags are already built.
    The compiler's register/spill report is kept beside it (`ptxas_report`)."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    stem = f"{so.stem}.{os.getpid()}"
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    outs = [p.communicate()[0] for p in procs]
    for src, p, out in zip(srcs, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} with code {p.returncode}:\n{out}")
    tmp = BUILD_DIR / f"{stem}.tmp"
    link = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed with code {link.returncode}:\n"
                           f"{link.stdout}{link.stderr}")
    for obj in objs:
        obj.unlink()
    so.with_suffix(".ptxas.txt").write_text("".join(outs))
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
            for name, (args, res) in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = args, res
            _lib.append(lib)
        return _lib[0]


def error_string(err: int) -> str:
    return load().pvderx_error_string(err).decode()
