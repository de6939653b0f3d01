"""Build and load the CUDA kernels of `pvderx_torch.ops` (csrc/*.cu).

Every ``csrc/*.cu`` is compiled with nvcc at first use, one nvcc process per
source, all started together, and the objects are linked into one shared
library in ``ops/_build/`` (listed in .gitignore). The library is named by a
hash of every ``*.cu`` and ``*.cuh`` under ``csrc/`` and of the flags (a
source's own flags, `SOURCE_FLAGS`, included), so an edit to a shared header
builds a new library. It is loaded with ``ctypes``: the sources have a plain
C interface and include no PyTorch header, so a build takes seconds. Nothing
here runs at import time.

`launch` is the one path from a kernel's wrapper to the library: it checks
the tensors it hands over, passes each argument as its C type, and turns a
failed launch into an exception.
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

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source beside NVCC_FLAGS: the glue kernels round every
# + - * once, as torch's one-operation kernels do (no FMA contraction)
SOURCE_FLAGS = {"post_window.cu": ["-fmad=false"],
                "pre_window.cu": ["-fmad=false"]}

_PTR, _INT, _F32, _F64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_double)
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
    # the float64 engine (native.cu):
    # (y, t, p, u, dy, n, n_ph, stream)
    "pvderx_native_rhs": ([_PTR] * 5 + [_INT] * 2 + [_PTR], _INT),
    # (y, t0, p, u, out, n, n_ph, n_sub, h, h/2, h/6, stream)
    "pvderx_native_rk4_window": (
        [_PTR] * 5 + [_INT] * 3 + [_F64] * 3 + [_PTR], _INT),
    # (y, t0, p, u, out, steps, tries, n, n_ph, dt, rtol, atol, stream)
    "pvderx_native_dp54_window": (
        [_PTR] * 7 + [_INT] * 2 + [_F64] * 3 + [_PTR], _INT),
    # (y, p, u, out, iters, n, n_ph, max_iters, tol, stream)
    "pvderx_native_newton_steady": (
        [_PTR] * 5 + [_INT] * 3 + [_F64, _PTR], _INT),
    # the env step's autoreset (autoreset.cu):
    # (in pointers, out pointers, constants, restarts, n, n_ph, dtype, stream)
    "pvderx_autoreset": ([_PTR] * 4 + [_INT] * 3 + [_PTR], _INT),
    # the env step's post-window glue (post_window.cu):
    # (in pointers, out pointers, constants, n, n_ph, horizon, dtype, stream)
    "pvderx_post_window": ([_PTR] * 3 + [_INT] * 4 + [_PTR], _INT),
    # the env step's pre-window glue (pre_window.cu): (in pointers, out
    # pointers, constants, Volt-VAR's count, n, n_ph, the three tables'
    # rows, n_mppt, modes, dtype, stream)
    "pvderx_pre_window": ([_PTR] * 4 + [_INT] * 8 + [_PTR], _INT),
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
    for name, flags in sorted(SOURCE_FLAGS.items()):
        tag.update(f"\0{name} {' '.join(flags)}".encode())
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
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS,
                               *SOURCE_FLAGS.get(src.name, ()), "-c", "-o",
                               str(obj), str(src)], stdout=subprocess.PIPE,
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


def guard_launch(what: str, *inputs) -> None:
    """Raise before a kernel launch whose output would drop autograd: grad is
    enabled and an input requires grad."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in inputs):
        raise RuntimeError(
            f"the CUDA {what} kernel has no backward, and an input requires "
            f"grad: differentiate through pvderx_torch.ode.rk4_window (the "
            f"eager window), or launch under torch.no_grad()")


def check_outputs(what: str, *outs) -> None:
    """Under a dispatch mode that traps NaNs (``traps_nans``, as
    `diag.debug.debug_mode`'s does), which cannot see inside a kernel:
    raise if a kernel's output holds a NaN."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    if (any(getattr(m, "traps_nans", False)
            for m in _get_current_dispatch_mode_stack())
            and any(bool(torch.isnan(o).any()) for o in outs)):
        raise FloatingPointError(f"NaN in the output of the CUDA {what} kernel")


def check_leaves(dev, leaves: dict) -> dict:
    """{name: (tensor, dtype, shape)} -> {name: the tensor, contiguous}:
    raise ValueError unless each tensor has its dtype and shape and lives
    on ``dev``."""
    out = {}
    for name, (a, want, shape) in leaves.items():
        if a.device != dev or a.dtype != want or tuple(a.shape) != shape:
            raise ValueError(
                f"{name} must be {want} {shape} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
        out[name] = a.contiguous()
    return out


def _c_arg(a):
    """One argument as its C type (`launch`)."""
    if isinstance(a, torch.Tensor):
        return a.data_ptr()
    if isinstance(a, tuple):
        return (ctypes.c_void_p * len(a))(
            *(None if t is None else t.data_ptr() for t in a))
    if isinstance(a, list):
        return (ctypes.c_double * len(a))(*a)
    return a


def launch(entry: str, what: str, *args, check=()) -> None:
    """Launch the C entry ``entry`` (`ENTRIES`) on the current stream.

    Each argument passes as its C type: a tensor as its data pointer; a
    tuple of tensors and None as a C array of those pointers, None null; a
    list of numbers as a C array of doubles; None as null; a number as it
    is. The stream's handle goes last. Every tensor must be contiguous and
    all on one CUDA device, and none may require grad while grad is enabled
    (`guard_launch`). A nonzero code raises RuntimeError; then the float
    outputs in ``check`` are held to `check_outputs`. ``what`` names the
    kernel in the messages."""
    tensors = [t for a in args for t in (a if isinstance(a, tuple) else (a,))
               if isinstance(t, torch.Tensor)]
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"the {what} kernel takes tensors on one device, "
                             f"got {t.device} beside {dev}")
        if not t.is_contiguous():
            raise ValueError(f"the {what} kernel takes contiguous tensors")
    guard_launch(what, *tensors)
    c_args = [_c_arg(a) for a in args]   # held until the call returns
    with torch.cuda.device(dev):
        err = getattr(load(), entry)(*c_args,
                                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {error_string(err)}")
    check_outputs(what, *check)
