"""Start W ranks of a module on this host.

    python -m pvderx_torch.dist.launch --nproc W [--backend gloo|nccl] \\
        [--cpu] [--timeout S] -m <module> [args...]

Each rank is ``python -m <module> args...`` with ``RANK``, ``LOCAL_RANK``
and ``WORLD_SIZE`` set, and a fresh rendezvous: a `FileStore` file in a new
temporary directory, handed over as ``PVDERX_TORCH_DIST_INIT`` (so no TCP
port is fixed, and several launches run side by side). The module joins
with `pvderx_torch.dist.init_multihost()`; `torchrun` works as well, its
variables read the same way. ``--backend`` defaults to gloo (the backend
for ranks that share one card, and the CPU's); ``--cpu`` hides the cards
from the ranks and gives each one intra-op thread. The ranks inherit this
process's standard output and error.

The launcher returns 0 when every rank does. When a rank fails, or the
``--timeout`` passes, it stops the others and returns the first non-zero
code (124 on a timeout).
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

from pvderx_torch.dist.multihost import BACKEND_ENV, INIT_ENV


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10.0
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(module: str, args=(), nproc: int = 2, backend: str = "gloo",
           cpu: bool = False, timeout: float | None = None,
           env: dict | None = None) -> int:
    """Run ``python -m module *args`` as ``nproc`` ranks; the launcher's
    return code (see the module docstring)."""
    store_dir = tempfile.mkdtemp(prefix="pvderx_torch_dist_")
    base = dict(os.environ if env is None else env)
    base.update({INIT_ENV: f"file://{os.path.join(store_dir, 'store')}",
                 BACKEND_ENV: backend, "WORLD_SIZE": str(nproc)})
    if cpu:
        base["CUDA_VISIBLE_DEVICES"] = ""
        base.setdefault("OMP_NUM_THREADS", "1")
    procs = []
    try:
        for r in range(nproc):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args],
                env=dict(base, RANK=str(r), LOCAL_RANK=str(r))))
        end = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                _stop(procs)
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            if end is not None and time.monotonic() > end:
                _stop(procs)
                print(f"launch: {module} passed its {timeout:g} s timeout",
                      file=sys.stderr)
                return 124
            time.sleep(0.05)
    finally:
        _stop(procs)
        shutil.rmtree(store_dir, ignore_errors=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        description="Start W ranks of a module (see the module docstring).",
        usage="%(prog)s --nproc W [--backend gloo|nccl] [--cpu] "
              "[--timeout S] -m MODULE [args...]")
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--timeout", type=float, default=None)
    if "-m" not in argv or argv.index("-m") + 1 >= len(argv):
        ap.error("-m MODULE is required")
    i = argv.index("-m")       # everything after the module is the module's
    a = ap.parse_args(argv[:i])
    return launch(argv[i + 1], argv[i + 2:], a.nproc, a.backend, a.cpu,
                  a.timeout)


if __name__ == "__main__":
    sys.exit(main())
