"""What the three training examples share: joining the ranks, the training
loop, the metrics file and the checkpoint.

Run as one process, an example trains on one card (or the CPU). Started as
ranks (``python -m pvderx_torch.dist.launch --nproc W -m ...``, or
`torchrun`), it joins the process group and trains over a 1-D env mesh, or
over a 2-D ``("env", "model")`` mesh with ``--tp``; ``--n-envs`` is then
the global count. Rank 0 alone logs and writes the metrics file.
"""
from __future__ import annotations

import os
import time


def add_common_flags(ap, metrics_default: str = "") -> None:
    ap.add_argument("--preset", default="10")
    ap.add_argument("--updates", type=int, default=50)
    ap.add_argument("--n-sub", type=int, default=None,
                    help="RK4 substeps/window; default = the per-preset 1e-6 "
                         "knee (72 single-phase, 88 three-phase; SPEC §6)")
    ap.add_argument("--metrics", default=metrics_default,
                    help="JSONL metrics file (rank 0 writes it; none if "
                         "empty)")
    ap.add_argument("--cpu", action="store_true")


def start(cpu: bool, tp: int = 1):
    """(device, mesh, is_rank0): the mesh is None for a single process,
    else the env mesh over every rank (``tp`` > 1: the 2-D TP mesh)."""
    device = "cpu" if cpu else "cuda"
    if "WORLD_SIZE" not in os.environ:
        if tp > 1:
            raise SystemExit(f"--tp {tp} needs {tp}·k ranks: start them with "
                             "python -m pvderx_torch.dist.launch --nproc ...")
        return device, None, True
    from pvderx_torch import dist

    dist.init_multihost()
    world = int(os.environ["WORLD_SIZE"])
    if world % tp:
        raise SystemExit(f"--tp {tp} does not divide the {world} ranks")
    mesh = (dist.make_mesh_2d(world // tp, tp, device) if tp > 1
            else dist.make_mesh(device=device))
    return device, mesh, int(os.environ.get("RANK", 0)) == 0


def train(name, runner, train_step, args, rows_per_step, show, mesh,
          is_rank0, ckpt: str = ""):
    """``args.updates`` train steps, logging every 10th on rank 0 with the
    env-steps/s over all ranks; then the checkpoint (every rank). Returns
    the runner and the last metrics."""
    from pvderx_torch.diag import MetricsLogger
    from pvderx_torch.diag.checkpoint import save
    from pvderx_torch.utils import get_logger

    log = get_logger(f"examples.{name}")
    if mesh is not None and is_rank0:
        log.info("%s over a %s mesh", name, mesh.shape)
    ml = MetricsLogger(args.metrics if is_rank0 else None)
    t0 = time.perf_counter()
    metrics = {}
    for i in range(args.updates):
        runner, metrics = train_step(runner)
        if is_rank0 and (i % 10 == 0 or i == args.updates - 1):
            rate = rows_per_step * (i + 1) / (time.perf_counter() - t0)
            log.info("update %d: %s (%.0f env-steps/s)", i,
                     " ".join(f"{k}={float(metrics[k]):.4g}" for k in show),
                     rate)
        ml.write(i, metrics)
    ml.close()
    if ckpt:
        path = save(ckpt, runner, mesh)
        if is_rank0:
            log.info("checkpoint -> %s", path)
    return runner, metrics


def finish(mesh) -> None:
    if mesh is not None:
        from pvderx_torch.dist import shutdown

        shutdown()
