"""Process-group bring-up and host coordination.

The port of `pvderx/dist/multihost.py`: `torch.distributed` takes the part
of `jax.distributed`. Each rank is one process holding its own slice of the
global env batch (`process_env_slice`); `init_multihost` joins the group,
either from the environment that `torchrun` or `pvderx_torch.dist.launch`
sets, or from explicit arguments.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from pvderx_torch.dist.mesh import ENV_AXIS, Mesh, make_mesh

# a rank that dies mid-collective must not leave the others waiting for the
# default 30 minutes (the launcher also stops the remaining ranks)
TIMEOUT = datetime.timedelta(seconds=600)
INIT_ENV = "PVDERX_TORCH_DIST_INIT"        # set by pvderx_torch.dist.launch
BACKEND_ENV = "PVDERX_TORCH_DIST_BACKEND"


def _init_method(address: str | None) -> str:
    if address is None:
        return os.environ.get(INIT_ENV, "env://")
    if "://" in address:
        return address
    return f"tcp://{address}"


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> None:
    """Join the process group; call once per rank before any collective.

    With no arguments it reads the rendezvous that `torchrun` sets
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or the one
    `pvderx_torch.dist.launch` sets. ``coordinator_address`` is
    ``"host:port"`` or an init-method URL (``tcp://...``, ``file://...``).
    ``backend`` defaults to ``"nccl"`` when a card is present, else
    ``"gloo"``; pass ``"gloo"`` for ranks that share one card (NCCL refuses
    two ranks on one device)."""
    if backend is None:
        backend = os.environ.get(BACKEND_ENV) or (
            "nccl" if torch.cuda.is_available() else "gloo")
    kw = {}
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend,
                            init_method=_init_method(coordinator_address),
                            timeout=TIMEOUT, **kw)


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(device=None) -> Mesh:
    """A 1-D ``"env"`` mesh over every rank of every process."""
    return make_mesh(device=device)


def _process() -> tuple:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_env_slice(n_envs_global: int) -> slice:
    """This process's contiguous slice of the global env batch (the
    reference's formula over process index and count)."""
    pid, np_ = _process()
    if n_envs_global % np_:
        raise ValueError(f"n_envs={n_envs_global} not divisible by "
                         f"{np_} processes")
    per = n_envs_global // np_
    return slice(pid * per, (pid + 1) * per)


def make_global_array(local, mesh: Mesh, n_envs_global: int) -> torch.Tensor:
    """This rank's ``[n, ...]`` shard of a global ``[n_envs_global, ...]``
    batch, checked against the mesh and placed on the rank's device."""
    local = torch.as_tensor(local)
    sl = mesh.rows(n_envs_global)
    if local.shape[0] != sl.stop - sl.start:
        raise ValueError(
            f"rank shard has {local.shape[0]} rows; the '{ENV_AXIS}' axis "
            f"of size {mesh.size(ENV_AXIS)} gives each rank "
            f"{sl.stop - sl.start} of {n_envs_global}")
    return local.to(mesh.device)


def process_allgather(t: torch.Tensor, mesh: Mesh | None = None):
    """Every rank's ``t`` concatenated on axis 0, in rank order (the
    reference's ``multihost_utils.process_allgather(..., tiled=True)``):
    over the env axis of ``mesh``, or over every process without one."""
    if mesh is None:
        mesh = make_mesh(device=t.device if dist.get_backend() == "gloo"
                         else None)
    return mesh.all_gather(t, ENV_AXIS, 0)


def sync_hosts(name: str = "pvderx_torch") -> None:
    """Barrier across processes (``name`` labels it, as in the
    reference)."""
    if dist.is_initialized():
        dist.barrier()


__all__ = ["init_multihost", "shutdown", "global_mesh", "process_env_slice",
           "make_global_array", "process_allgather", "sync_hosts"]
