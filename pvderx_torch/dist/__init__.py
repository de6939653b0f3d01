"""Distributed training over `torch.distributed` (the port of `pvderx.dist`):
SPMD processes, one rank each, each holding its own contiguous slice of the
global env batch; the learner's collectives written out where GSPMD
inserted the reference's. Start several ranks with
``python -m pvderx_torch.dist.launch --nproc W -m <module> ...`` or
`torchrun`; each joins with `init_multihost()`."""
from pvderx_torch.dist.mesh import ENV_AXIS, Mesh, draw_rows, make_mesh
from pvderx_torch.dist.multihost import (
    global_mesh, init_multihost, make_global_array, process_allgather,
    process_env_slice, shutdown, sync_hosts,
)
from pvderx_torch.dist.sharding import (
    env_sharding, replicate, shard_batch, shard_runner,
)
from pvderx_torch.dist.tp import (
    MODEL_AXIS, make_mesh_2d, param_partition_specs, shard_params_tp,
    shard_runner_tp,
)

__all__ = [
    "ENV_AXIS", "make_mesh",
    "env_sharding", "replicate", "shard_batch", "shard_runner",
    "MODEL_AXIS", "make_mesh_2d", "param_partition_specs", "shard_params_tp",
    "shard_runner_tp",
    "global_mesh", "init_multihost", "make_global_array",
    "process_env_slice", "sync_hosts",
    "Mesh", "draw_rows", "process_allgather", "shutdown",
]
