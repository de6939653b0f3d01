"""The process mesh: which rank holds which slice of the work.

The port of `pvderx/dist/mesh.py`. The reference puts every device of a
host under one JAX process and lets GSPMD insert the collectives; here one
process drives one rank (SPMD processes over `torch.distributed`), each
holding its own contiguous slice of the global env batch, and every
collective is written out.

`Mesh` is a thin frozen dataclass over process groups, not
`torch.distributed.device_mesh.DeviceMesh`: ranks that share one card
(several gloo ranks on one H100, the only multi-rank layout a one-card
machine has) all name ``cuda:0``, which DeviceMesh's one-device-per-rank
bookkeeping does not expect, and the learners need only the group of each
axis and this rank's coordinate on it. Its axes are ``("env",)`` or
``("env", "model")`` (`pvderx_torch.dist.tp.make_mesh_2d`), ranks laid out
row-major over them, as the reference reshapes its device list.

Collectives go through `Mesh.all_reduce`, `Mesh.all_gather` and
`Mesh.broadcast`, built on ``all_reduce`` and ``broadcast`` only: the gloo
backend supports no other collective on CUDA tensors, so an all-gather is
an all-reduce (SUM) of a zero-padded buffer (exact: every element sums one
value and zeros). A tensor on another device than the mesh's is staged
through the mesh's device (NCCL takes CUDA tensors only).

Random draws stay global: `draw_rows` draws the global ``[W·n, ...]`` shape
from the (replicated) generator and keeps this rank's rows, so every rank's
generator state stays that of a one-rank run and the draws do not depend on
the layout.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

ENV_AXIS = "env"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a process mesh (see the module docstring).

    ``groups[i]`` is the process group along axis ``axis_names[i]`` that
    holds this rank; ``coords[i]`` is this rank's index in it. ``device``
    is where this rank's tensors live."""

    axis_names: tuple
    sizes: tuple
    coords: tuple
    groups: tuple
    device: torch.device
    backend: str

    @property
    def shape(self) -> dict:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis: str = ENV_AXIS) -> int:
        return self.sizes[self.axis_names.index(axis)]

    def coord(self, axis: str = ENV_AXIS) -> int:
        return self.coords[self.axis_names.index(axis)]

    def group(self, axis: str = ENV_AXIS):
        return self.groups[self.axis_names.index(axis)]

    def __deepcopy__(self, memo):   # process groups are not copyable
        return self

    # -- the env axis -------------------------------------------------------
    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of an ``[n_global, ...]`` env batch;
        raises ``ValueError`` when the env axis does not divide it."""
        w = self.size(ENV_AXIS)
        if n_global % w:
            raise ValueError(
                f"the global env batch N={n_global} is not divisible by the "
                f"'env' axis size {w}: each rank steps N/{w} envs")
        per = n_global // w
        r = self.coord(ENV_AXIS)
        return slice(r * per, (r + 1) * per)

    # -- collectives ----------------------------------------------------------
    def _staged(self, t: torch.Tensor):
        return t if t.device == self.device else t.to(self.device)

    def all_reduce(self, t: torch.Tensor, axis: str = ENV_AXIS):
        """The SUM of ``t`` over ``axis``, as a new tensor on ``t``'s device
        (bit-identical on every rank of the group)."""
        x = self._staged(t).clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group(axis))
        return x.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str = ENV_AXIS,
                   dim: int = 0):
        """The tensors of ``axis``'s ranks concatenated along ``dim`` (every
        rank's ``t`` has the same shape), as an all-reduce of a zero-padded
        buffer."""
        n, k = self.size(axis), self.coord(axis)
        shape = list(t.shape)
        w = shape[dim]
        shape[dim] = n * w
        buf = torch.zeros(shape, dtype=t.dtype, device=self.device)
        buf.narrow(dim, k * w, w).copy_(t)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group(axis))
        return buf.to(t.device)

    def all_reduce_many(self, tensors, axis: str = ENV_AXIS) -> list:
        """`all_reduce` of several tensors, one collective per dtype (of
        their concatenation), split back into their shapes."""
        out = [None] * len(tensors)
        for dt in dict.fromkeys(t.dtype for t in tensors):
            idx = [k for k, t in enumerate(tensors) if t.dtype == dt]
            flat = self.all_reduce(torch.cat([tensors[k].reshape(-1)
                                              for k in idx]), axis)
            i = 0
            for k in idx:
                n = tensors[k].numel()
                out[k] = flat[i:i + n].reshape(tensors[k].shape)
                i += n
        return out

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Global rank 0's ``t`` (over every rank of the mesh), as a new
        tensor on ``t``'s device."""
        x = self._staged(t).clone()
        dist.broadcast(x, src=0)
        return x.to(t.device)


def draw_rows(mesh: Mesh | None, draw, shape):
    """``draw(shape)`` with the env axis leading: under a mesh, the global
    ``[W·n, ...]`` draw, of which this rank keeps its ``n`` rows (every rank
    makes the same draw, so generators stay in step)."""
    shape = tuple(shape)
    if mesh is None:
        return draw(shape)
    w, r, n = mesh.size(ENV_AXIS), mesh.coord(ENV_AXIS), shape[0]
    return draw((n * w,) + shape[1:])[r * n:(r + 1) * n]


def owned_rows(ids: torch.Tensor, n_global: int, mesh: Mesh):
    """Of global row ids ``t·N + i`` of a t-major ``[T, N]`` layout (a
    rollout, a replay buffer), the ones whose env ``i`` this rank holds (a
    mask over ``ids``), and their rows ``t·n + (i - start)`` in its own
    t-major ``[T, n]`` layout."""
    sl = mesh.rows(n_global)
    t, i = ids // n_global, ids % n_global
    mask = (i >= sl.start) & (i < sl.stop)
    return mask, t[mask] * (sl.stop - sl.start) + (i[mask] - sl.start)


def local_count(mesh: Mesh | None, n_global: int) -> int:
    """The env count this rank holds of a global batch of ``n_global``
    (raises on a non-divisible batch)."""
    if mesh is None:
        return n_global
    sl = mesh.rows(n_global)
    return sl.stop - sl.start


def mesh_device(device=None) -> torch.device:
    """The device of this rank: ``"cuda"`` (the card of this rank's local
    index, several ranks sharing a card when there are fewer cards than
    ranks) unless the caller asks for ``"cpu"``."""
    import os

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """1-D mesh over the env axis (data parallelism over environments),
    spanning every rank of the initialized process group. ``n``, when
    given, must be the world size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "pvderx_torch.dist.init_multihost() first (or start the ranks "
            "with `python -m pvderx_torch.dist.launch` or torchrun)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"make_mesh({n}) on a world of {world} ranks: the "
                         "mesh spans every rank")
    dev = mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(axis_names=(ENV_AXIS,), sizes=(world,),
                coords=(dist.get_rank(),), groups=(dist.group.WORLD,),
                device=dev, backend=dist.get_backend())


__all__ = ["ENV_AXIS", "Mesh", "make_mesh", "draw_rows", "owned_rows",
           "local_count", "mesh_device"]
