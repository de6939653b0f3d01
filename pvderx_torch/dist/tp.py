"""Optional tensor parallelism for the learner networks (off by default).

The port of `pvderx/dist/tp.py`: a 2-D ``("env", "model")`` mesh
(`make_mesh_2d`), Megatron partition rules for the nets' `Linear` stacks
(`param_partition_specs`), and runner placement that keeps the optimizer's
moments (`shard_runner_tp`).

The rule goes by the Flax layer index ``i``, the position of a `Linear` in
``net.layers()`` (the order `pvderx_torch.convert` maps ``Dense_i`` onto),
with ``n`` the model-axis size:

- even ``i`` with ``d_out % n == 0`` and ``d_out >= 8n``: column-parallel
  (this rank keeps ``d_out / n`` rows of the ``[out, in]`` weight and of
  the bias);
- odd ``i`` with ``d_in % n == 0`` and ``d_in >= 8n``: row-parallel (this
  rank keeps ``d_in / n`` columns of the weight; the bias stays whole);
- everything else is replicated.

Where GSPMD inserted the collectives, the sharded layers here run Megatron's
two operators, written as autograd functions: *f* (identity forward,
all-reduce of the gradient over the model axis) before a column layer, and
*g* (all-reduce forward, identity backward) after a row layer, the row
layer's bias added once after the reduce. A row layer fed a replicated
activation (``ActorCritic``'s value head) takes *f* and then its own slice
of that input; a layer that needs the whole of a column layer's output
gathers it (all-gather forward, the local slice of the gradient backward).
`torch.distributed.nn.functional.all_reduce` is not *g*: it all-reduces in
backward as well, which multiplies the gradient by the model-axis size.

The gradient of a sharded parameter is its shard's; of a replicated one,
the same whole gradient on every model rank. So the learner's global norm
sums the squares of the sharded parameters over the model axis and counts
the replicated ones once (`global_norm_sq`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pvderx_torch.dist.mesh import ENV_AXIS, Mesh, mesh_device
from pvderx_torch.dist.sharding import ENV_FIELDS, replicate, shard_batch

MODEL_AXIS = "model"


def make_mesh_2d(n_env: int, n_model: int, device=None) -> Mesh:
    """2-D mesh: DP over environments x TP over learner-layer shards, the
    ranks laid out row-major (rank = env index · n_model + model index)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d needs a process group: call "
                           "pvderx_torch.dist.init_multihost() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    need = n_env * n_model
    if world != need:
        raise ValueError(f"need {need} ranks for a {n_env}x{n_model} mesh, "
                         f"have {world}")
    # every rank creates every group, in the same order
    env_groups = [dist.new_group([e * n_model + m for e in range(n_env)])
                  for m in range(n_model)]
    model_groups = [dist.new_group([e * n_model + m for m in range(n_model)])
                    for e in range(n_env)]
    e, m = divmod(rank, n_model)
    dev = mesh_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(axis_names=(ENV_AXIS, MODEL_AXIS), sizes=(n_env, n_model),
                coords=(e, m), groups=(env_groups[m], model_groups[e]),
                device=dev, backend=dist.get_backend())


def _role(i: int, d_out: int, d_in: int, n: int) -> str:
    if i % 2 == 0 and d_out % n == 0 and d_out >= 8 * n:
        return "col"
    if i % 2 == 1 and d_in % n == 0 and d_in >= 8 * n:
        return "row"
    return "rep"


def param_partition_specs(net, n_model: int) -> dict:
    """``{state_dict name: spec}`` for a net of `pvderx_torch.learn.nets`,
    each spec one entry per dimension of the torch tensor (``"model"`` on
    the sharded one, else None): a column-parallel weight
    ``("model", None)`` and bias ``("model",)``, a row-parallel weight
    ``(None, "model")``, and ``()`` for what is replicated (the rules of
    the module docstring)."""
    names = {id(m): n for n, m in net.named_modules()}
    specs = {}
    for i, lin in enumerate(net.layers()):
        d_out, d_in = lin.weight.shape if getattr(lin, "tp", None) is None \
            else lin.tp.full_shape
        role = _role(i, d_out, d_in, n_model)
        name = names[id(lin)]
        specs[f"{name}.weight"] = {"col": (MODEL_AXIS, None),
                                   "row": (None, MODEL_AXIS)}.get(role, ())
        specs[f"{name}.bias"] = (MODEL_AXIS,) if role == "col" else ()
    return specs


# ---------------------------------------------------------------------------
# Megatron's operators
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """f: identity forward, all-reduce of the gradient over the model axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """g: all-reduce forward over the model axis, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the last dimension forward, this rank's slice of the
    gradient backward (what follows is replicated, so every model rank
    holds the same whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return mesh.all_gather(x, MODEL_AXIS, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        k, w = ctx.mesh.coord(MODEL_AXIS), ctx.width
        return grad[..., k * w:(k + 1) * w], None


@dataclasses.dataclass(frozen=True, eq=False)
class TPPlan:
    """How one `Linear` runs on this rank: its role, whether its input
    arrives sharded, whether its output is gathered (a column-parallel
    head), and its unsharded ``[out, in]`` shape."""

    role: str
    in_sharded: bool
    gather_out: bool
    full_shape: tuple
    mesh: Mesh

    def __deepcopy__(self, memo):
        return self

    def linear(self, h, w, b):
        """The layer's forward on this rank's shard (``w``, ``b`` in the
        compute dtype)."""
        mesh = self.mesh
        if self.in_sharded and self.role != "row":
            h = _GatherFromModel.apply(h, mesh)
        if self.role == "col":
            out = F.linear(_CopyToModel.apply(h, mesh), w, b)
            return _GatherFromModel.apply(out, mesh) if self.gather_out \
                else out
        if self.role == "row":
            if not self.in_sharded:
                k, width = mesh.coord(MODEL_AXIS), w.shape[1]
                h = _CopyToModel.apply(h, mesh)[..., k * width:
                                                (k + 1) * width]
            return _ReduceFromModel.apply(F.linear(h, w), mesh) + b
        return F.linear(h, w, b)


def _shard_dims(role: str) -> dict:
    """The sharded dimension of a layer's weight and bias (absent: whole)."""
    return {"col": {"weight": 0, "bias": 0}, "row": {"weight": 1}}.get(role,
                                                                      {})


def shard_params_tp(net, mesh: Mesh) -> dict:
    """Shard ``net``'s layers over the model axis, in place (the parameters
    keep their identity, so an optimizer built on them keeps them), and
    attach each layer's `TPPlan`. Returns ``{parameter: (dim, start,
    length)}`` of the sharded parameters; a sharded parameter carries the
    same triple as ``tp_shard``."""
    n, k = mesh.size(MODEL_AXIS), mesh.coord(MODEL_AXIS)
    layers, inputs = net.layers(), net.layer_inputs()
    roles = [_role(i, *lin.weight.shape, n) for i, lin in enumerate(layers)]
    consumed = {p for p in inputs if p >= 0}
    out = {}
    for i, lin in enumerate(layers):
        p = inputs[i]
        lin.tp = TPPlan(role=roles[i],
                        in_sharded=p >= 0 and roles[p] == "col",
                        gather_out=roles[i] == "col" and i not in consumed,
                        full_shape=tuple(lin.weight.shape), mesh=mesh)
        for pname, dim in _shard_dims(roles[i]).items():
            param = getattr(lin, pname)
            size = param.shape[dim] // n
            param.data = param.data.narrow(dim, k * size, size).clone()
            param.tp_shard = (dim, k * size, size)
            out[param] = param.tp_shard
    return out


def shard_nets_tp(mesh: Mesh | None, *nets) -> None:
    """`shard_params_tp` of each net when ``mesh`` has a model axis (a
    learner's `init_runner` on a 2-D mesh); nothing otherwise."""
    if mesh is not None and MODEL_AXIS in mesh.axis_names:
        for net in nets:
            shard_params_tp(net, mesh)


def _shard_opt_state(opt: torch.optim.Optimizer, sharded: dict) -> None:
    """Slice an optimizer's per-parameter state (Adam's ``exp_avg`` and
    ``exp_avg_sq``) with its sharded parameters, keeping the values."""
    for param, st in opt.state.items():
        if param not in sharded:
            continue
        dim, start, size = sharded[param]
        for key, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim() == param.dim():
                st[key] = v.narrow(dim, start, size).clone()


def shard_runner_tp(runner, mesh: Mesh, env_fields=ENV_FIELDS):
    """A learner runner on a 2-D ``("env", "model")`` mesh: env fields
    sharded over the env axis (replicated over the model axis), every
    `nn.Module` broadcast from rank 0 and then TP-sharded in place,
    optimizer state broadcast and sliced with its parameters (values kept:
    a restored runner continues, it does not restart), everything else
    replicated."""
    vals = {f.name: getattr(runner, f.name) for f in dataclasses.fields(runner)}
    out, sharded = {}, {}
    for name, v in vals.items():
        if isinstance(v, torch.nn.Module) and name not in env_fields:
            out[name] = replicate(v, mesh)
            sharded.update(shard_params_tp(v, mesh))
    for name, v in vals.items():
        if name in out:
            continue
        if name in env_fields:
            out[name] = shard_batch(v, mesh, env_fields[name])
        else:
            out[name] = replicate(v, mesh)
            if isinstance(v, torch.optim.Optimizer):
                _shard_opt_state(v, sharded)
    return dataclasses.replace(runner, **out)


def global_norm_sq(grads, params, mesh: Mesh | None) -> torch.Tensor:
    """Σ g² over the whole (unsharded) parameter set: the squares of the
    sharded parameters' gradients summed over the model axis, the
    replicated ones counted once."""
    rep = [g for g, p in zip(grads, params) if not hasattr(p, "tp_shard")]
    shd = [g for g, p in zip(grads, params) if hasattr(p, "tp_shard")]
    sq = sum(torch.sum(g * g) for g in rep)
    if shd:
        sq = sq + mesh.all_reduce(sum(torch.sum(g * g) for g in shd),
                                  MODEL_AXIS)
    return sq


def gather_param(t: torch.Tensor, param, mesh: Mesh) -> torch.Tensor:
    """The whole of a sharded parameter (or of a state tensor shaped like
    it) from its model-axis shards; ``t`` itself when ``param`` is whole."""
    if not hasattr(param, "tp_shard") or t.dim() != param.dim():
        return t
    return mesh.all_gather(t, MODEL_AXIS, param.tp_shard[0])


def local_shard(t: torch.Tensor, param) -> torch.Tensor:
    """This rank's shard of a whole tensor shaped like ``param``'s unsharded
    self (``t`` itself when ``param`` is whole or ``t`` already fits)."""
    if (not hasattr(param, "tp_shard") or t.dim() != param.dim()
            or t.shape == param.shape):
        return t
    dim, start, size = param.tp_shard
    return t.narrow(dim, start, size).clone()


__all__ = ["MODEL_AXIS", "make_mesh_2d", "param_partition_specs",
           "shard_params_tp", "shard_runner_tp", "shard_nets_tp",
           "global_norm_sq",
           "gather_param", "local_shard", "TPPlan"]
