"""The yardstick of the kernels' roofline shares, frozen in the benchmark.

- `OpCounter`: a `TorchDispatchMode` that counts the aten operations run
  under it, by class (alu, div, transcendental; views, copies and
  reductions free). Copied unchanged, with its aten-name tables, from
  `pvderx_torch/diag/roofline.py` when the benchmark was introduced.
- `substep_ops`: the operations of ONE RK4 substep of the frozen
  reference's window (`portbench.reference.env`) per env, counted by
  `OpCounter` at one env's shapes in float32 (4 RHS evaluations with the
  window invariants hoisted, two grid rotations, the Kahan update; the
  invariants and the first rotation counted once per window and left out).
- `window_bound`: the least time one window launch over a cell's envs can
  take on one H100: operations over the FP32 peak, bytes over the HBM
  peak, the larger. Bytes: each input read once (the window time per env;
  the state, the 29 parameters and the 15 held inputs per DER) and the
  output state written once, all float32.

Peaks: NVIDIA H100 SXM5 data sheet, dense, without sparsity: 67 TFLOP/s
FP32 outside the tensor cores (an FMA counted as two operations), 3.35 TB/s
HBM3, at the full 700 W power limit.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

H100_FP32_OPS_PER_S = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# aten op names (the overload packet's) by class
_ALU = {"add", "sub", "rsub", "mul", "neg", "maximum", "minimum", "clamp",
        "clamp_min", "clamp_max", "where", "abs", "sign", "floor", "round",
        "lt", "le", "gt", "ge", "eq", "ne", "logical_and", "logical_or",
        "logical_not", "square", "_to_copy", "lerp"}
_DIV = {"div", "reciprocal", "sqrt", "rsqrt", "remainder", "fmod", "mean"}
_TRANS = {"exp", "exp2", "sin", "cos", "log", "log2", "tanh", "sigmoid",
          "pow", "expm1", "log1p", "atan2", "erf"}
# reductions: free in the roofline count (the reference's reduce_sum and
# reduce_max), their input less output elements in compile_report's flops
_REDUCE = {"sum", "amax", "amin", "max", "min", "prod"}
_FREE = {"select", "slice", "cat", "stack", "view", "_unsafe_view", "reshape",
         "expand", "unsqueeze", "squeeze", "t", "transpose", "permute",
         "movedim", "clone", "detach", "alias", "lift_fresh", "zeros",
         "zeros_like", "ones", "ones_like", "full", "full_like", "empty",
         "empty_like", "empty_strided", "scalar_tensor", "index_select",
         "gather", "index", "split", "split_with_sizes", "unbind", "copy_",
         "fill_", "_local_scalar_dense", "arange", "as_strided",
         "contiguous", "lift_fresh_copy", "new_empty", "new_zeros"}
# the reference's primitive name of an aten op, where the two differ
_REF_NAME = {"rsub": "sub", "maximum": "max", "minimum": "min",
             "clamp_min": "max", "clamp_max": "min", "reciprocal": "div",
             "mean": "div", "where": "select_n",
             "_to_copy": "convert_element_type"}
_CLASS_OF = {**{n: "alu" for n in _ALU}, **{n: "div" for n in _DIV},
             **{n: "transcendental" for n in _TRANS},
             **{n: "free" for n in _FREE | _REDUCE}}
CLASSES = ("alu", "div", "transcendental", "other")


def _is_int(x) -> bool:
    return (isinstance(x, int) and not isinstance(x, bool)) or (
        isinstance(x, float) and x.is_integer())


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (see the module docstring).

    ``by_op``: output elements per op under the reference's primitive name,
    free ops left out; ``unclassified``: the same for ops outside the table.
    ``flops``, ``transcendentals`` and ``bytes`` follow XLA's cost analysis
    (bytes: every tensor an op that is not a view reads and writes).
    ``typed``: the tensors that do not derive from constants alone, when
    weak-type converts are counted (`substep_op_count`); None otherwise."""

    def __init__(self, typed=None):
        super().__init__()
        self.by_op, self.by_class, self.unclassified = (Counter(), Counter(),
                                                        Counter())
        self.flops = self.transcendentals = self.bytes = 0
        self._recip = WeakIdKeyDictionary()
        self.typed = None
        if typed is not None:
            self.typed = WeakIdKeyDictionary()
            for t in typed:
                self.typed[t] = True

    def _classify(self, name, args, kwargs):
        """(reference name, class) of one call; several (clamp to both)."""
        if name == "mul" and not all(isinstance(a, torch.Tensor) for a in args) \
                and any(isinstance(a, torch.Tensor) and a in self._recip
                        for a in args):
            return []                     # the mul of torch's ``1.0 / x``
        if name == "pow":
            exp = args[1] if len(args) > 1 else kwargs.get("exponent")
            return [("integer_pow", "alu") if _is_int(exp)
                    else ("pow", "transcendental")]
        if name == "clamp":
            lo = args[1] if len(args) > 1 else kwargs.get("min")
            hi = args[2] if len(args) > 2 else kwargs.get("max")
            return ([("max", "alu")] * (lo is not None)
                    + [("min", "alu")] * (hi is not None))
        cls = _CLASS_OF.get(name)
        if cls is None:
            return [(name, "unclassified")]
        return [] if cls == "free" else [(_REF_NAME.get(name, name), cls)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        n_out = max((o.numel() for o in outs), default=0)
        for ref, cls in self._classify(name, args, kwargs):
            (self.unclassified if cls == "unclassified" else
             self.by_op)[ref] += n_out
            self.by_class[cls] += n_out
            if cls == "transcendental":
                self.transcendentals += n_out
            elif name == "mean":
                self.flops += max(o.numel() for o in ins)
            else:
                self.flops += n_out
        if name in _REDUCE:
            self.flops += sum(a.numel() for a in ins) - n_out
        if not func.is_view:
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if name == "reciprocal":
            for o in outs:
                self._recip[o] = True
        if self.typed is not None:
            self._follow_types(ins, outs)
        return out

    def _follow_types(self, ins, outs):
        """JAX's weak types: a floating operand derived from constants alone
        is converted where it meets a typed one; an op with a typed operand
        gives typed outputs."""
        fl = [a for a in ins if a.is_floating_point()]
        typed = [a for a in fl if a in self.typed]
        if not typed:
            return
        for a in fl:
            if a not in self.typed:
                self.by_op["convert_element_type"] += a.numel()
                self.by_class["alu"] += a.numel()
                self.flops += a.numel()
        for o in outs:
            self.typed[o] = True

    def classes(self) -> dict:
        """{alu, div, transcendental, other, total, by_op[, unclassified]},
        the reference's `_classify` layout ("other": the unclassified)."""
        out = {c: self.by_class[c] for c in CLASSES[:-1]}
        out["other"] = self.by_class["unclassified"]
        out["total"] = sum(out[c] for c in CLASSES)
        out["by_op"] = dict(sorted(self.by_op.items()))
        if self.unclassified:
            out["unclassified"] = dict(self.unclassified)
        return out

    def __sub__(self, other: "OpCounter") -> "OpCounter":
        diff = OpCounter()
        for k in ("by_op", "by_class", "unclassified"):
            setattr(diff, k, getattr(self, k) - getattr(other, k))
        return diff



def _count(fn, typed) -> dict:
    with OpCounter(typed) as c:
        fn()
    return c


@functools.cache
def substep_ops(config_json: str) -> int:
    """Operations per env of one RK4 substep of the frozen reference's
    window, for the configuration (its JSON text, so the count is cached
    per configuration)."""
    import json

    from portbench.reference import env, rhs_core
    from portbench.reference.params import Exog
    from portbench.reference.xp import TorchXP

    spec = env.make_spec(json.loads(config_json))
    f32 = torch.float32
    xp = TorchXP(f32, "cpu")
    p = dataclasses.replace(spec.der, **{
        f.name: torch.tensor(getattr(spec.der, f.name), dtype=f32)
        for f in dataclasses.fields(spec.der) if f.name != "n_ph"})
    shape = ()
    nominal = dict(s_irr=1000.0, t_cell=298.15, v_g=1.0, phi_g=0.0,
                   dw_g=0.0, t_g=0.0, v_g2=0.0, phi_g2=0.0, g_load=0.0,
                   b_load=0.0, vdc_ref=1.0, q_ref=0.0, conn=1.0, ces=0.0,
                   p_ref=0.0)
    u = Exog(**{k: torch.full(shape, v, dtype=f32)
                for k, v in nominal.items()})
    n_s = spec.der.n_states
    y = torch.zeros((n_s,) + shape)
    c = torch.zeros((n_s,) + shape)
    t = torch.zeros(())
    h = torch.tensor(spec.dt / spec.n_sub)
    leaves = [getattr(p, f.name) for f in dataclasses.fields(p)
              if f.name != "n_ph"] + [getattr(u, f.name)
                                      for f in dataclasses.fields(u)]
    typed = [t, h, y, c, *leaves]
    def hoisted():
        return (rhs_core.prep_invariants(p, u, xp),
                rhs_core.grid_rot(t, p, u, xp))

    def f(yy, tt, prep, rot):
        return rhs_core.rhs(yy, tt, p, u, xp, prep, rot)

    def rot(tt):
        return rhs_core.grid_rot(tt, p, u, xp)

    def substep():
        prep, r1 = hoisted()
        rh, r4 = rot(t + 0.5 * h), rot(t + h)
        k1 = f(y, t, prep, r1)
        k2 = f(y + (0.5 * h) * k1, t + 0.5 * h, prep, rh)
        k3 = f(y + (0.5 * h) * k2, t + 0.5 * h, prep, rh)
        k4 = f(y + h * k3, t + h, prep, r4)
        d = ((h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)) - c
        s = y + d
        return (s - y) - d

    counts = (_count(substep, typed) - _count(hoisted, typed)).classes()
    if counts.get("unclassified"):
        raise ValueError(f"unclassified operations: {counts['unclassified']}")
    return counts["total"]


def window_bytes(config: dict, n_envs: int) -> int:
    """Float32 bytes one window launch over ``n_envs`` envs must move."""
    from portbench.reference.params import N_EXOG, N_PARAMS

    n_s = 6 * int(config["der"]["n_ph"]) + 5
    return 4 * n_envs * (1 + 2 * n_s + N_PARAMS + N_EXOG)


def window_bound(config: dict, n_envs: int) -> dict:
    """The least time (ms) of one window launch over ``n_envs`` envs of the
    configuration, with its operations, bytes and what bounds it."""
    import json

    ops = substep_ops(json.dumps(config, sort_keys=True)) * int(
        config["n_sub"]) * n_envs
    n_bytes = window_bytes(config, n_envs)
    ops_ms = 1e3 * ops / H100_FP32_OPS_PER_S
    bytes_ms = 1e3 * n_bytes / H100_HBM_BYTES_PER_S
    return {"ops": ops, "bytes": n_bytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
