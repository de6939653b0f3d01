"""Speed-of-light (roofline) analysis of the window kernels on an H100.

The counterpart of `pvderx/diag/roofline.py`, with the H100's ceilings in
place of the TPU's. Three ingredients:

1. **Op count** (`substep_op_count`): one RK4 substep of the window program
   (4 RHS evaluations with hoisted `Prep`, 2 grid rotations, the Kahan
   combine) runs at one-env shapes under `OpCounter`, a `TorchDispatchMode`
   that counts every aten op's output elements; the hoisted
   `prep_invariants` and first `grid_rot` are counted apart and subtracted.
   An aten-name table classes each op as alu, div, transcendental or free;
   a name in none of them counts as "unclassified", never as free. Three
   mappings give the reference program's classes where torch writes one
   of its primitives another way:
   - torch's ``1.0 / x`` is ``reciprocal`` and then a ``mul`` by the Python
     scalar: one div, as the reference's ``div``;
   - ``mean`` is the reference's ``reduce_sum`` (free) and one ``div`` per
     output element;
   - the reference's angle table is a weak-typed JAX constant, and JAX
     converts it (``convert_element_type``, alu) wherever it meets a typed
     operand; `OpCounter` follows which tensors derive from constants alone
     and counts the same converts. ``pow`` by a Python integer is the
     reference's ``integer_pow`` (alu), by any other exponent its ``pow``.
2. **Ceilings** (`H100`): the H100 SXM's 132 SMs of 128 FP32 lanes at the
   max SM clock, its 67e12 FP32 operations/s (an FMA counted as two) and
   3.35e12 B/s of HBM3 (NVIDIA data sheet). A transcendental or divide goes
   through the SFU, 16 results per SM per clock: 8 lane-issues each in the
   weighted figure.
3. **Bounds** (`window_bound_ms`, `lane_utilization`): a window's least
   time, the larger of its bytes over the memory rate and its operations
   over the FP32 rate, beside its lane-issue floor (one operation per FP32
   lane per clock); and a measured env-steps/s as a share of those
   ceilings.

`compile_report` (`diag.profiler`) reads its flops and bytes from the same
`OpCounter`: an elementwise op counts its output elements, a reduction its
input elements less its outputs, as XLA's cost analysis counts them.
"""
from __future__ import annotations

import dataclasses
import functools
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

H100 = {
    "name": "NVIDIA H100 SXM",
    "sms": 132,
    "fp32_lanes_per_sm": 128,
    "sfu_results_per_sm_per_clock": 16,
    "max_sm_clock_hz": 1.98e9,   # nvidia-smi clocks.max.sm, H100 80GB HBM3
    "fp32_ops_per_s": 67e12,
    # FP64 outside the tensor cores, H100 SXM5 (NVIDIA H100 Tensor Core GPU
    # Architecture white paper, table 1: 33.5 TFLOPS; the data sheet rounds
    # it to 34): the float64 engine's ceiling (`native_bound_ms`)
    "fp64_ops_per_s": 33.5e12,
    "hbm_bytes_per_s": 3.35e12,
}


def at_clock(mhz: float, chip: dict = H100) -> dict:
    """``chip`` with its max SM clock read from the card (MHz)."""
    return dict(chip, max_sm_clock_hz=mhz * 1e6)


def lane_issue_per_s(chip: dict = H100) -> float:
    """FP32 lane-issues per second: one operation per lane per clock."""
    return chip["sms"] * chip["fp32_lanes_per_sm"] * chip["max_sm_clock_hz"]


def sfu_lane_issues(chip: dict = H100) -> float:
    """Lane-issues one SFU result (transcendental, divide) takes."""
    return chip["fp32_lanes_per_sm"] / chip["sfu_results_per_sm_per_clock"]


# aten op names (the overload packet's) by class, the counterpart of the
# reference's primitive table
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


@functools.cache
def substep_op_count(n_ph: int = 1) -> dict:
    """Per-env (per-DER for a fleet) op count of ONE RK4 substep of the
    window program: {"alu", "div", "transcendental", "other", "total",
    "by_op"[, "unclassified"]}.

    The substep is the reference kernel body's arithmetic
    (`pvderx/ops/window.py:_window_kernel`, as the reference's counter
    writes it: ``0.5 * h`` and ``h / 6.0`` on a traced ``h``), which
    `ops.window.rk4_window_batch_ref` and the CUDA kernels restate with
    h/2 and h/6 taken once per window; float32, preset "10" (1-φ) or "50"
    (3-φ), 0-d parameters, y [n_s]. The window-invariant `prep_invariants`
    and first `grid_rot` are subtracted."""
    from pvderx_torch.params import make_params, nominal_exog
    from pvderx_torch.physics import rhs_core
    from pvderx_torch.physics.xp import TorchXP

    p0 = make_params("10" if n_ph == 1 else "50")
    p = p0.to(torch.float32, "cpu")
    u = nominal_exog().to(torch.float32, "cpu")
    xp = TorchXP(torch.float32, "cpu")
    t = torch.tensor(0.0)
    h = torch.tensor(1.0 / 60.0 / 64)
    y = torch.zeros(p0.n_states)
    c = torch.zeros(p0.n_states)
    leaves = [getattr(p, f.name) for f in dataclasses.fields(p)
              if f.name != "n_ph"]
    leaves += [getattr(u, f.name) for f in dataclasses.fields(u)]
    typed = [t, h, y, c, *leaves]

    def hoisted():
        return (rhs_core.prep_invariants(p, u, xp),
                rhs_core.grid_rot(t, p, u, xp))

    with OpCounter(typed) as whole:
        prep, r1 = hoisted()
        rh = rhs_core.grid_rot(t + 0.5 * h, p, u, xp)
        r4 = rhs_core.grid_rot(t + h, p, u, xp)
        k1 = rhs_core.rhs(y, t, p, u, xp, prep, r1)
        k2 = rhs_core.rhs(y + (0.5 * h) * k1, t + 0.5 * h, p, u, xp, prep, rh)
        k3 = rhs_core.rhs(y + (0.5 * h) * k2, t + 0.5 * h, p, u, xp, prep, rh)
        k4 = rhs_core.rhs(y + h * k3, t + h, p, u, xp, prep, r4)
        d = ((h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)) - c
        s = y + d
        _ = (s - y) - d
    with OpCounter(typed) as once:
        hoisted()
    return (whole - once).classes()


def ops_per_substep(kernel: str, n_ph: int = 1) -> int:
    """Operations per env (per unit for the fleet) per substep of a window
    kernel: ``"window"`` (K1) and ``"fleet_window"`` (K2) from
    `substep_op_count` (M single-DER windows for the fleet, the reference's
    convention: ~1% high, the shared PCC voltage counted M times),
    ``"window_df"`` (K3) from `ops.dualfloat.OPS_PER_SUBSTEP_DF`."""
    if kernel == "window_df":
        from pvderx_torch.ops.dualfloat import OPS_PER_SUBSTEP_DF
        return OPS_PER_SUBSTEP_DF[n_ph]
    if kernel not in ("window", "fleet_window"):
        raise ValueError(f"unknown window kernel {kernel!r}")
    return substep_op_count(n_ph)["total"]


def window_hbm_bytes(n_ph: int = 1, m: int = 1, df: bool = False) -> int:
    """Device-memory bytes one env's window must move: one f32 read of t0
    and of (y, p_pack, u_pack) per unit, one f32 write of y1 (df32: y and
    y1 as (hi, lo) pairs)."""
    from pvderx_torch.ops.dualfloat import window_df_bytes
    from pvderx_torch.ops.window import fleet_window_bytes

    return window_df_bytes(1, n_ph) if df else fleet_window_bytes(1, m, n_ph)


def window_bound_ms(kernel: str, n: int, *, n_ph: int = 1, m: int = 1,
                    n_sub: int = 64, chip: dict = H100) -> dict:
    """The least time one launch of a window kernel (``"window"``,
    ``"fleet_window"``, ``"window_df"``) over ``n`` envs can take: bytes and
    operations, each over its ceiling, the larger as ``bound_ms`` with
    ``bound_by``, and ``issue_bound_ms``, the lane-issue floor."""
    ops = ops_per_substep(kernel, n_ph) * n_sub * m * n
    n_bytes = n * window_hbm_bytes(n_ph, m, df=kernel == "window_df")
    bytes_ms = 1e3 * n_bytes / chip["hbm_bytes_per_s"]
    ops_ms = 1e3 * ops / chip["fp32_ops_per_s"]
    return dict(bytes=n_bytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                issue_bound_ms=1e3 * ops / lane_issue_per_s(chip))


@functools.cache
def native_op_counts(n_ph: int = 1) -> dict:
    """Per-env operation counts of the float64 engine's pieces (its kernels
    N1-N4, `pvderx_torch.native.kernels`), by `OpCounter` on their plain
    versions' arithmetic at one env, float64, preset "10" (1-φ) or "50"
    (3-φ): ``prep`` the window invariants, ``rot`` one grid rotation,
    ``rhs`` one RHS evaluation given both, ``rk4_substep`` one Kahan RK4
    substep (4 RHS evaluations, 2 rotations, the stage sums and the Kahan
    step), ``dp54_step`` one tried DP5(4) step (6 RHS evaluations and
    their rotations, the stage sums, the error norm, the step factor),
    ``newton_iteration`` one Newton iteration (n_s + 1 RHS evaluations and
    rotations, the residual norm, the difference quotients, the LU solve
    with partial pivoting counted as its compares, divides, multiplies and
    subtractions, the update) and ``newton_check`` one residual check."""
    from pvderx_torch.native.kernels import _dp54_factor, _dp54_step
    from pvderx_torch.params import make_params, nominal_exog
    from pvderx_torch.physics import rhs_core
    from pvderx_torch.physics.xp import TorchXP

    p0 = make_params("10" if n_ph == 1 else "50")
    p = p0.to(torch.float64, "cpu")
    u = nominal_exog().to(torch.float64, "cpu")
    xp = TorchXP(torch.float64, "cpu")
    n_s = p0.n_states
    y = torch.zeros(n_s, dtype=torch.float64)
    t = torch.tensor(0.0, dtype=torch.float64)
    h = torch.tensor(1.0 / 60.0 / 400.0, dtype=torch.float64)

    def total(fn):
        with OpCounter() as c:
            fn()
        return c.classes()["total"]

    prep = rhs_core.prep_invariants(p, u, xp)
    rot = rhs_core.grid_rot(t, p, u, xp)
    n_prep = total(lambda: rhs_core.prep_invariants(p, u, xp))
    n_rot = total(lambda: rhs_core.grid_rot(t, p, u, xp))
    n_rhs = total(lambda: rhs_core.rhs(y, t, p, u, xp, prep, rot))
    f = lambda yy, tt: rhs_core.rhs(yy, tt, p, u, xp, prep)
    k1 = f(y, t)
    n_dp54 = total(lambda: _dp54_factor(_dp54_step(f, y, k1, t, h, 1e-10,
                                                   1e-10)[2]))
    # the stage times t0 + s·h, + h/2, + h (4); per state the stage sums
    # y + (h/2)k and y + h k (2 each, 3 stages), the RK4 sum
    # k1 + 2k2 + 2k3 + k4 (5) and the Kahan step (5)
    rk4 = 2 * n_rot + 4 * n_rhs + 4 + 16 * n_s
    # LU: the pivot compares, then per row below the pivot one divide, a
    # multiply and a subtract per remaining column and for b; back
    # substitution: a multiply and a subtract per known entry, one divide
    lu = sum((n_s - c - 1) * (1 + 1 + 2 * (n_s - c + 1))
             for c in range(n_s)) + sum(2 * (n_s - r - 1) + 1
                                        for r in range(n_s))
    check = n_rot + n_rhs + n_s                    # f(y), max |f|
    # column j: d_j (max, mul), y_j + d_j, then (f1 - f0) / d_j per row
    newton = check + n_s * (n_rot + n_rhs + 3 + 2 * n_s) + lu + 2 * n_s
    return dict(prep=n_prep, rot=n_rot, rhs=n_rhs, rk4_substep=rk4,
                dp54_step=n_dp54, newton_iteration=newton,
                newton_check=check)


def native_bound_ms(kernel: str, n: int, *, n_ph: int = 1, n_sub: int = 0,
                    tries: int = 0, iterations: int = 0,
                    chip: dict = H100) -> dict:
    """The least time one launch of a float64 engine kernel over ``n`` envs
    can take: its float64 bytes (each input read once, each output written
    once) over the memory rate and its operations (`native_op_counts`) over
    the FP64 rate, the larger as ``bound_ms`` with ``bound_by``. The work
    of the adaptive kernels is this run's: ``tries`` the DP5(4) steps the
    envs tried in all (``"dp54"``), ``iterations`` the Newton iterations
    they took in all (``"newton"``). ``kernel``: ``"rhs"`` (N4), ``"rk4"``
    (N1), ``"dp54"`` (N2), ``"newton"`` (N3)."""
    c = native_op_counts(n_ph)
    n_s = 6 * n_ph + 5
    packs = 29 + 15
    once = c["prep"] + c["rot"] + c["rhs"]
    ops, reads, writes, ints = {
        "rhs": (n * once, n_s + 1 + packs, n_s, 0),
        "rk4": (n * (c["prep"] + c["rot"] + n_sub * c["rk4_substep"]),
                n_s + 1 + packs, n_s, 0),
        "dp54": (n * once + tries * c["dp54_step"], n_s + 1 + packs, n_s, 2),
        "newton": (n * (c["prep"] + c["newton_check"])
                   + iterations * c["newton_iteration"], n_s + packs, n_s, 1),
    }[kernel]
    n_bytes = n * (8 * (reads + writes) + 4 * ints)
    bytes_ms = 1e3 * n_bytes / chip["hbm_bytes_per_s"]
    ops_ms = 1e3 * ops / chip["fp64_ops_per_s"]
    return dict(bytes=n_bytes, ops=ops, bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def lane_utilization(env_steps_per_s: float, *, n_sub: int, n_ph: int = 1,
                     m: int = 1, chip: dict = H100) -> dict:
    """A measured env-steps/s (one window each) against the ceilings: the
    kernel's operations per second, ``lane_util`` (one issue per operation:
    a lower bound on occupancy), ``lane_util_weighted`` (divides and
    transcendentals at `sfu_lane_issues` each) and the HBM share."""
    ops = substep_op_count(n_ph)
    issued = env_steps_per_s * ops["total"] * n_sub * m
    weighted = (ops["alu"] + ops["other"] + sfu_lane_issues(chip)
                * (ops["div"] + ops["transcendental"]))
    peak = lane_issue_per_s(chip)
    hbm = env_steps_per_s * window_hbm_bytes(n_ph, m)
    return {
        "chip": chip["name"],
        "ops_per_substep_per_der": ops["total"],
        "op_classes": {k: ops[k] for k in CLASSES},
        "kernel_ops_per_s": issued,
        "lane_issue_peak_per_s": peak,
        "lane_util": issued / peak,
        "lane_util_weighted": env_steps_per_s * weighted * n_sub * m / peak,
        "sfu_lane_issues_assumed": sfu_lane_issues(chip),
        "hbm_bytes_per_s": hbm,
        "hbm_util": hbm / chip["hbm_bytes_per_s"],
    }


__all__ = ["H100", "OpCounter", "at_clock", "lane_issue_per_s",
           "sfu_lane_issues", "substep_op_count", "ops_per_substep",
           "window_hbm_bytes", "window_bound_ms", "native_op_counts",
           "native_bound_ms", "lane_utilization"]
