"""The port's double-float arithmetic (pvderx_torch/ops/dualfloat.py) against
the JAX package's (pvderx/ops/dualfloat.py).

Seeded numpy float32 pairs go through both. Every DF operation is a chain of
eager IEEE float32 elementwise ops in the same order on both sides, so hi and
lo are expected bitwise equal. One exception, stated where it is checked:
XLA's CPU runtime flushes subnormal results to zero, so a lo that falls
below the smallest normal float32 (exp of a large negative argument) is 0 in
the reference and subnormal in torch.

The DF `rhs_core.rhs` of the port (presets 10 and 50; nominal, const-Vdc and
unbalanced; a [n_s, N] batch) is held against the JAX DF RHS (<= 1e-10 abs
on hi + lo in float64, bitwise expected) and against the float64 numpy RHS
at the same f32-rounded inputs (<= 1e-9, the reference's own bound in
tests/test_ops.py).

`OPS_PER_SUBSTEP_DF` is recomputed from the reference df32 program with the
reference's own jaxpr op counter and pinned.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.ops import dualfloat as ref_df
from pvderx.params import DERParams as JP
from pvderx.params import Exog as JU
from pvderx.params import make_params as jax_make_params
from pvderx.params import nominal_exog as jax_nominal_exog
from pvderx.physics import rhs_core as ref_core
from pvderx_torch.ops import dualfloat as df
from pvderx_torch.ops.dualfloat import (
    OPS_PER_SUBSTEP_DF, window_df_bytes, window_df_ops)
from pvderx_torch.physics import rhs_core as port_core

TINY = np.finfo(np.float32).tiny


def _pairs(n, seed, scale=1.0, offset=0.0):
    """Seeded normalized float32 (hi, lo) pairs: |lo| <= ulp(hi)/2."""
    rng = np.random.default_rng(seed)
    v = offset + scale * rng.standard_normal(n)
    v = v * (1.0 + rng.uniform(-1.0, 1.0, n) * 2.0 ** -30)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def _ref(hi, lo):
    return ref_df.DF(jnp.asarray(hi), jnp.asarray(lo))


def _port(hi, lo):
    return df.DF(torch.from_numpy(hi), torch.from_numpy(lo))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _assert_same(want, got, flush_lo=False):
    """hi and lo bitwise equal; with ``flush_lo``, a reference lo of 0 may
    stand against a subnormal torch lo (XLA's CPU runtime flushes them)."""
    w_hi, w_lo = np.asarray(want.hi), np.asarray(want.lo)
    g_hi, g_lo = got.hi.numpy(), got.lo.numpy()
    assert np.array_equal(_bits(w_hi), _bits(g_hi))
    same_lo = _bits(w_lo) == _bits(g_lo)
    if flush_lo:
        same_lo |= (w_lo == 0.0) & (np.abs(g_lo) < TINY)
    assert same_lo.all(), np.abs(w_lo.astype(np.float64) - g_lo).max()


@pytest.mark.parametrize("prim", ["two_sum", "quick_two_sum", "two_prod"])
def test_torch_df_error_free_transforms_bitwise(prim):
    a, _ = _pairs(4096, 1, scale=3.0)
    b, _ = _pairs(4096, 2, scale=1e-3 if prim == "quick_two_sum" else 2.0)
    want = getattr(ref_df, f"_{prim}")(jnp.asarray(a), jnp.asarray(b))
    got = getattr(df, f"_{prim}")(torch.from_numpy(a), torch.from_numpy(b))
    for w, g in zip(want, got):
        assert np.array_equal(_bits(w), _bits(g.numpy()))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "truediv", "rsub",
                                "rtruediv", "const_mul", "square", "sqrt",
                                "pow_m16"])
def test_torch_df_arithmetic_bitwise(op):
    x = _pairs(4096, 3, scale=3.0)
    y = _pairs(4096, 4, scale=2.0, offset=0.5)
    pos = _pairs(4096, 5, scale=0.5, offset=2.0)
    cases = {
        "add": lambda m, a, b, p: a + b,
        "sub": lambda m, a, b, p: a - b,
        "mul": lambda m, a, b, p: a * b,
        "truediv": lambda m, a, b, p: a / b,
        "rsub": lambda m, a, b, p: 0.1 - a,
        "rtruediv": lambda m, a, b, p: 1.0 / b,
        "const_mul": lambda m, a, b, p: (1.0 / 6.0) * a,
        "square": lambda m, a, b, p: a ** 2,
        "sqrt": lambda m, a, b, p: m._sqrt(p),
        "pow_m16": lambda m, a, b, p: p ** (-1.0 / 16.0),
    }
    f = cases[op]
    want = f(ref_df, _ref(*x), _ref(*y), _ref(*pos))
    got = f(df, _port(*x), _port(*y), _port(*pos))
    _assert_same(want, got)


def test_torch_df_sincos_bitwise_every_quadrant():
    """+-100 rad: every quadrant and negative reduction multiples k."""
    hi, lo = _pairs(8192, 6, scale=40.0)
    hi = np.clip(hi, -100.0, 100.0)
    k = np.round(hi * (2.0 / np.pi))
    assert set(np.mod(k, 4.0)) == {0.0, 1.0, 2.0, 3.0} and (k < 0).any()
    ws, wc = ref_df._sincos(_ref(hi, lo))
    gs, gc = df._sincos(_port(hi, lo))
    _assert_same(ws, gs)
    _assert_same(wc, gc)
    # and it is a DF-grade sin/cos
    x = hi.astype(np.float64) + lo
    val = lambda d: d.hi.numpy().astype(np.float64) + d.lo.numpy()
    assert np.abs(val(gs) - np.sin(x)).max() < 5e-11
    assert np.abs(val(gc) - np.cos(x)).max() < 5e-11


def test_torch_df_exp_bitwise_with_clamp():
    """[-100, 100]: past +-80 the clamp and the zeroed lo."""
    hi, lo = _pairs(8192, 7, scale=45.0)
    hi = np.clip(hi, -100.0, 100.0)
    assert (hi > 80.0).any() and (hi < -80.0).any()
    want = ref_df._exp_df(_ref(hi, lo))
    got = df._exp_df(_port(hi, lo))
    _assert_same(want, got, flush_lo=True)
    inside = np.abs(hi) < 30.0
    x = hi.astype(np.float64) + lo
    val = got.hi.numpy().astype(np.float64) + got.lo.numpy()
    assert np.abs(val[inside] / np.exp(x[inside]) - 1.0).max() < 2e-11


def test_torch_df_constants_split_exactly_and_cached():
    c = df._lift(1.0 / 6.0, "cpu")
    assert c is df._lift(1.0 / 6.0, "cpu")
    w = ref_df._lift(1.0 / 6.0)
    assert _bits(c.hi.numpy()) == _bits(w.hi) and _bits(c.lo.numpy()) == _bits(w.lo)
    assert float(c.hi) + float(c.lo) == pytest.approx(1.0 / 6.0, abs=1e-15)
    assert df._lift(-0.0, "cpu") is not df._lift(0.0, "cpu")


def test_torch_df_shift_angles_pairs_equal_reference():
    """The port's `_shift_angles` takes the asarray branch, the reference's
    DF namespace the iota/where branch: the same exact pairs."""
    got = port_core._shift_angles(3, df.DFXP(), None, 1)
    want = ref_core._shift_angles(3, ref_df.dfp, None, 1)
    assert tuple(got.shape) == (3, 1) == tuple(want.shape)
    _assert_same(want, got)
    assert float(got.hi[1, 0]) + float(got.lo[1, 0]) == pytest.approx(
        -2.0 * np.pi / 3.0, abs=1e-14)


def _rhs_inputs(preset, variant, n, seed):
    """Seeded float32 params/exog/state per env; returns the dicts of f32
    numpy leaves and y [n_s, N]."""
    rng = np.random.default_rng(seed)
    over = dict(const_vdc=1.0) if variant == "const_vdc" else {}
    p = jax_make_params(preset, **over)
    u = jax_nominal_exog(p_ref=0.6 if variant == "const_vdc" else 0.0)
    u = dataclasses.replace(u, v_g=0.55, phi_g=0.3, dw_g=0.01, t_g=0.2,
                            s_irr=700.0, t_cell=310.0, q_ref=0.1)
    if variant == "unbalanced":
        u = dataclasses.replace(u, v_g2=0.15, phi_g2=1.1, g_load=0.2,
                                b_load=-0.05)
    y0 = ref_core.steady_state_guess(p, u, np)
    f32 = lambda v: np.asarray(v, np.float32)
    pd = {f.name: (getattr(p, f.name) if f.name == "n_ph" else f32(
        np.full(n, getattr(p, f.name)) * (1.0 + (0.1 if f.name in ("rg", "xg")
                                                   else 0.0)
                                          * rng.uniform(-1.0, 1.0, n))))
          for f in dataclasses.fields(p)}
    ud = {f.name: f32(np.full(n, getattr(u, f.name))
                      * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, n)))
          for f in dataclasses.fields(u)}
    y = f32(y0[:, None] + 1e-3 * rng.standard_normal((len(y0), n)))
    return pd, ud, y


@pytest.mark.parametrize("preset,variant", [
    ("10", "nominal"), ("10", "const_vdc"), ("50", "nominal"),
    ("50", "const_vdc"), ("50", "unbalanced")])
def test_torch_df_rhs_matches_reference_and_f64(preset, variant):
    n = 16
    pd, ud, y = _rhs_inputs(preset, variant, n, seed=int(preset) + len(variant))
    t = np.float32(0.37)

    lift_j = lambda v: ref_df.DF(jnp.asarray(v))
    pj = JP(**{k: (v if k == "n_ph" else lift_j(v)) for k, v in pd.items()})
    uj = JU(**{k: lift_j(v) for k, v in ud.items()})
    want = ref_core.rhs(lift_j(y), lift_j(t), pj, uj, ref_df.dfp)

    lift_t = lambda v: df.DF(torch.from_numpy(np.asarray(v)))
    from pvderx_torch.params import DERParams, Exog
    pt = DERParams(**{k: (v if k == "n_ph" else lift_t(v)) for k, v in pd.items()})
    ut = Exog(**{k: lift_t(v) for k, v in ud.items()})
    got = port_core.rhs(lift_t(y), lift_t(t), pt, ut, df.DFXP())

    val = lambda hi, lo: np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    g = val(got.hi.numpy(), got.lo.numpy())
    assert g.shape == y.shape
    assert np.abs(g - val(want.hi, want.lo)).max() <= 1e-10
    _assert_same(want, got)

    f64 = lambda v: np.asarray(v, np.float64)
    truth = ref_core.rhs(f64(y), f64(t), JP(**{k: (v if k == "n_ph" else f64(v))
                                              for k, v in pd.items()}),
                         JU(**{k: f64(v) for k, v in ud.items()}), np)
    assert np.abs(g - truth).max() <= 1e-9, np.abs(g - truth).max()


# the reference df32 substep as written: Dekker two-product, a full sin/cos
# evaluation for each of sin and cos, jit call wrappers counted
REFERENCE_PROGRAM_OPS = {1: 28818, 3: 52718}


def test_torch_df_window_op_count_is_the_reference_programs(monkeypatch):
    """OPS_PER_SUBSTEP_DF is the reference df32 substep's jaxpr op count
    (`pvderx/diag/roofline.py::_count_jaxpr`, `_classify`), with the hoisted
    Prep and first grid rotation subtracted and the substep's start time an
    input, as `substep_op_count` counts K1's program; counted with the work
    the function needs and the CUDA kernel does: the two-product error as an
    FMA (here p = a*b, e = a*b - p: 3 ops, as mul + fma count 3 flops), one
    sin/cos evaluation per phasor, and no jit call wrappers. The program as
    written is pinned too."""
    from collections import Counter

    import jax

    from pvderx.diag.roofline import _classify, _count_jaxpr
    from pvderx.params import make_params as jax_make_params
    from pvderx.params import nominal_exog as jax_nominal_exog
    from pvderx.physics import rhs_core

    DF, dfp = ref_df.DF, ref_df.dfp
    lift = lambda tree: jax.tree.map(lambda v: DF(v, jnp.zeros_like(v)), tree)

    def fma_two_prod(a, b):
        p = a * b
        return p, a * b - p

    def cexpj_once(phi, xp):
        s, c = ref_df._sincos(ref_df._lift(phi))
        return rhs_core.C(c, s)

    def counts(n_ph, needed):
        p0 = jax_make_params("10" if n_ph == 1 else "50").astype(jnp.float32)
        pj = jax.tree.map(jnp.float32, p0)
        uj = jax.tree.map(jnp.float32, jax_nominal_exog())

        def substep(yh, yl, t, hh, hl, p, u):
            p, u, y = lift(p), lift(u), DF(yh, yl)
            t, h = DF(t, jnp.zeros_like(t)), DF(hh, hl)
            prep = rhs_core.prep_invariants(p, u, dfp)
            r1 = rhs_core.grid_rot(t, p, u, dfp)
            rh = rhs_core.grid_rot(t + 0.5 * h, p, u, dfp)
            r4 = rhs_core.grid_rot(t + h, p, u, dfp)
            k1 = rhs_core.rhs(y, t, p, u, dfp, prep, r1)
            k2 = rhs_core.rhs(y + (0.5 * h) * k1, t + 0.5 * h, p, u, dfp,
                              prep, rh)
            k3 = rhs_core.rhs(y + (0.5 * h) * k2, t + 0.5 * h, p, u, dfp,
                              prep, rh)
            k4 = rhs_core.rhs(y + h * k3, t + h, p, u, dfp, prep, r4)
            y1 = y + (h * (1.0 / 6.0)) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            return y1.hi, y1.lo, r4

        def hoisted(t, p, u):
            p, u, t = lift(p), lift(u), DF(t, jnp.zeros_like(t))
            return (rhs_core.prep_invariants(p, u, dfp),
                    rhs_core.grid_rot(t, p, u, dfp))

        y = jnp.zeros((p0.n_states,), jnp.float32)
        z = jnp.float32(0.0)
        c, hc = Counter(), Counter()
        with monkeypatch.context() as m:
            if needed:
                m.setattr(ref_df, "_two_prod", fma_two_prod)
                m.setattr(rhs_core, "cexpj", cexpj_once)
            _count_jaxpr(jax.make_jaxpr(substep)(y, y, z, z, z, pj, uj).jaxpr, c)
            _count_jaxpr(jax.make_jaxpr(hoisted)(z, pj, uj).jaxpr, hc)
        c = c - hc
        if needed:
            c.pop("jit", None)
        return _classify(c)

    for n_ph in (1, 3):
        c = counts(n_ph, needed=False)
        assert c["total"] == REFERENCE_PROGRAM_OPS[n_ph], (n_ph, c["total"])
        c = counts(n_ph, needed=True)
        assert c["transcendental"] == 0       # sin/cos/exp are DF polynomials
        assert c["total"] == OPS_PER_SUBSTEP_DF[n_ph], (n_ph, c["total"])
    assert window_df_ops(32768, 1, 64) == 14746 * 64 * 32768
    # (t0, y_hi, y_lo, 29 params, 15 exog) read, (hi, lo) written, f32
    assert window_df_bytes(1, 1) == 4 * (1 + 4 * 11 + 29 + 15)
    assert window_df_bytes(1, 3) == 4 * (1 + 4 * 23 + 29 + 15)
