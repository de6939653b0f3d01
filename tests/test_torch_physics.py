"""The port's physics (pvderx_torch/physics) against the JAX package's.

The torch `rhs_core` copy, run in float64 on the CPU through the torch `xp`
namespace, must equal the reference `pvderx.physics.rhs_core` run on numpy
float64, to 1e-12 relative to max |reference|, for one env [n_s] and a batch
[n_s, N] (env axis trailing), on every preset, the const-Vdc variant and an
unbalanced grid. Inputs are seeded numpy, handed to both.
"""
import dataclasses

import jax  # noqa: F401  (conftest pins JAX to the CPU in float64)
import numpy as np
import pytest
import torch

from pvderx.params import make_params as jax_make_params
from pvderx.params import nominal_exog as jax_nominal_exog
from pvderx.physics import rhs_core as ref_core
from pvderx_torch.params import DERParams, Exog
from pvderx_torch.physics import rhs_core as port_core
from pvderx_torch.physics.xp import TorchXP

REL_TOL = 1e-12


def _inputs(preset, variant, n, seed):
    """Seeded numpy params/exog/state; n=None gives one env."""
    rng = np.random.default_rng(seed)
    over = dict(const_vdc=1.0) if variant == "const_vdc" else {}
    p = jax_make_params(preset, **over)
    u = jax_nominal_exog(p_ref=0.6 if variant == "const_vdc" else 0.0)
    u = dataclasses.replace(u, v_g=0.8, phi_g=0.3, dw_g=0.01, t_g=0.2,
                            s_irr=700.0, t_cell=310.0, q_ref=0.1)
    if variant == "unbalanced":
        u = dataclasses.replace(u, v_g2=0.15, phi_g2=1.1, g_load=0.2,
                                b_load=-0.05)
    y0 = ref_core.steady_state_guess(p, u, np)
    shape = () if n is None else (n,)

    def leaf(v, jitter):
        return np.asarray(v, np.float64) * (
            1.0 + jitter * rng.uniform(-1.0, 1.0, shape))

    pd = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    pd = {k: (v if k == "n_ph" else leaf(v, 0.1 if k in ("rg", "xg") else 0.0))
          for k, v in pd.items()}
    ud = {f.name: leaf(getattr(u, f.name), 0.05)
          for f in dataclasses.fields(u)}
    y = (y0[:, None] if n is not None else y0) + 1e-2 * rng.standard_normal(
        y0.shape + shape)
    t = np.float64(0.37)
    return pd, ud, y, t


def _ref(pd, ud, y, t):
    from pvderx.params import DERParams as JP, Exog as JU
    return JP(**pd), JU(**ud)


def _port(pd, ud):
    f = lambda v: torch.as_tensor(v, dtype=torch.float64)
    return (DERParams(**{k: (v if k == "n_ph" else f(v)) for k, v in pd.items()}),
            Exog(**{k: f(v) for k, v in ud.items()}))


@pytest.mark.parametrize("batch", [None, 5], ids=["one_env", "batch5"])
@pytest.mark.parametrize("variant", ["nominal", "const_vdc", "unbalanced"])
@pytest.mark.parametrize("preset", ["10", "50", "250"])
def test_torch_rhs_matches_reference(preset, variant, batch):
    pd, ud, y, t = _inputs(preset, variant, batch, seed=int(preset) + len(variant))
    p, u = _ref(pd, ud, y, t)
    want = ref_core.rhs(y, t, p, u, np)
    pt, ut = _port(pd, ud)
    got = port_core.rhs(torch.from_numpy(y), torch.tensor(t), pt, ut, TorchXP())
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err <= REL_TOL, err


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_algebra_and_neg_seq_match_reference(preset):
    """Every algebraic intermediate (the observation surface) and the
    negative-sequence diagnostic, hoisted prep and grid rotation included."""
    pd, ud, y, t = _inputs(preset, "unbalanced", 4, seed=7)
    p, u = _ref(pd, ud, y, t)
    pt, ut = _port(pd, ud)
    xp = TorchXP()
    prep_r = ref_core.prep_invariants(p, u, np, bdims=1)
    prep_t = port_core.prep_invariants(pt, ut, xp, bdims=1)
    rot_r = ref_core.grid_rot(t, p, u, np)
    rot_t = port_core.grid_rot(torch.tensor(t), pt, ut, xp)
    g_r = ref_core.algebra(y, t, p, u, np, prep_r, rot_r)
    g_t = port_core.algebra(torch.from_numpy(y), torch.tensor(t), pt, ut, xp,
                            prep_t, rot_t)
    for name, a, b in zip(ref_core.Algebra._fields, g_r, g_t):
        parts = (zip(a, b) if isinstance(a, ref_core.C)
                 else [(a, b)])
        for ar, bt in parts:
            ar = np.asarray(ar)
            scale = max(np.abs(ar).max(), 1e-300)
            assert np.abs(bt.numpy() - ar).max() <= REL_TOL * max(scale, 1.0), name
    ns_r = ref_core.neg_seq(g_r.v, p.n_ph, np)
    ns_t = port_core.neg_seq(g_t.v, pt.n_ph, xp)
    for ar, bt in zip(ns_r, ns_t):
        assert np.abs(bt.numpy() - ar).max() <= REL_TOL


@pytest.mark.parametrize("preset", ["10", "50", "250"])
def test_torch_steady_state_guess_matches_reference(preset):
    pd, ud, _, _ = _inputs(preset, "nominal", None, seed=3)
    p, u = _ref(pd, ud, None, None)
    pt, ut = _port(pd, ud)
    want = ref_core.steady_state_guess(p, u, np)
    got = port_core.steady_state_guess(pt, ut, TorchXP())
    assert np.abs(got.numpy() - want).max() <= REL_TOL * np.abs(want).max()


def test_torch_xp_constants_follow_namespace_dtype():
    """Constants the physics creates take the namespace's dtype: float64
    angle tables (as numpy), float32 in a float32 evaluation."""
    a64 = port_core._shift_angles(3, TorchXP(torch.float64))
    a32 = port_core._shift_angles(3, TorchXP(torch.float32), None, 1)
    assert a64.dtype == torch.float64 and a32.dtype == torch.float32
    assert tuple(a32.shape) == (3, 1)
    np.testing.assert_array_equal(a64.numpy(),
                                  ref_core._shift_angles(3, np))
    xp = TorchXP()
    x = torch.tensor([0.5, 9.0])
    assert torch.equal(xp.minimum(x, 8.0), torch.tensor([0.5, 8.0]))
    assert torch.equal(xp.maximum(0.7, x), torch.tensor([0.7, 9.0]))
