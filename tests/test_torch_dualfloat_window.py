"""The port's df32 RK4 window (pvderx_torch/ops/dualfloat.py) against the
reference df32 window kernel, the float64 RK4 window and its own wrapper
rules.

- The reference kernel body `pvderx.ops.dualfloat._window_kernel_df` is run
  eagerly: its module's `lax` is swapped (monkeypatch, this process only)
  for a namespace whose `fori_loop` is a Python loop passing `jnp.int32(k)`,
  the inputs are shaped [fields, 1, N] and numpy arrays serve as the output
  refs. (`rk4_window_batch_df(..., interpret=True)` compiles for minutes on
  the CPU, and `jax.disable_jit()` passes a Python int that `k.astype`
  rejects.) Nothing in `pvderx/` changes. Every operation on both sides is
  an eager IEEE float32 op in the same order: <= 1e-12 abs on hi + lo, and
  bitwise equal.
- Against `oracle.rk4_window_np` (float64 RK4 at the same f32-rounded
  inputs) at n_sub=48, dt=1/60: <= 5e-8, the bound of the reference's own
  test (tests/test_ops.py::test_dualfloat_window_kernel_interpret).
- On the CPU the wrapper runs the plain version and launches nothing; it
  takes float32 only and checks shapes; a tensor on a device other than the
  CPU or a card is refused.
- On a card (marked `gpu`, skipped here) K3 matches the plain version to
  1e-9 abs on hi + lo.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.ops import dualfloat as ref_df
from pvderx_torch import oracle
from pvderx_torch.ops.dualfloat import (
    rk4_window_batch_df, rk4_window_batch_df_ref)
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS
from pvderx_torch.params import make_params, nominal_exog

DT = 1.0 / 60.0


def _inputs(preset, n, seed, unbalanced=False, lo=True):
    """Seeded float32 numpy window inputs: per-env jittered rg and insolation,
    a random t0, and a normalized nonzero y_lo (~1e-9 relative)."""
    rng = np.random.default_rng(seed)
    p, u = make_params(preset), nominal_exog()
    y0 = oracle.steady_state(p, u)
    y64 = y0[None, :] + 1e-3 * rng.standard_normal((n, p.n_states))
    y64 *= 1.0 + 1e-9 * rng.standard_normal(y64.shape)
    y_hi = y64.astype(np.float32)
    y_lo = ((y64 - y_hi) if lo else 0.0 * y64).astype(np.float32)
    t0 = rng.uniform(0.0, 1.0, n).astype(np.float32)
    pp = np.array([np.full(n, getattr(p, f)) for f in P_FIELDS])
    uu = np.array([np.full(n, getattr(u, f)) for f in U_FIELDS])
    pp[P_FIELDS.index("rg")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    uu[U_FIELDS.index("s_irr")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    uu[U_FIELDS.index("dw_g")] = rng.uniform(-0.01, 0.01, n)
    if unbalanced:
        uu[U_FIELDS.index("v_g2")] = 0.1
        uu[U_FIELDS.index("phi_g2")] = rng.uniform(0.0, 2.0 * np.pi, n)
    return p.n_ph, y_hi, y_lo, t0, pp.astype(np.float32), uu.astype(np.float32)


class _EagerLax:
    """`lax` for the reference kernel body run eagerly."""

    @staticmethod
    def fori_loop(lo, hi, body, carry):
        for k in range(lo, hi):
            carry = body(jnp.int32(k), carry)
        return carry


def reference_window_df(monkeypatch, y_hi, y_lo, t0, pp, uu, *, n_ph, n_sub,
                        dt):
    """The reference df32 kernel body, eagerly, on [fields, 1, N] tiles."""
    monkeypatch.setattr(ref_df, "lax", _EagerLax)
    h64 = np.float64(dt) / n_sub
    h_hi = np.float32(h64)
    h_lo = np.float32(h64 - np.float64(h_hi))
    n, n_s = y_hi.shape
    tile = lambda a: jnp.asarray(np.ascontiguousarray(a)[:, None, :])
    out_hi = np.zeros((n_s, 1, n), np.float32)
    out_lo = np.zeros((n_s, 1, n), np.float32)
    ref_df._window_kernel_df(
        tile(t0[None, :]), tile(y_hi.T), tile(y_lo.T), tile(pp), tile(uu),
        out_hi, out_lo, n_ph=n_ph, n_sub=n_sub, h_hi=float(h_hi),
        h_lo=float(h_lo))
    return out_hi[:, 0].T, out_lo[:, 0].T


def _port(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


@pytest.mark.parametrize("preset,unbalanced", [("10", False), ("50", True)])
def test_torch_df_window_matches_reference_kernel_body(monkeypatch, preset,
                                                       unbalanced):
    n, n_sub = 64, 4
    dt = n_sub * DT / 64       # the main path's h = (1/60)/64
    n_ph, *arrs = _inputs(preset, n, int(preset), unbalanced)
    assert np.abs(arrs[1]).max() > 0.0          # lo is live on input
    want_hi, want_lo = reference_window_df(monkeypatch, *arrs, n_ph=n_ph,
                                           n_sub=n_sub, dt=dt)
    got_hi, got_lo = rk4_window_batch_df_ref(*_port(*arrs), n_ph=n_ph,
                                             n_sub=n_sub, dt=dt)
    val = lambda hi, lo: np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    assert got_hi.shape == want_hi.shape and got_hi.dtype == torch.float32
    err = np.abs(val(got_hi.numpy(), got_lo.numpy()) - val(want_hi, want_lo))
    assert err.max() <= 1e-12, err.max()
    assert np.array_equal(got_hi.numpy().view(np.int32), want_hi.view(np.int32))
    assert np.array_equal(got_lo.numpy().view(np.int32), want_lo.view(np.int32))
    assert np.abs(got_lo.numpy()).max() > 0.0


def test_torch_df_window_matches_f64_rk4():
    """One 48-substep window against float64 RK4 at the f32-rounded inputs:
    the ~4e-11 per-evaluation df32 noise stays below 5e-8."""
    n_ph, y_hi, y_lo, t0, pp, uu = _inputs("10", 2, 5, lo=False)
    t0[:] = 0.0
    got_hi, got_lo = rk4_window_batch_df(*_port(y_hi, y_lo, t0, pp, uu),
                                         n_ph=n_ph, n_sub=48, dt=DT)
    got = got_hi.numpy().astype(np.float64) + got_lo.numpy()
    p = make_params("10")
    for e in range(2):
        pe = dataclasses.replace(
            p, **{f: float(pp[i, e]) for i, f in enumerate(P_FIELDS)})
        ue = dataclasses.replace(
            nominal_exog(), **{f: float(uu[i, e]) for i, f in enumerate(U_FIELDS)})
        want = oracle.rk4_window_np(y_hi[e].astype(np.float64), 0.0, DT, 48,
                                    pe, ue)
        assert np.abs(got[e] - want).max() < 5e-8, np.abs(got[e] - want).max()


def test_torch_df_window_cpu_runs_plain_and_checks_arguments():
    n_ph, *arrs = _inputs("10", 7, 1)         # ragged N
    args = _port(*arrs)
    kw = dict(n_ph=n_ph, n_sub=2, dt=2 * DT / 64)
    before = rk4_window_batch_df.launches
    hi, lo = rk4_window_batch_df(*args, **kw)
    ref_hi, ref_lo = rk4_window_batch_df_ref(*args, **kw)
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)
    assert rk4_window_batch_df.launches == before
    y_hi, y_lo, t0, pp, uu = args
    bad = [
        (y_hi.double(), y_lo.double(), t0.double(), pp.double(), uu.double()),
        (y_hi, y_lo[:, :5], t0, pp, uu),                 # lo shape
        (y_hi, y_lo.double(), t0, pp, uu),               # lo dtype
        (y_hi[:, :5], y_lo[:, :5], t0, pp, uu),          # state width
        (y_hi, y_lo, t0[:3], pp, uu),                    # t0 length
        (y_hi, y_lo, t0, pp[:28], uu),                   # params pack
        [a.to("meta") for a in args],                    # not CPU, not a card
    ]
    for case in bad:
        with pytest.raises(ValueError):
            rk4_window_batch_df(*case, **kw)
    with pytest.raises(ValueError):
        rk4_window_batch_df(*args, n_ph=2, n_sub=2, dt=DT)
    assert rk4_window_batch_df.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("preset,unbalanced", [("10", False), ("50", True)])
def test_torch_df_window_cuda_kernel_matches_plain(preset, unbalanced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the df32 kernel has no CPU mode")
    n_ph, *arrs = _inputs(preset, 1000, 3, unbalanced)   # ragged N
    args = [torch.tensor(a, device="cuda") for a in arrs]
    kw = dict(n_ph=n_ph, n_sub=8, dt=8 * DT / 64)
    before = rk4_window_batch_df.launches
    hi, lo = rk4_window_batch_df(*args, **kw)
    ref_hi, ref_lo = rk4_window_batch_df_ref(*args, **kw)
    torch.cuda.synchronize()
    assert rk4_window_batch_df.launches == before + 1
    err = float(((hi.double() + lo.double())
                 - (ref_hi.double() + ref_lo.double())).abs().max())
    assert np.isfinite(err) and err <= 1e-9, err
