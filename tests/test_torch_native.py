"""`pvderx_torch.native` (the float64 engine) against `pvderx.native` (the
reference's C++ engine, built here with g++) and `pvderx.oracle.scipy_ref`.

Each test twins one of tests/test_native.py's, on the CPU (``device="cpu"``:
the plain torch versions of the four kernels of `csrc/native.cu`, which
run only on the card; `chip_smoke.py` phase 36 holds the kernels to these
versions there). The parameters come over from the reference's by the
port's converter (`convert.params_from_numpy`), the states from its
oracle. Bounds: the RHS and the RK4 window within 1e-12 of both
references, a batch bit for bit its one-env calls, DP5(4) within 1e-8 of
LSODA and 1e-9 of the C++ DP5(4), the steady state within 1e-9 of fsolve
and of the C++ Newton, the 30-window trajectory under 5e-8 of LSODA.
"""
import dataclasses

import numpy as np
import pytest
import torch

from pvderx import native as ref_native
from pvderx.oracle import scipy_ref
from pvderx.params import make_params, nominal_exog
from pvderx_torch import native
from pvderx_torch.convert import params_from_numpy
from pvderx_torch.native import kernels
from pvderx_torch.params import Exog

EVENTFUL = dict(v_g=0.8, s_irr=700.0, q_ref=0.1, g_load=0.2, b_load=-0.05,
                v_g2=0.05, phi_g2=0.7, dw_g=0.004, t_g=0.5)
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _reference_engine():
    assert ref_native.available(), ref_native.load_error()


def port_params(p):
    return params_from_numpy(dataclasses.asdict(p), torch.float64, "cpu")


def port_exog(u):
    return Exog(**dataclasses.asdict(u))


def allclose(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def test_torch_native_packed_field_order_frozen():
    from pvderx_torch.ops.window import P_FIELDS, U_FIELDS

    assert native.P_ORDER == ref_native.P_ORDER == tuple(P_FIELDS)
    assert native.U_ORDER == ref_native.U_ORDER == tuple(U_FIELDS)
    p = make_params("50")
    pk = native.pack_params(port_params(p), **CPU)
    assert pk.dtype == torch.float64 and pk.shape == (29,)
    np.testing.assert_array_equal(pk.numpy(), ref_native.pack_params(p))
    u = dataclasses.replace(nominal_exog(), **EVENTFUL)
    np.testing.assert_array_equal(native.pack_exog(port_exog(u), **CPU),
                                  ref_native.pack_exog(u))


@pytest.mark.parametrize("preset", ["10", "50", "250"])
def test_torch_native_rhs_matches_references(preset):
    p = make_params(preset)
    u = dataclasses.replace(nominal_exog(), **EVENTFUL)
    pp, uu = port_params(p), port_exog(u)
    y_ss = scipy_ref.steady_state(p, nominal_exog())
    rng = np.random.default_rng(42)
    for _ in range(25):
        y = y_ss + rng.normal(0.0, 0.05, y_ss.shape)
        got = native.rhs(y, 0.123, pp, uu, **CPU)
        assert got.dtype == torch.float64 and got.device.type == "cpu"
        allclose(got, scipy_ref.rhs_np(y, 0.123, p, u), 1e-12)
        allclose(got, ref_native.rhs(y, 0.123, p, u), 1e-12)


def test_torch_native_rhs_tripped_and_const_vdc():
    p = make_params("50", const_vdc=1.0)
    u = dataclasses.replace(nominal_exog(p_ref=0.5), conn=0.0, ces=1.0)
    y = scipy_ref.steady_state(make_params("50"), nominal_exog())
    got = native.rhs(torch.tensor(y), 0.0, port_params(p), port_exog(u),
                     **CPU)
    allclose(got, scipy_ref.rhs_np(y, 0.0, p, u), 1e-12)
    allclose(got, ref_native.rhs(y, 0.0, p, u), 1e-12)


@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_native_rk4_window_matches_references(preset):
    p = make_params(preset)
    u = dataclasses.replace(nominal_exog(), v_g=0.7)
    y = scipy_ref.steady_state(p, nominal_exog())
    got = native.rk4_window(y, 0.0, 1 / 60, 72, port_params(p), port_exog(u),
                            **CPU)
    allclose(got, scipy_ref.rk4_window_np(y, 0.0, 1 / 60, 72, p, u), 1e-12)
    allclose(got, ref_native.rk4_window(y, 0.0, 1 / 60, 72, p, u), 1e-12)


@pytest.mark.parametrize("case,n", [("per_env_exog", 8), ("shared", 5),
                                    ("per_env_params", 11)])
def test_torch_native_batch_matches_sequential(case, n):
    """A batch equals its envs' one-env windows bit for bit (shared or
    per-env params and exog; N = 5 and 11 ragged against the CPU's 32-env
    blocks), and the reference's batch within 1e-12."""
    p0 = make_params("10")
    u0 = nominal_exog()
    u1 = dataclasses.replace(u0, v_g=0.75, s_irr=600.0)
    y = scipy_ref.steady_state(p0, u0)
    rng = np.random.default_rng(7)
    Y = np.stack([y + rng.normal(0, 0.02, y.shape) for _ in range(n)])
    t0 = np.arange(n, dtype=np.float64) / 60.0
    ps = [p0] if case != "per_env_params" else [
        dataclasses.replace(p0, rg=p0.rg * (1.0 + 0.1 * e)) for e in range(n)]
    us = [u0] if case == "shared" else [[u0, u1][e % 2] for e in range(n)]
    arg = lambda xs, conv: conv(xs[0]) if len(xs) == 1 else [conv(x)
                                                             for x in xs]
    out = native.rk4_window_batch(Y, t0, 1 / 60, 36, arg(ps, port_params),
                                  arg(us, port_exog), **CPU)
    assert out.shape == (n, 11) and out.dtype == torch.float64
    for e in range(n):
        one = native.rk4_window(Y[e], float(t0[e]), 1 / 60, 36,
                                port_params(ps[e % len(ps)]),
                                port_exog(us[e % len(us)]), **CPU)
        assert torch.equal(out[e], one), e
    ref = ref_native.rk4_window_batch(Y, t0, 1 / 60, 36, arg(ps, lambda x: x),
                                      arg(us, lambda x: x))
    allclose(out, ref, 1e-12)


def test_torch_native_batch_rejects_a_wrong_list():
    p, u = port_params(make_params("10")), port_exog(nominal_exog())
    with pytest.raises(ValueError, match="params list has 2 entries"):
        native.rk4_window_batch(np.zeros((3, 11)), 0.0, 1 / 60, 4, [p, p], u,
                                **CPU)
    with pytest.raises(ValueError, match="exog list has 2 entries"):
        native.rk4_window_batch(np.zeros((3, 11)), 0.0, 1 / 60, 4, p, [u, u],
                                **CPU)


def test_torch_native_dp54_matches_lsoda_and_native():
    """The 12-window sag of tests/test_native.py: every window from the
    port's state within 1e-8 of LSODA and 1e-9 of the C++ DP5(4)."""
    p = make_params("10")
    u = nominal_exog()
    u_sag = dataclasses.replace(u, v_g=0.6)
    pp = port_params(p)
    y = scipy_ref.steady_state(p, u)
    t = 0.0
    for k in range(12):
        uu = u_sag if 4 <= k < 8 else u
        y_l = scipy_ref.integrate_window(y, t, 1 / 60, p, uu)
        y_c = ref_native.dp54_window(y, t, 1 / 60, p, uu)
        got = native.dp54_window(y, t, 1 / 60, pp, port_exog(uu), **CPU)
        np.testing.assert_allclose(got, y_l, rtol=0, atol=1e-8)
        np.testing.assert_allclose(got, y_c, rtol=0, atol=1e-9)
        y = got.numpy()
        t += 1 / 60


def test_torch_native_steady_state_matches_fsolve():
    for preset in ("10", "50"):
        p = make_params(preset)
        u = nominal_exog()
        got = native.steady_state(port_params(p), port_exog(u), **CPU)
        np.testing.assert_allclose(got, scipy_ref.steady_state(p, u), rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(got, ref_native.steady_state(p, u),
                                   rtol=0, atol=1e-9)
        assert np.max(np.abs(scipy_ref.rhs_np(got.numpy(), 0.0, p, u))) < 1e-9


def test_torch_native_trajectory_equivalence():
    """End to end: the port's DP5(4) trajectory vs the LSODA trajectory
    < 5e-8 on tests/test_native.py's 30 windows (a 0.7 pu sag in windows
    10-19)."""
    p = make_params("10")
    u = nominal_exog()
    exogs = [dataclasses.replace(u, v_g=0.7) if 10 <= k < 20 else u
             for k in range(30)]
    tr = native.run_trajectory(port_params(p), [port_exog(e) for e in exogs],
                               **CPU)
    assert tr.shape == (31, 11) and tr.dtype == torch.float64
    assert np.max(np.abs(tr.numpy() - scipy_ref.run_trajectory(p, exogs))) < 5e-8


def test_torch_native_failures_raise_as_the_reference():
    """A DP5(4) window whose step underflows and a Newton solve that does
    not converge raise RuntimeError, in the reference and in the port."""
    p = make_params("10")
    u = nominal_exog()
    y = scipy_ref.steady_state(p, dataclasses.replace(u, v_g=0.6))
    with pytest.raises(RuntimeError, match="native DP54 failed"):
        ref_native.dp54_window(y, 0.0, 1 / 60, p, u, rtol=0.0, atol=1e-300)
    with pytest.raises(RuntimeError, match="native DP54 failed"):
        native.dp54_window(y, 0.0, 1 / 60, port_params(p), port_exog(u),
                           rtol=0.0, atol=1e-300, **CPU)
    with pytest.raises(RuntimeError, match="did not converge"):
        ref_native.steady_state(p, u, iters=1, tol=1e-300)
    with pytest.raises(RuntimeError, match="did not converge"):
        native.steady_state(port_params(p), port_exog(u), iters=1,
                            tol=1e-300, **CPU)


def test_torch_native_card_without_a_card_raises(monkeypatch):
    """No fallback: with no card, asking for it raises, and `available()`
    says why."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not native.available()
    assert "no CUDA device" in native.load_error()
    p, u = port_params(make_params("10")), port_exog(nominal_exog())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.rhs(np.zeros(11), 0.0, p, u)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        native.steady_state(p, u, device="cuda")


def test_torch_native_launchers_run_the_plain_version_only_on_the_cpu():
    """On CPU tensors a launcher is its plain version and counts no launch;
    on any device other than the CPU or a card it raises."""
    p, u = make_params("10"), nominal_exog()
    y = torch.tensor(scipy_ref.steady_state(p, u))[None]
    t = torch.zeros(1, dtype=torch.float64)
    pk = native.pack_params(port_params(p), **CPU)[:, None]
    uk = native.pack_exog(port_exog(u), **CPU)[:, None]
    before = [f.launches for f in kernels.LAUNCHERS]
    assert torch.equal(kernels.rhs_batch(y, t, pk, uk, n_ph=1),
                       kernels._rhs_ref(y, t, pk, uk, n_ph=1))
    y1, it = kernels.newton_batch(y, pk, uk, n_ph=1)
    assert int(it[0]) == 0 and torch.equal(y1, y)
    assert [f.launches for f in kernels.LAUNCHERS] == before
    meta = [a.to("meta") for a in (y, t, pk, uk)]
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernels.rhs_batch(*meta, n_ph=1)
    with pytest.raises(ValueError, match="takes float64"):
        kernels.rk4_batch(y.float(), t.float(), pk.float(), uk.float(),
                          n_ph=1, n_sub=2, dt=1 / 60)
