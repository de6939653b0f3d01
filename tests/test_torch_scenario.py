"""The port's scenario layer (pvderx_torch/scenario) against the reference.

Same seeded numpy inputs through both packages: event lookup, exog assembly,
ride-through, MPPT and Volt-VAR. Timers, trip latches, cessation flags and
MPPT direction bits must match exactly; float outputs match exactly or to
float64 roundoff.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.scenario import events as ref_ev
from pvderx.scenario import mppt_voltvar as ref_mv
from pvderx.scenario import ride_through as ref_rt
from pvderx_torch.scenario import events as ev
from pvderx_torch.scenario import mppt_voltvar as mv
from pvderx_torch.scenario import ride_through as rt


def _tables(rng, n, k, d):
    """Sorted time columns, t=0 baseline row, +inf padding, per env."""
    t = np.sort(rng.uniform(0.0, 5.0, (n, k)), axis=1)
    t[:, 0] = 0.0
    pad = rng.integers(0, k - 1, n)
    for i in range(n):
        if pad[i]:
            t[i, k - pad[i]:] = np.inf
    vals = rng.uniform(-1.0, 2.0, (n, k, d - 1))
    return np.concatenate([t[..., None], vals], -1)


def test_torch_active_row_matches_reference():
    rng = np.random.default_rng(0)
    n = 64
    for k, d in ((4, 3), (4, 6), (2, 3)):
        tab = _tables(rng, n, k, d)
        t = rng.uniform(0.0, 6.0, n)
        t[:4] = tab[:4, 1, 0]          # exactly at an event time
        want = np.asarray(jax.vmap(ref_ev.active_row)(jnp.asarray(tab),
                                                      jnp.asarray(t)))
        got = ev.active_row(torch.from_numpy(tab), torch.from_numpy(t))
        np.testing.assert_array_equal(got.numpy(), want)


def test_torch_make_exog_matches_reference():
    rng = np.random.default_rng(1)
    n = 32
    tabs = dict(solar=_tables(rng, n, 4, 3), grid=_tables(rng, n, 4, 6),
                load=_tables(rng, n, 2, 3))
    t, vr, qr, conn, ces = (rng.uniform(0, 6, n), rng.uniform(0.7, 1.2, n),
                            rng.uniform(-0.5, 0.5, n),
                            (rng.uniform(size=n) < 0.5) * 1.0,
                            (rng.uniform(size=n) < 0.5) * 1.0)
    want = jax.vmap(ref_ev.make_exog)(
        ref_ev.EventSchedule(**{k: jnp.asarray(v) for k, v in tabs.items()}),
        *(jnp.asarray(a) for a in (t, vr, qr, conn, ces)))
    got = ev.make_exog(
        ev.EventSchedule(**{k: torch.from_numpy(v) for k, v in tabs.items()}),
        *(torch.from_numpy(a) for a in (t, vr, qr, conn, ces)))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)), f.name)


def test_torch_event_builder_matches_reference():
    def script(b):
        b.add_solar_event(0.5, 400.0)
        b.add_grid_event(0.3, v=0.5)
        b.add_grid_event(0.6, v=1.0, phi=0.2, dw=0.01, v2=0.1, phi2=0.4)
        b.add_load_event(0.2, g_load=0.3, b_load=-0.1)
        b.add_grid_event(0.9, v=0.7)
        b.remove_grid_event(0.9)
        return b

    want = script(ref_ev.EventBuilder()).build(4, 4, 2, dtype=np.float64)
    got = script(ev.EventBuilder()).build(4, 4, 2, dtype=torch.float64,
                                          device="cpu")
    for k in ("solar", "grid", "load"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(want, k))
    with pytest.raises(ValueError):
        b = ev.EventBuilder()
        for i in range(3):
            b.add_load_event(float(i + 1))
        b.build(k_load=2, device="cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("enabled", [True, False])
def test_torch_ride_through_sequence_matches_reference(dtype, enabled):
    """A seeded 200-step walk of v_mag/f_meas through every zone: timers,
    the trip latch and cessation, exactly."""
    rng = np.random.default_rng(2 + enabled)
    n, steps, dt = 16, 200, 1.0 / 60.0
    v = 1.0 + np.cumsum(rng.normal(0, 0.04, (steps, n)), 0)
    v = np.clip(v, 0.3, 1.3)
    f = np.clip(1.0 + np.cumsum(rng.normal(0, 0.004, (steps, n)), 0), 0.95, 1.05)
    npd = np.dtype(dtype)
    tdt = getattr(torch, dtype)
    rtp_ref = jax.tree.map(lambda a: np.asarray(a, npd),
                           ref_rt.default_rt_params(enabled))
    rtp = rt.default_rt_params(enabled, tdt, "cpu")
    upd = jax.jit(jax.vmap(lambda s, vv, ff: ref_rt.rt_update(
        s, rtp_ref, vv, ff, jnp.asarray(dt, npd)), in_axes=(0, 0, 0)))
    s_ref = jax.vmap(lambda _: ref_rt.rt_init(npd))(jnp.arange(n))
    s = rt.rt_init((n,), tdt, "cpu")
    for k in range(steps):
        s_ref = upd(s_ref, jnp.asarray(v[k], npd), jnp.asarray(f[k], npd))
        s = rt.rt_update(s, rtp, torch.tensor(v[k], dtype=tdt),
                         torch.tensor(f[k], dtype=tdt), dt)
        for name in ("timers", "tripped", "ces"):
            np.testing.assert_array_equal(getattr(s, name).numpy(),
                                          np.asarray(getattr(s_ref, name)),
                                          f"{name} at step {k}")
    assert enabled == bool(s.tripped.any())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_mppt_sequence_matches_reference(dtype):
    """P&O over a seeded power walk with plateaus inside the deadband:
    p_prev, direction bits and vdc_ref, exactly."""
    rng = np.random.default_rng(4)
    n, steps, n_mppt = 16, 120, 3
    npd = np.dtype(dtype)
    tdt = getattr(torch, dtype)
    p = 0.8 + np.cumsum(rng.normal(0, 1e-3, (steps, n)), 0)
    p[::5] = p[np.maximum(np.arange(0, steps, 5) - 1, 0)] + 5e-7  # deadband
    upd = jax.jit(jax.vmap(lambda ms, vr, pp, k: ref_mv.mppt_update(
        ms, vr, pp, k, n_mppt)))
    ms_ref = jax.vmap(lambda p0: ref_mv.mppt_init(p0, npd))(jnp.asarray(p[0], npd))
    vr_ref = jnp.ones(n, npd)
    ms = mv.mppt_init(torch.tensor(p[0], dtype=tdt))
    vr = torch.ones(n, dtype=tdt)
    for k in range(steps):
        kk = np.full(n, k, np.int32)
        ms_ref, vr_ref = upd(ms_ref, vr_ref, jnp.asarray(p[k], npd),
                             jnp.asarray(kk))
        ms, vr = mv.mppt_update(ms, vr, torch.tensor(p[k], dtype=tdt),
                                torch.from_numpy(kk), n_mppt)
        np.testing.assert_array_equal(ms.direction.numpy(),
                                      np.asarray(ms_ref.direction))
        np.testing.assert_array_equal(ms.p_prev.numpy(),
                                      np.asarray(ms_ref.p_prev))
        np.testing.assert_array_equal(vr.numpy(), np.asarray(vr_ref))
    assert (ms.direction < 0).any() and (ms.direction > 0).any()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_torch_voltvar_matches_interp(dtype):
    """The branchless piecewise-linear curve against jnp.interp on the knots
    (clamped): the knots themselves, both clamps and every segment."""
    npd = np.dtype(dtype)
    v = np.concatenate([np.linspace(0.8, 1.2, 401), np.asarray(ref_mv.VV_V),
                        np.nextafter(np.asarray(ref_mv.VV_V), 0.0),
                        np.nextafter(np.asarray(ref_mv.VV_V), 2.0)]).astype(npd)
    want = np.asarray(ref_mv.voltvar_qref(jnp.asarray(v), 0.44))
    got = mv.voltvar_qref(torch.from_numpy(v), 0.44).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=4 * np.finfo(npd).eps)
