"""The port's fleet window (pvderx_torch/ops/window.py) against the reference
Pallas fleet kernel, and the CUDA fleet kernel against its plain version on
a card.

- `rk4_fleet_window_batch_ref` in float64 equals the JAX
  `rk4_fleet_window_batch` run in interpret mode in float64 (block=128, as
  the JAX package's tests run it on the CPU), with per-unit heterogeneous
  params and exog and feeder fields that differ between units (both read
  them from unit 0), to 1e-12 relative to max |y|. At M=1 it equals the
  single-DER plain window bitwise.
- On the CPU, `rk4_fleet_window_batch` is the plain version and launches
  nothing; it rejects wrong shapes, dtypes and devices.
- On a card (marked `gpu`, skipped here), the CUDA fleet kernel matches the
  plain version in float32 to 5e-6 per window, K1's tolerance: FMA
  contraction, the card's sin/cos/exp/pow and the butterfly order of the
  M-sum keep the two from bitwise equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.ops import window as ref_window
from pvderx_torch.ops import window
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, rk4_fleet_window_batch, rk4_fleet_window_batch_ref,
    rk4_window_batch_ref)
from pvderx_torch.params import make_params, nominal_exog

DT = 1.0 / 60.0


def _inputs(preset, n, m, seed, unbalanced=False):
    """Seeded numpy [N, M, n_s] state, [N] t0, [29, N, M] and [15, N, M]."""
    from pvderx_torch import oracle
    rng = np.random.default_rng(seed)
    p, u = make_params(preset), nominal_exog()
    y0 = oracle.steady_state(p, u)
    y = y0 + 1e-3 * rng.standard_normal((n, m, p.n_states))
    t0 = rng.uniform(0.0, 1.0, n)
    pp = np.array([np.full((n, m), getattr(p, f)) for f in P_FIELDS])
    uu = np.array([np.full((n, m), getattr(u, f)) for f in U_FIELDS])
    pp[P_FIELDS.index("rg")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, (n, m))
    uu[U_FIELDS.index("s_irr")] *= 1.0 - 0.3 * rng.uniform(size=(n, m))
    uu[U_FIELDS.index("dw_g")] = rng.uniform(-0.01, 0.01, (n, m))
    uu[U_FIELDS.index("q_ref")] = rng.uniform(-0.1, 0.1, (n, m))
    uu[U_FIELDS.index("conn")] = rng.uniform(size=(n, m)) < 0.8
    if unbalanced:
        uu[U_FIELDS.index("v_g2")] = 0.1
        uu[U_FIELDS.index("phi_g2")] = rng.uniform(0.0, 2.0 * np.pi, (n, m))
    return p.n_ph, y, t0, pp, uu


@pytest.mark.parametrize("preset,m,unbalanced",
                         [("10", 1, False), ("10", 3, False), ("50", 3, True)])
def test_torch_fleet_window_ref_matches_pallas_interpret(preset, m, unbalanced):
    n, n_sub = 128, 40
    n_ph, y, t0, pp, uu = _inputs(preset, n, m, 7, unbalanced)
    want = np.asarray(ref_window.rk4_fleet_window_batch(
        *(jnp.asarray(a) for a in (y, t0, pp, uu)), n_ph=n_ph, m=m,
        n_sub=n_sub, dt=DT, block=n, interpret=True))
    got = rk4_fleet_window_batch_ref(
        *(torch.from_numpy(a) for a in (y, t0, pp, uu)), n_ph=n_ph, m=m,
        n_sub=n_sub, dt=DT)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_torch_fleet_window_single_unit_is_the_single_der_window():
    n_ph, y, t0, pp, uu = _inputs("10", 9, 1, 3)
    args = [torch.from_numpy(a) for a in (y, t0, pp, uu)]
    got = rk4_fleet_window_batch_ref(*args, n_ph=n_ph, m=1, n_sub=40, dt=DT)
    single = rk4_window_batch_ref(args[0][:, 0], args[1], args[2][:, :, 0],
                                  args[3][:, :, 0], n_ph=n_ph, n_sub=40, dt=DT)
    assert torch.equal(got[:, 0], single)


def test_torch_fleet_window_cpu_dispatches_to_plain():
    n_ph, *arrs = _inputs("10", 5, 3, 1)        # ragged N
    for dtype in (torch.float64, torch.float32):
        args = [torch.tensor(a, dtype=dtype) for a in arrs]
        before = rk4_fleet_window_batch.launches
        out = rk4_fleet_window_batch(*args, n_ph=n_ph, m=3, n_sub=40, dt=DT)
        ref = rk4_fleet_window_batch_ref(*args, n_ph=n_ph, m=3, n_sub=40, dt=DT)
        assert torch.equal(out, ref) and out.dtype == dtype
        assert rk4_fleet_window_batch.launches == before


def test_torch_fleet_window_rejects_bad_arguments():
    n_ph, y, t0, pp, uu = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in _inputs("10", 4, 3, 2))
    kw = dict(n_ph=n_ph, m=3, n_sub=40, dt=DT)
    bad = [
        ((y[:, :, :5], t0, pp, uu), kw),                  # state width
        ((y[:, :2], t0, pp, uu), kw),                     # M of y vs m
        ((y[0], t0, pp, uu), kw),                         # no unit axis
        ((y, t0[:3], pp, uu), kw),                        # t0 length
        ((y, t0, pp[:28], uu), kw),                       # params pack
        ((y, t0, pp, uu[:, :, :2]), kw),                  # exog units
        ((y, t0.float(), pp, uu), kw),                    # mixed dtypes
        ((y, t0, pp, uu), dict(kw, n_ph=2)),              # phases
        ((y, t0.to("meta"), pp, uu), kw),                 # mixed devices
        (tuple(a.to("meta") for a in (y, t0, pp, uu)), kw),   # no kernel there
    ]
    for args, k in bad:
        with pytest.raises(ValueError):
            rk4_fleet_window_batch(*args, **k)


def test_torch_fleet_window_bytes_and_ops_match_reference():
    """The bytes a fleet window moves (the reference roofline's count) and
    its operations (M single-DER windows, the reference's convention)."""
    from pvderx.diag.roofline import window_hbm_bytes
    for n_ph in (1, 3):
        for m in (1, 4, 16):
            assert window.fleet_window_bytes(1, m, n_ph) == window_hbm_bytes(n_ph, m)
    assert window.fleet_window_bytes(4096, 16, 1) == 4228 * 4096
    assert window.fleet_window_ops(4096, 16, 1, 64) == 923 * 16 * 64 * 4096
    assert window.fleet_window_ops(8, 1, 3, 40) == window.window_ops(8, 3, 40)


@pytest.mark.gpu
@pytest.mark.parametrize("preset,n,m,unbalanced",
                         [("10", 1000, 16, False), ("50", 257, 3, True),
                          ("10", 64, 40, False), ("10", 300, 1, False)])
def test_torch_fleet_window_cuda_kernel_matches_plain(preset, n, m, unbalanced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fleet kernel has no CPU mode")
    n_ph, *arrs = _inputs(preset, n, m, 3, unbalanced)
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrs]
    before = rk4_fleet_window_batch.launches
    out = rk4_fleet_window_batch(*args, n_ph=n_ph, m=m, n_sub=64, dt=DT)
    ref = rk4_fleet_window_batch_ref(*args, n_ph=n_ph, m=m, n_sub=64, dt=DT)
    torch.cuda.synchronize()
    assert rk4_fleet_window_batch.launches == before + 1
    err = float((out - ref).abs().max())
    assert np.isfinite(err) and err <= 5e-6, err
