"""The port's RK4 window (pvderx_torch/ops/window.py) against the reference
Pallas kernel, and the CUDA kernel against its plain version on a card.

- `rk4_window_batch_ref` in float64 equals the JAX `rk4_window_batch` run in
  interpret mode in float64 (the way tests/test_ops.py runs it on the CPU),
  with per-env heterogeneous params/exog, to 1e-12.
- On the CPU, `rk4_window_batch` is the plain version and launches nothing.
- On a card (marked `gpu`, skipped here), the CUDA kernel matches the plain
  version in float32 to 5e-6 per window: nvcc contracts a*b+c into FMAs and
  the card's sin/cos/exp/pow round differently from the CPU's, so the two
  are not bitwise equal; 5e-6 is the reference's kernel-vs-scan tolerance
  (tests/test_ops.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx.ops import window as ref_window
from pvderx_torch.ops import window
from pvderx_torch.ops.window import (
    P_FIELDS, U_FIELDS, rk4_window_batch, rk4_window_batch_ref)
from pvderx_torch.params import make_params, nominal_exog

DT = 1.0 / 60.0


def _inputs(preset, n, seed, unbalanced=False):
    """Seeded numpy [N, n_s] state, [N] t0, [29, N] and [15, N] packs."""
    from pvderx_torch import oracle
    rng = np.random.default_rng(seed)
    p, u = make_params(preset), nominal_exog()
    y0 = oracle.steady_state(p, u)
    y = y0[None, :] + 1e-3 * rng.standard_normal((n, p.n_states))
    t0 = rng.uniform(0.0, 1.0, n)
    pp = np.array([np.full(n, getattr(p, f)) for f in P_FIELDS])
    uu = np.array([np.full(n, getattr(u, f)) for f in U_FIELDS])
    pp[P_FIELDS.index("rg")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    uu[U_FIELDS.index("s_irr")] *= 1.0 + 0.2 * rng.uniform(-1.0, 1.0, n)
    uu[U_FIELDS.index("dw_g")] = rng.uniform(-0.01, 0.01, n)
    if unbalanced:
        uu[U_FIELDS.index("v_g2")] = 0.1
        uu[U_FIELDS.index("phi_g2")] = rng.uniform(0.0, 2.0 * np.pi, n)
    return p.n_ph, y, t0, pp, uu


@pytest.mark.parametrize("preset,unbalanced", [("10", False), ("50", True)])
def test_torch_window_ref_matches_pallas_interpret(preset, unbalanced):
    n, n_sub = 128, 40
    n_ph, y, t0, pp, uu = _inputs(preset, n, int(preset), unbalanced)
    want = ref_window.rk4_window_batch(
        jnp.asarray(y), jnp.asarray(t0), jnp.asarray(pp), jnp.asarray(uu),
        n_ph=n_ph, n_sub=n_sub, dt=DT, block=n, interpret=True)
    got = rk4_window_batch_ref(*(torch.from_numpy(a) for a in (y, t0, pp, uu)),
                               n_ph=n_ph, n_sub=n_sub, dt=DT)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


def test_torch_window_cpu_dispatches_to_plain():
    n_ph, *arrs = _inputs("10", 7, 1)        # ragged N
    for dtype in (torch.float64, torch.float32):
        args = [torch.tensor(a, dtype=dtype) for a in arrs]
        before = rk4_window_batch.launches
        out = rk4_window_batch(*args, n_ph=n_ph, n_sub=40, dt=DT)
        ref = rk4_window_batch_ref(*args, n_ph=n_ph, n_sub=40, dt=DT)
        assert torch.equal(out, ref) and out.dtype == dtype
        assert rk4_window_batch.launches == before


def test_torch_window_rejects_bad_arguments():
    n_ph, y, t0, pp, uu = (_inputs("10", 4, 2)[0],
                           *(torch.from_numpy(a) for a in _inputs("10", 4, 2)[1:]))
    kw = dict(n_ph=n_ph, n_sub=40, dt=DT)
    with pytest.raises(ValueError):
        rk4_window_batch(y[:, :5], t0, pp, uu, **kw)          # state width
    with pytest.raises(ValueError):
        rk4_window_batch(y, t0[:3], pp, uu, **kw)             # t0 length
    with pytest.raises(ValueError):
        rk4_window_batch(y, t0, pp[:28], uu, **kw)            # params pack
    with pytest.raises(ValueError):
        rk4_window_batch(y, t0.float(), pp, uu, **kw)         # mixed dtypes
    with pytest.raises(ValueError):
        rk4_window_batch(y, t0, pp, uu, n_ph=2, n_sub=40, dt=DT)


def test_torch_window_fields_and_bytes_match_reference():
    """The pack layouts (29 params, 15 exog, reference order) and the bytes a
    window must move (268 per env at 1-φ, the reference's roofline count)."""
    from pvderx.diag.roofline import window_hbm_bytes
    assert P_FIELDS == ref_window.P_FIELDS and len(P_FIELDS) == 29
    assert U_FIELDS == ref_window.U_FIELDS and len(U_FIELDS) == 15
    for n_ph in (1, 3):
        assert window.window_bytes(1, n_ph) == window_hbm_bytes(n_ph)
    assert window.window_bytes(1, 1) == 268
    assert window.window_ops(32768, 1, 64) == 923 * 64 * 32768
    p = make_params("50")
    pt = p.to(torch.float64, "cpu")
    packed = window.pack_struct(
        type(pt)(n_ph=3, **{f: getattr(pt, f).expand(3) for f in P_FIELDS}),
        P_FIELDS)
    back = window.unpack_struct(type(pt), packed, P_FIELDS, n_ph=3)
    for f in P_FIELDS:
        assert torch.all(getattr(back, f) == getattr(p, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("preset,unbalanced", [("10", False), ("50", True)])
def test_torch_window_cuda_kernel_matches_plain(preset, unbalanced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the window kernel has no CPU mode")
    n_ph, *arrs = _inputs(preset, 1000, 3, unbalanced)   # ragged N
    args = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in arrs]
    before = rk4_window_batch.launches
    out = rk4_window_batch(*args, n_ph=n_ph, n_sub=64, dt=DT)
    ref = rk4_window_batch_ref(*args, n_ph=n_ph, n_sub=64, dt=DT)
    torch.cuda.synchronize()
    assert rk4_window_batch.launches == before + 1
    err = float((out - ref).abs().max())
    assert np.isfinite(err) and err <= 5e-6, err
