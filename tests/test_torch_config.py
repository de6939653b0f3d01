"""The port's config store, DER model types, logging, printing and
conversions against the JAX package (twins of tests/test_config_utils.py
and tests/test_variants.py:33-41).

- Every JSON file under `pvderx_torch/configs/` equals its original under
  `pvderx/configs/` (parsed content, and the same file set).
- `load_der`/`save_der`/`load_scenario`/`load_env_config` give what the
  reference's give: every DERParams field equal to the float, env configs
  field for field, scenarios row for row (the port's tables on the CPU).
- `make_der` and `creation_message` equal the reference's for every type
  string and preset; `show_states` prints the reference's text.
- The conversions equal the reference's on seeded inputs (numpy, <= 1e-12)
  and run on torch tensors through `TorchXP`.
"""
import dataclasses
import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvderx import config as jconfig
from pvderx import checks as jchecks
from pvderx import models as jmodels
from pvderx.params import make_params as jax_make_params
from pvderx.params import nominal_exog as jax_nominal_exog
from pvderx.utils import show_states as jax_show_states
from pvderx.utils import transforms as jtf
from pvderx_torch import (
    DER_MODEL_TYPES, creation_message, make_der, make_params, nominal_exog)
from pvderx_torch.config import (
    CONFIG_DIR, load_der, load_env_config, load_scenario, save_der)
from pvderx_torch.env import core
from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.xp import TorchXP
from pvderx_torch.scenario.events import make_exog
from pvderx_torch.utils import get_logger, set_verbosity, show_states
from pvderx_torch.utils import transforms as tf

P_NAMES = [f.name for f in dataclasses.fields(
    jax_make_params("10")) if f.name != "n_ph"]


def _json_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f.endswith(".json"))


def _same_der(p, pj):
    assert p.n_ph == pj.n_ph
    for f in P_NAMES:
        assert float(getattr(p, f)) == float(np.asarray(getattr(pj, f))), f


# ---------------------------------------------------------------------------
# the copied JSON files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rel", _json_files(jconfig.CONFIG_DIR))
def test_torch_config_json_copy_equals_reference(rel):
    assert _json_files(CONFIG_DIR) == _json_files(jconfig.CONFIG_DIR)
    with open(os.path.join(CONFIG_DIR, rel)) as a, \
            open(os.path.join(jconfig.CONFIG_DIR, rel)) as b:
        assert json.load(a) == json.load(b)


# ---------------------------------------------------------------------------
# twins of tests/test_config_utils.py
# ---------------------------------------------------------------------------
def test_torch_packaged_der_configs_cover_all_ratings():
    for name, s_rated, n_ph in [("der_10kW", 10e3, 1), ("der_50kW", 50e3, 3),
                                ("der_250kW", 250e3, 3)]:
        p = load_der(name)
        assert p.s_rated == s_rated and p.n_ph == n_ph
        _same_der(p, jconfig.load_der(name))
    assert load_der("der_50kW_constant_Vdc").const_vdc == 1.0


def test_torch_der_roundtrip(tmp_path):
    p = make_params("50", rg=0.025)
    path = save_der(p, str(tmp_path / "custom.json"))
    p2 = load_der(path)
    _same_der(p2, jconfig.load_der(path))     # the reference reads it too
    for f in ("rg", "xg", "s_rated", "gamma", "irs"):
        assert float(getattr(p, f)) == float(getattr(p2, f)), f
    assert p2.n_ph == 3
    # a reference-written file loads the same here
    jpath = jconfig.save_der(jax_make_params("50", rg=0.025),
                             str(tmp_path / "ref.json"))
    _same_der(load_der(jpath), jconfig.load_der(jpath))
    # overrides at load time win
    assert load_der(path, rf=0.5).rf == 0.5
    assert load_der("der_10kW", rf=0.5).rf == 0.5


def test_torch_load_missing_config_lists_available():
    with pytest.raises(FileNotFoundError) as ei:
        load_der("der_999kW")
    assert "der_10kW" in str(ei.value)


def test_torch_scenario_loads_and_drives_exog():
    ev, sched = load_scenario("sag_ride_through", dtype=torch.float64,
                              device="cpu")
    _, sched_j = jconfig.load_scenario("sag_ride_through", dtype=np.float64)
    for k in ("solar", "grid", "load"):
        np.testing.assert_array_equal(getattr(sched, k).numpy(),
                                      np.asarray(getattr(sched_j, k)))
    one = torch.ones((), dtype=torch.float64)
    zero = torch.zeros((), dtype=torch.float64)
    v_g = lambda t: float(make_exog(sched, torch.tensor(t, dtype=torch.float64),
                                    one, zero, one, zero).v_g)
    assert (v_g(9.9), v_g(10.2), v_g(11.0)) == (1.0, 0.5, 1.0)


def test_torch_env_config_json():
    cfg = load_env_config("env_config3_lvrt", dtype=torch.float32,
                          device="cpu")
    assert cfg.n_sub == 120 and cfg.dtype == torch.float32
    assert float(cfg.scen.p_sag) == pytest.approx(0.9)
    cfg4 = load_env_config("env_config4_mppt", device="cpu")
    assert cfg4.mppt_enable is True
    assert float(cfg4.scen.zg_jitter) == pytest.approx(0.3)
    cfg2 = load_env_config("env_config2_voltvar", device="cpu")
    assert cfg2.voltvar_enable is True and cfg2.der.n_ph == 3
    # every packaged env config equals the reference's, field for field
    for name in ("env_config2_voltvar", "env_config3_lvrt",
                 "env_config4_mppt"):
        c, cj = load_env_config(name, device="cpu"), jconfig.load_env_config(name)
        for f in dataclasses.fields(cj):
            if f.name in ("der", "rt", "scen"):
                continue
            assert getattr(c, f.name) == getattr(cj, f.name), (name, f.name)
        for f in dataclasses.fields(cj.scen):
            assert getattr(c.scen, f.name) == pytest.approx(
                float(getattr(cj.scen, f.name)), rel=1e-6), (name, f.name)
        _same_der(c.der, cj.der)       # float32 leaves on both sides


def test_torch_env_config_json_dtype_strings(tmp_path):
    """A "dtype" string in the file maps to the torch dtype, and a "der"
    block of either form is read as the reference reads it."""
    path = tmp_path / "env.json"
    path.write_text(json.dumps({
        "preset": "10", "n_sub": 48, "dtype": "float64",
        "der": {"preset": "50", "overrides": {"rg": 0.03}}}))
    cfg = load_env_config(str(path), device="cpu")
    cfg_j = jconfig.load_env_config(str(path))
    assert cfg.dtype == torch.float64 and cfg.n_sub == 48
    assert cfg.der.n_ph == 3 and float(cfg.der.rg) == 0.03
    assert float(cfg.der.rg) == float(cfg_j.der.rg)
    assert load_env_config(str(path), dtype=torch.float32,
                           device="cpu").dtype == torch.float32


def test_torch_show_states_formats_both_variants(capsys):
    for preset in ("10", "50"):
        p = make_params(preset)
        u = nominal_exog()
        y = rhs_core.steady_state_guess(p, u, np)
        s = show_states(torch.tensor(y), p, u)
        assert "Vdc" in s and "P_pcc" in s
        assert ("phase c" in s) == (preset == "50")
        pj = jax_make_params(preset)
        uj = jax_nominal_exog()
        assert s == jax_show_states(y, pj, uj)


def test_torch_logger_names_and_verbosity():
    lg = get_logger("env", "PV_DER-1")
    assert lg.name == "pvderx_torch.env.PV_DER-1"
    set_verbosity("DEBUG")
    assert logging.getLogger("pvderx_torch").level == logging.DEBUG
    set_verbosity("INFO")
    assert logging.getLogger("pvderx_torch").level == logging.INFO


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------
def test_torch_rms_phasor_roundtrip():
    x = tf.rms_to_phasor(0.7, 0.3)
    xj = jtf.rms_to_phasor(0.7, 0.3)
    assert (x.re, x.im) == (xj.re, xj.im)
    np.testing.assert_allclose(tf.phasor_to_rms(x), 0.7, rtol=1e-12)
    xt = tf.rms_to_phasor(torch.tensor(0.7, dtype=torch.float64),
                          torch.tensor(0.3, dtype=torch.float64),
                          TorchXP(torch.float64))
    assert float(tf.phasor_to_rms(xt, TorchXP(torch.float64))) == \
        pytest.approx(0.7, rel=1e-12)


def test_torch_park_roundtrip_and_balanced_set():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3))
    th = rng.standard_normal((5,))
    d, q, z = tf.abc_to_dq0(x, th)
    dj, qj, zj = jtf.abc_to_dq0(x, th)
    np.testing.assert_allclose(np.stack([d, q, z]), np.stack([dj, qj, zj]),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(tf.dq0_to_abc(d, q, z, th), x, atol=1e-12)
    xp = TorchXP(torch.float64)
    dt_, qt, zt = tf.abc_to_dq0(torch.from_numpy(x), torch.from_numpy(th), xp)
    np.testing.assert_allclose(tf.dq0_to_abc(dt_, qt, zt, torch.from_numpy(th),
                                             xp).numpy(), x, atol=1e-12)
    wt, A = 1.234, 0.9
    bal = np.stack([A * np.cos(wt), A * np.cos(wt - 2 * np.pi / 3),
                    A * np.cos(wt + 2 * np.pi / 3)])
    d, q, z = tf.abc_to_dq0(bal, wt)
    np.testing.assert_allclose(np.hypot(d, q), A, atol=1e-12)
    np.testing.assert_allclose(d, A, atol=1e-12)
    np.testing.assert_allclose(z, 0.0, atol=1e-12)


def test_torch_sequence_components_match_rhs_core():
    rng = np.random.default_rng(1)
    x = rhs_core.C(rng.standard_normal(3), rng.standard_normal(3))
    pos, neg, zero = tf.sequence_components(x)
    for a, b in zip((pos, neg, zero), jtf.sequence_components(x)):
        np.testing.assert_allclose([a.re, a.im], [b.re, b.im], atol=1e-12)
    neg_core = rhs_core.neg_seq(x, 3, np)
    np.testing.assert_allclose([neg.re, neg.im], [neg_core.re, neg_core.im],
                               atol=1e-12)
    x2 = tf.sequence_to_phase(pos, neg, zero)
    np.testing.assert_allclose(x2.re, x.re, atol=1e-12)
    np.testing.assert_allclose(x2.im, x.im, atol=1e-12)
    xt = rhs_core.C(torch.from_numpy(x.re), torch.from_numpy(x.im))
    xp = TorchXP(torch.float64)
    x3 = tf.sequence_to_phase(*tf.sequence_components(xt, xp), xp)
    np.testing.assert_allclose(x3.re.numpy(), x.re, atol=1e-12)


# ---------------------------------------------------------------------------
# model types (twin of tests/test_variants.py:33-41) and creation_message
# ---------------------------------------------------------------------------
def test_torch_wrapper_type_strings():
    assert DER_MODEL_TYPES == jmodels.DER_MODEL_TYPES
    for t in DER_MODEL_TYPES:
        p = make_der(t)
        assert p.n_states in (11, 23)
        _same_der(p, jmodels.make_der(t))
    assert make_der("SolarPVDERThreePhaseConstantVdc").const_vdc == 1.0
    assert make_der("SolarPVDERThreePhase").const_vdc == 0.0
    assert make_der("SolarPVDERThreePhaseConstantVdc",
                    preset="250").s_rated == 250e3
    with pytest.raises(KeyError):
        make_der("NoSuchModel")


@pytest.mark.parametrize("preset", ["10", "50", "250"])
def test_torch_creation_message_equals_reference(preset):
    for over in ({}, {"const_vdc": 1.0}):
        p = make_params(preset, **over)
        assert creation_message(p) == jchecks.creation_message(
            jax_make_params(preset, **over))
    # a batch of params gets the structural summary, as the reference's does
    cfg = core.make_env_config(preset, n_sub=40, device="cpu")
    st, _ = core.reset(cfg, 2, torch.Generator().manual_seed(0))
    msg = creation_message(st.der)
    assert "batched" in msg and f"{cfg.der.n_states} states" in msg
    assert msg == jchecks.creation_message(dataclasses.replace(
        jax_make_params(preset), rf=jnp.ones(2)))
