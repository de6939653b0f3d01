"""The benchmark's three-phase Volt-VAR deployment (`der50_3ph_voltvar`,
cell `der50_voltvar_rollout`) on the CPU at a small size.

- Its reference (`portbench.reference.env_voltvar`): the droop curve at
  the IEEE 1547-2018 Category B knots and beyond them; the spec it accepts
  and refuses.
- The cell's driver (`portbench.drivers.rollout_voltvar`) over the port's
  CPU path at 64 envs, preset 50, n_sub 80: after the warm-up chunk, two
  60-step chunks followed by the reference from the program's state, each
  check within the cell's limits; the same chunks with the reference in
  bfloat16 in the program's place read `correct` false; the reference with
  Volt-VAR off does not follow the program.
- The pre-window's Volt-VAR counter (`diag.profiler.counter` on the
  ``env.pre_window`` span) over a profiled rollout: it equals a plain count
  of the env steps whose |V_pos| at the window's start lies off the
  curve's deadband, and `voltvar_active_pct` reads it.
- The two readers the cell adds, on synthetic traces and records.
"""
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvderx_torch.diag import profiler
from pvderx_torch.env import core, make_batch_fns, rollout
from pvderx_torch.scenario.mppt_voltvar import VV_V, voltvar_qref

from portbench import harness
from portbench.drivers import common
from portbench.reference import env as renv
from portbench.reference import env_voltvar as ref
from portbench.reference.roofline import window_bound
from portbench.reference.xp import NumpyXP

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELL = "der50_voltvar_rollout"
CONFIG = json.loads((ROOT / "portbench/configs/der50_3ph_voltvar.json")
                    .read_text())
LIMITS = json.loads((ROOT / f"portbench/limits/{CELL}.json").read_text())[
    "limits"]
# events inside the two checked chunks (1-3 s, after the warm-up chunk),
# and early enough to fall inside a short rollout
CHUNK_EVENTS = dict(sag_t_lo=1.0, sag_t_hi=2.5, sag_dur_lo=0.2,
                    sag_dur_hi=0.8, p_sag=0.8, p_freq=0.1)
EARLY_EVENTS = dict(CHUNK_EVENTS, sag_t_lo=0.0, sag_t_hi=0.1)


def _cell(n_envs=64, seconds=0.0):
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.Cell(bench, CELL, 2147486101, seconds, False,
                        device="cpu", root=ROOT)
    cell.traffic.update(n_envs=n_envs, check_envs=n_envs)
    cell.config = dict(cell.config, scenario=dict(cell.config["scenario"],
                                                  **CHUNK_EVENTS))
    return cell


# ---------------------------------------------------------------------------
# the reference's curve and spec
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v, q", [
    (0.5, 0.44), (0.92, 0.44), (0.95, 0.22), (0.98, 0.0), (1.0, 0.0),
    (1.02, 0.0), (1.05, -0.22), (1.08, -0.44), (1.3, -0.44)])
def test_der50_voltvar_curve_at_the_category_b_knots(v, q):
    fx = NumpyXP(np.float64)
    got = ref.voltvar_q(fx, np.array([v]))
    assert got[0] == pytest.approx(q, abs=1e-12)
    assert ref.VV_V == (0.92, 0.98, 1.02, 1.08) and ref.Q_MAX == 0.44


def test_der50_voltvar_curve_is_the_programs():
    v = torch.linspace(0.8, 1.2, 4001, dtype=torch.float64)
    want = voltvar_qref(v, 0.44).numpy()
    got = ref.voltvar_q(NumpyXP(np.float64), v.numpy())
    assert np.max(np.abs(got - want)) < 1e-14
    assert ref.VV_V == VV_V


@pytest.mark.parametrize("flag", ["mppt_enable", "anomaly_detect",
                                  "continuous"])
def test_der50_voltvar_spec_refuses_what_the_reference_lacks(flag):
    with pytest.raises(NotImplementedError, match=flag):
        ref.make_spec(dict(CONFIG, env=dict(CONFIG["env"], **{flag: True})))


def test_der50_voltvar_spec_takes_volt_var_and_the_frozen_one_does_not():
    spec = ref.make_spec(CONFIG)
    assert spec.env["voltvar_enable"] is True and spec.der.n_ph == 3
    with pytest.raises(NotImplementedError, match="voltvar_enable"):
        renv.make_spec(CONFIG)
    with pytest.raises(NotImplementedError, match="jitter"):
        ref.make_spec(dict(CONFIG, scenario=dict(CONFIG["scenario"],
                                                 zg_jitter=0.1)))
    with pytest.raises(ValueError, match="reach"):
        ref.make_spec(dict(CONFIG, env=dict(CONFIG["env"], q_hi=0.4)))


def test_der50_voltvar_config_is_the_programs_preset_50():
    import dataclasses

    from portbench.reference.params import make_params
    from pvderx_torch.params import make_params as program_params

    mine, theirs = make_params(CONFIG["der"]), program_params("50")
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    cfg = common.program_config(CONFIG, "cpu")
    assert (cfg.voltvar_enable, cfg.mppt_enable, cfg.continuous,
            cfg.anomaly_detect) == (True, False, False, False)
    assert (cfg.n_sub, cfg.scen.p_unb, cfg.der.n_ph) == (80, 0.5, 3)


# ---------------------------------------------------------------------------
# the driver over the port's CPU path: two 60-step chunks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def driven():
    """The cell's driver after its set-up and two recorded 60-step chunks
    (each window of 0 s runs one), 64 envs; its readings, the control's,
    and the reference with Volt-VAR off over the same chunks."""
    import importlib

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cell = _cell()
    drv = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}").Driver(cell)
    drv.setup()
    drv.window(0.0)
    drv.window(0.0)
    program, control = drv.readings(False), drv.readings(True)
    off_cell = _cell()
    off_cell.config = dict(cell.config, env=dict(cell.config["env"],
                                                 voltvar_enable=False))
    drv.cell = off_cell
    off = drv.readings(False)
    drv.cell = cell
    torch.set_num_threads(n)
    return drv, program, control, off


def test_der50_voltvar_driver_follows_two_chunks(driven):
    drv = driven[0]
    assert len(drv.records) == 2 and drv.chunk == 60
    assert drv.cfg.voltvar_enable and drv.cfg.der.n_ph == 3
    # Volt-VAR moved the setpoint in the chunks, and sags were unbalanced
    q = torch.stack([drv.records[1][0][0]["q_ref"], drv.end[0]["q_ref"]])
    assert bool((q != 0).any())
    assert bool((drv.state.sched.grid[:, :, 4] > 0).any())


@pytest.mark.parametrize("name", list(LIMITS))
def test_der50_voltvar_program_reading_within_its_limit(driven, name):
    _, program, _, _ = driven
    assert set(program) == set(LIMITS)
    assert math.isfinite(program[name]) and program[name] <= LIMITS[name]


def test_der50_voltvar_bfloat16_control_reads_not_correct(driven):
    drv, _, control, _ = driven
    checks = common.checks(drv.cell.limits, control)
    assert not all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def test_der50_voltvar_reference_without_volt_var_does_not_follow(driven):
    _, program, _, off = driven
    assert off["chunk_obs"] > 10 * LIMITS["chunk_obs"]
    assert off["reset_state"] == program["reset_state"]


def test_der50_voltvar_driver_checks_read_correct(driven):
    drv, program, _, _ = driven
    checks = common.checks(drv.cell.limits, program)
    assert [k for k, _, _ in checks] == list(LIMITS)
    assert all(v <= lim for _, v, lim in checks)


# ---------------------------------------------------------------------------
# the counter and its reader
# ---------------------------------------------------------------------------
def _policy(obs, gen):
    return torch.randint(0, 5, (obs.shape[0],), generator=gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_der50_voltvar_counter_counts_the_off_deadband_steps(dtype,
                                                             monkeypatch):
    cfg = common.program_config(dict(
        CONFIG, dtype=str(dtype)[6:], scenario=dict(CONFIG["scenario"],
                                                    **EARLY_EVENTS)), "cpu")
    gen = torch.Generator().manual_seed(7)
    st, obs = make_batch_fns(cfg)[0](16, gen)
    off = []
    real = core._pre_window

    def seen(cfg, st, action, p_pack=None):
        t = st.t_step.to(st.y.dtype) * cfg.dt_ctrl
        exog = core.make_exog(st.sched, t, st.vdc_ref, st.q_ref,
                              1.0 - st.rt.tripped, st.rt.ces)
        g = core._algebra(st.y, t, st.der, exog)
        v = torch.hypot(g.v_pos.re, g.v_pos.im)
        off.append(int(((v < VV_V[1]) | (v > VV_V[2])).sum()))
        return real(cfg, st, action, p_pack)

    monkeypatch.setattr(core, "_pre_window", seen)
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        st, obs, _, _ = rollout(cfg, st, obs, _policy, 2, gen)
        st, obs, _, _ = rollout(cfg, st, obs, _policy, 10, gen)
    recs = profiler.records()
    counts = [(r["count"], r["total"]) for r in recs
              if r["name"] == "env.pre_window"]
    assert counts == [(c, 16) for c in off]
    kept = off[2:]                     # the reader leaves the first rollout out
    assert sum(kept) > 0
    got = harness.load_reader("voltvar_active_pct")(None)
    profiler.clear()
    assert got == pytest.approx(100.0 * sum(kept) / (16 * len(kept)))
    assert 0.0 < got <= 100.0


def test_der50_voltvar_counter_is_off_without_volt_var():
    cfg = core.make_env_config("50", n_sub=80, device="cpu")
    gen = torch.Generator().manual_seed(3)
    st, obs = make_batch_fns(cfg)[0](4, gen)
    profiler.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        rollout(cfg, st, obs, _policy, 1, gen)
        rollout(cfg, st, obs, _policy, 1, gen)
    pre = [r for r in profiler.records() if r["name"] == "env.pre_window"]
    profiler.clear()
    assert len(pre) == 2 and all(r["count"] is None for r in pre)


def _records(counts, total=16):
    """Two ``rollout`` spans of one ``env.step`` each, whose
    ``env.pre_window`` has the counter ``counts[i]`` (None: no counter)."""
    recs = []
    for c in counts:
        r0 = len(recs)
        recs.append(dict(name="rollout", parent=None))
        recs.append(dict(name="env.step", parent=r0, drained=False))
        rec = dict(name="env.pre_window", parent=r0 + 1, count=None,
                   total=None)
        if c is not None:
            rec.update(count=c, total=total)
        recs.append(rec)
    return recs


@pytest.mark.parametrize("counts, want", [
    ([16, 4], 25.0), ([0, 0], 0.0), ([None, None], None), ([], None)])
def test_der50_voltvar_active_pct_reader(counts, want, monkeypatch):
    monkeypatch.setattr(profiler, "records", lambda: _records(counts))
    read = harness.load_reader("voltvar_active_pct")
    assert read(None) == (None if want is None else pytest.approx(want))
    monkeypatch.delattr(profiler, "records")
    assert read(None) is None


@pytest.mark.parametrize("kernels, launches", [
    ({"void (anonymous namespace)::window_kernel<3>(float const*)":
      [0.024, 2]}, 2),
    ({"void (anonymous namespace)::window_kernel<1>(float const*)":
      [0.006, 2],
      "void (anonymous namespace)::pre_window_kernel<float, 3, true>()":
      [0.001, 2]}, 0)])
def test_der50_voltvar_k1_3ph_roofline_reader(kernels, launches):
    cell = _cell(n_envs=2097152)
    run = harness.Run(cell, {"kernels": kernels}, {}, 120)
    got = harness.load_reader("k1_3ph_roofline_pct")(run)
    if not launches:
        assert got is None
        return
    plain = dict(CONFIG, env=dict(CONFIG["env"], voltvar_enable=False))
    bound = window_bound(plain, 2097152)
    assert bound["bound_by"] == "operations"
    assert got == pytest.approx(100.0 * bound["bound_ms"] / 12.0)
    assert harness.load_reader("k1_3ph_roofline_pct")(
        harness.Run(cell, None, {}, 0)) is None


@pytest.mark.parametrize("dtype, voltvar", [(torch.int32, True),
                                            (torch.int64, False)])
def test_der50_voltvar_counter_slot_refused_before_the_library(
        dtype, voltvar, monkeypatch):
    from pvderx_torch.ops import _build
    from pvderx_torch.ops import pre_window as ops_pre_window
    from pvderx_torch.ops.window import P_FIELDS

    def refuse(*a, **kw):
        raise AssertionError("the library was called")

    monkeypatch.setattr(_build, "launch", refuse)
    n, m = 4, lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device="meta")
    ins = {k: m(n) for k in ops_pre_window.IN_LEAVES}
    ins.update(t_step=m(n, dtype=torch.int32),
               action=m(n, dtype=torch.int64), solar=m(n, 4, 3),
               grid=m(n, 4, 6), load=m(n, 2, 3), p_prev=None,
               direction=None, y=m(n, 23) if voltvar else None,
               p=m(len(P_FIELDS), n) if voltvar else None)
    cfg = common.program_config(CONFIG, "cpu")
    with pytest.raises(ValueError, match="count"):
        ops_pre_window.pre_window_batch(
            ins, ops_pre_window.pre_window_constants(cfg),
            m(1, dtype=dtype), n_ph=3, n_mppt=cfg.n_mppt, voltvar=voltvar)
