"""The env step's autoreset (`env.core.restart_done`) on the CPU.

- A step with autoreset, single-DER and df32, writes no leaf of its input
  state, and the reward, done and ``info`` it returns are as the step gave
  them to the autoreset: the contract the card's kernel (`ops.autoreset`,
  which writes fresh outputs) keeps, since ``info["vdc"]`` is a view of
  the stepped y and ``info["tripped"]`` the stepped trip latch.
- The route: CPU tensors take the plain version (`_soft_reset`, then
  `autoreset`'s select), launching nothing; tensors elsewhere go to the
  kernel's wrapper with the config's scenario, ``w_base`` and ``n_ph``.
- The kernel's event arithmetic, mirrored in numpy in its order of
  rounding with the constants of `ops.autoreset.scenario_constants` taken
  by the names of csrc/autoreset.cu's `Const`, equals `_sample_events`
  bit for bit (float32 and float64, one and three phases).
- While a profiler records, each ``env.autoreset`` span carries the envs
  restarted (``count``) out of the batch (``total``); with none recording,
  nothing is recorded.
- The benchmark's reader `autoreset_restart_pct` sums them over the kept
  steps, and reads None without the recorder or its counter.
"""
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvderx_torch._struct import replace, tree_map
from pvderx_torch.diag import profiler
from pvderx_torch.env import core, make_batch_fns, make_batch_fns_df, rollout
from pvderx_torch.env.vector import _step_df_impl
from pvderx_torch.ops import autoreset as ops_autoreset
from pvderx_torch.ops._build import CSRC


def _leaves(tree):
    """Every tensor of nested dataclasses, dicts and tuples, in order."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    if isinstance(tree, dict):
        return [x for t in tree.values() for x in _leaves(t)]
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiler.clear()
    yield
    profiler.clear()


def _near_horizon(path, n=8, horizon=3):
    """(cfg, carry, step function) after a reset with half the envs one
    step from the horizon, so that the next step restarts them."""
    cfg = core.make_env_config("10", dtype=torch.float32, n_sub=40,
                               horizon=horizon, device="cpu")
    gen = torch.Generator().manual_seed(5)
    if path == "df":
        (st, y_lo), _ = make_batch_fns_df(cfg)[0](n, gen)
        y_lo = y_lo + 1e-9
    else:
        st, _ = make_batch_fns(cfg)[0](n, gen)
    t = torch.where(torch.arange(n) % 2 == 0, horizon - 1, 0).to(torch.int32)
    st = replace(st, t_step=t)
    return cfg, (st, y_lo) if path == "df" else st, gen


@pytest.mark.parametrize("path", ["single", "df"])
def test_torch_step_autoreset_leaves_inputs_and_info_untouched(path,
                                                                monkeypatch):
    cfg, carry, gen = _near_horizon(path)
    act = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    stepped = {}
    post_window = core._post_window

    def spy(*args, **kw):
        out = post_window(*args, **kw)
        stepped.update(state=[x.clone() for x in _leaves(out[0])],
                       rest=[x.clone() for x in _leaves(out[1:])])
        return out

    monkeypatch.setattr(core, "_post_window", spy)
    before = [x.clone() for x in _leaves(carry)]
    if path == "df":
        (st2, lo2), obs, rew, done, info = _step_df_impl(cfg, carry, act, gen)
        assert torch.equal(lo2[done], torch.zeros_like(lo2[done]))
        assert lo2[~done].abs().min() > 0
    else:
        st2, obs, rew, done, info = core.step_autoreset(cfg, carry, act, gen)
    assert int(done.sum()) == 4 and bool(done[::2].all())
    assert torch.equal(st2.t_step[done], torch.zeros(4, dtype=torch.int32))
    for a, b in zip(before, _leaves(carry), strict=True):
        assert _equal(a, b)
    # reward, done and info as the step gave them to the autoreset (whose
    # info["vdc"] is a view of the stepped y, info["tripped"] its latch)
    rest = stepped["rest"]
    assert _equal(rest[1], rew) and _equal(rest[2], done)
    for a, b in zip(rest[3:], _leaves(info), strict=True):
        assert _equal(a, b)
    assert not torch.equal(info["vdc"][done], st2.y[done, 6])


def test_torch_restart_done_takes_the_plain_path_on_the_cpu(monkeypatch):
    cfg, st, gen = _near_horizon("single")
    st1, obs, _, done, _ = core.step(cfg, st, torch.zeros(8, dtype=torch.int64))
    uv = core.event_draws(cfg, 8, gen)

    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(core, "autoreset_batch", refuse)
    launches = ops_autoreset.autoreset_batch.launches
    got = core.restart_done(cfg, done, (st1, obs), uv)
    want = core.autoreset(done, core._soft_reset(cfg, st1, uv), (st1, obs))
    assert got[2] is None
    for a, b in zip(_leaves(got[:2]), _leaves(want), strict=True):
        assert _equal(a, b)
    assert ops_autoreset.autoreset_batch.launches == launches
    with pytest.raises(ValueError, match="unsupported device cpu"):
        ops_autoreset.autoreset_batch(
            done, uv, st1, obs, scen=cfg.scen, w_base=cfg.der.w_base,
            n_ph=1)


def test_torch_restart_done_sends_other_devices_to_the_kernel(monkeypatch):
    cfg, st, gen = _near_horizon("single")
    st1, obs, _, done, _ = core.step(cfg, st, torch.zeros(8, dtype=torch.int64))
    uv = core.event_draws(cfg, 8, gen)
    meta = lambda t: tree_map(lambda x: x.to("meta"), t)
    seen = {}

    def fake(*args, **kw):
        seen.update(kw, args=args)
        return "kernel"

    monkeypatch.setattr(core, "autoreset_batch", fake)
    y_lo = torch.zeros(8, 11, device="meta")
    assert core.restart_done(cfg, meta(done), (meta(st1), meta(obs)),
                             meta(uv), y_lo) == "kernel"
    assert seen["scen"] is cfg.scen and seen["w_base"] is cfg.der.w_base
    assert seen["n_ph"] == 1 and seen["y_lo"] is y_lo
    assert seen["count"] is None
    assert [a.device.type for a in _leaves(seen["args"])] == ["meta"] * len(
        _leaves(seen["args"]))


def _const_names():
    """The names of csrc/autoreset.cu's `Const`, in order."""
    src = (CSRC / "autoreset.cu").read_text()
    body = re.search(r"enum Const \{([^}]*)\}", src).group(1)
    names = [w.strip() for w in body.split(",") if w.strip()]
    assert names[-1] == "kNumConst"
    return names[:-1]


def _kernel_events(sc, w_base, n_ph, s0, tc0, uv, dt):
    """csrc/autoreset.cu's `restart` event tables in numpy, one rounding
    per operation in the kernel's order."""
    names = _const_names()
    consts = ops_autoreset.scenario_constants(sc)
    assert len(consts) == len(names)
    c = {k: dt(v) for k, v in zip(names, consts)}
    inf, zero, one = dt(np.inf), np.zeros_like(s0), np.ones_like(s0)

    def u(i, lo, span):
        return uv[:, i] * c[span] + c[lo]

    t_c = np.where(uv[:, 0] < c["cPCloud"], u(1, "cTLo", "cTSpan"), inf)
    s_c = s0 * u(2, "cCloudLo", "cCloudSpan")
    dur_c = u(3, "cDurCLo", "cDurCSpan")
    solar = np.stack([np.stack(r, -1) for r in (
        [zero, s0, tc0], [t_c, s_c, tc0], [t_c + dur_c, s0, tc0],
        [zero + inf, s0, tc0])], -2)
    r = uv[:, 4]
    is_sag = r < c["cPSag"]
    is_freq = (r >= c["cPSag"]) & (r < c["cPSagFreq"])
    t_g = u(5, "cTLo", "cTSpan")
    depth = u(6, "cDepthLo", "cDepthSpan")
    dur_g = u(7, "cDurGLo", "cDurGSpan")
    dw = u(8, "cDwLo", "cDwSpan")
    t_evt = np.where(is_sag | is_freq, t_g, inf)
    v_evt = np.where(is_sag, depth, one)
    dw_evt = np.where(is_freq, dw, zero)
    x = dt(w_base) * dw_evt * dur_g
    b = c["cTwoPi"]
    mod = np.fmod(x, b)
    phi_rec = np.where((mod != 0) & ((b < 0) != (mod < 0)), mod + b, mod)
    is_unb = np.where(uv[:, 12] < c["cPUnb"], one, zero)
    v2 = (np.where(is_sag, one, zero) * is_unb * dt(n_ph == 3)
          * c["cUnbFrac"] * (one - depth))
    phi2 = u(13, "cPhi2Lo", "cPhi2Span")
    grid = np.stack([np.stack(r, -1) for r in (
        [zero, one, zero, zero, zero, zero],
        [t_evt, v_evt, zero, dw_evt, v2, phi2],
        [t_evt + dur_g, one, phi_rec, zero, zero, zero],
        [zero + inf, one, zero, zero, zero, zero])], -2)
    t_l = np.where(uv[:, 9] < c["cPLoad"], u(10, "cTLo", "cTSpan"), inf)
    load = np.stack([np.stack(r, -1) for r in (
        [zero, zero, zero], [t_l, u(11, "cGLo", "cGSpan"), zero])], -2)
    return solar, grid, load


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_autoreset_kernel_arithmetic_equals_sample_events(dtype,
                                                                preset):
    scen = core.ScenarioConfig(p_unb=0.5, p_freq=0.3, p_load=0.6)
    cfg = core.make_env_config(preset, dtype=dtype, scen=scen, device="cpu")
    gen = torch.Generator().manual_seed(11)
    n = 4096
    s0 = 600.0 + 400.0 * torch.rand(n, generator=gen, dtype=dtype)
    tc0 = 293.15 + 25.0 * torch.rand(n, generator=gen, dtype=dtype)
    uv = torch.rand(n, core.N_EVENT_DRAWS, generator=gen, dtype=dtype)
    uv[:64, 4] = float(np.asarray(scen.p_sag, dtype=str(dtype)[6:]))
    want = core._sample_events(cfg, s0, tc0, uv)
    dt = np.float32 if dtype == torch.float32 else np.float64
    got = _kernel_events(scen, float(cfg.der.w_base), cfg.der.n_ph,
                         s0.numpy(), tc0.numpy(), uv.numpy(), dt)
    itype = np.int32 if dt is np.float32 else np.int64
    for name, g in zip(("solar", "grid", "load"), got):
        w = getattr(want, name).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(itype), w.view(itype)), name
    assert (want.grid[:, 1, 4] > 0).any() == (preset == "50")
    assert (want.grid[:, 2, 2] != 0).any()


@pytest.mark.parametrize("n_ph, lo, per_env", [
    (1, False, 1 + 2 * 79 * 4), (3, False, 1 + 2 * 91 * 4),
    (1, True, 1 + 2 * 90 * 4)])
def test_torch_autoreset_bytes(n_ph, lo, per_env):
    assert ops_autoreset.autoreset_bytes(1000, n_ph, lo=lo) == 1000 * per_env
    assert ops_autoreset.autoreset_bytes(
        10, n_ph, torch.float64, lo=lo) == 10 * (1 + (per_env - 1) * 2)


def _policy(obs, generator):
    return torch.randint(0, 5, (obs.shape[0],), generator=generator)


@pytest.mark.parametrize("path", ["single", "df"])
def test_torch_profiled_autoreset_counts_the_restarts(path):
    cfg, carry, gen = _near_horizon(path)
    roll = (core.step_autoreset if path == "single" else _step_df_impl)
    dones = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            out = roll(cfg, carry, torch.zeros(8, dtype=torch.int64), gen)
            carry = out[0]
            dones.append(int(out[3].sum()))
    recs = profiler.records()
    ar = [r for r in recs if r["name"] == "env.autoreset"]
    assert [r["count"] for r in ar] == dones and dones[0] == 4
    assert [r["total"] for r in ar] == [8, 8, 8]
    assert all(r["count"] is None and r["total"] is None
               for r in recs if r["name"] != "env.autoreset")


def test_torch_unprofiled_autoreset_records_nothing():
    cfg, st, gen = _near_horizon("single")
    assert profiler.counter("env.autoreset", 8, "cpu") is None
    core.step_autoreset(cfg, st, torch.zeros(8, dtype=torch.int64), gen)
    assert profiler.records() == []
    # under a profiler, a counter belongs to the innermost open span only
    # where that span has the name asked for
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("env.step"):
            assert profiler.counter("env.autoreset", 8, "cpu") is None
            with profiler.span("env.autoreset"):
                slot = profiler.counter("env.autoreset", 8, "cpu")
                slot += 3
    recs = profiler.records()
    assert [(r["name"], r["count"], r["total"]) for r in recs] == [
        ("env.step", None, None), ("env.autoreset", 3, 8)]


def _fake_rollout(recs, counts, total=100):
    """One ``rollout`` span whose steps' ``env.autoreset`` spans carry
    ``counts`` (None: no counter)."""
    r0 = len(recs)
    recs.append(dict(name="rollout", parent=None, host_ms=1.0,
                     device_ms=1.0, drained=None))
    for c in counts:
        s = len(recs)
        recs.append(dict(name="env.step", parent=r0, host_ms=1.0,
                         device_ms=1.0, drained=False))
        rec = dict(name="env.autoreset", parent=s, host_ms=0.1,
                   device_ms=0.1, drained=None)
        if c is not None:
            rec.update(count=c, total=total)
        recs.append(rec)
    return recs


def test_torch_autoreset_restart_pct_reader(monkeypatch):
    from portbench import harness

    read = harness.load_reader("autoreset_restart_pct")
    # the first rollout (the profiler's come-up) is left out
    recs = _fake_rollout([], [90, 90])
    _fake_rollout(recs, [1, 0, 5])
    monkeypatch.setattr(profiler, "records", lambda: recs)
    assert read(None) == pytest.approx(100.0 * 6 / 300)
    # the parent's records: spans without a counter
    monkeypatch.setattr(profiler, "records",
                        lambda: _fake_rollout(_fake_rollout([], [None]),
                                              [None, None]))
    assert read(None) is None
    monkeypatch.setattr(profiler, "records", lambda: [])
    assert read(None) is None
    monkeypatch.delattr(profiler, "records")
    assert read(None) is None


def test_torch_autoreset_restart_pct_from_a_profiled_rollout():
    from portbench import harness

    cfg = core.make_env_config("10", dtype=torch.float32, n_sub=40,
                               horizon=2, device="cpu")
    gen = torch.Generator().manual_seed(2)
    st, obs = make_batch_fns(cfg)[0](6, gen)
    with profile(activities=[ProfilerActivity.CPU]):
        st, obs, _, _ = rollout(cfg, st, obs, _policy, 2, gen)
        st, obs, _, dones = rollout(cfg, st, obs, _policy, 4, gen)
    want = 100.0 * float(dones.sum()) / dones.numel()
    assert want > 0
    assert harness.load_reader("autoreset_restart_pct")(None) == want
