"""The port's diagnostics (`pvderx_torch.diag`) against `pvderx.diag`, on the CPU.

Twins of `tests/test_sim_diag.py`'s profiler, checkpoint and debug tests,
plus the roofline's op count held against the reference's counter:

- `roofline.substep_op_count` equals `pvderx.diag.roofline.substep_op_count`
  per class and per primitive (1-φ 846 / 49 / 28, 3-φ 2278 / 57 / 36) and
  `ops.window.OPS_PER_SUBSTEP`; the bounds of the three kernels at the main
  path's shapes are the values `chip_smoke.py` has printed;
- `compile_report` counts 32767 flops for ``sum(x*x)`` at 128 x 128, as
  XLA's cost analysis does for the reference;
- a checkpoint of a PPO, DQN or SAC runner loads under
  ``weights_only=True`` and resumes bitwise into a runner built from
  another seed;
- `checked_step` and `debug_mode` give the reference's verdicts on the
  same states, carried over from JAX (float64).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import bitwise_differences
from pvderx_torch.diag import checkpoint, roofline
from pvderx_torch.diag.debug import (
    CheckError, PromotionError, checked_step, debug_mode)
from pvderx_torch.diag.profiler import (
    Stopwatch, compile_report, device_op_summary, force_sync, trace)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_ph", [1, 3])
def test_torch_roofline_op_count_is_the_references(n_ph):
    from pvderx.diag import roofline as jroof
    from pvderx_torch.ops.window import OPS_PER_SUBSTEP

    ref = jroof.substep_op_count(n_ph)
    ops = roofline.substep_op_count(n_ph)
    assert "unclassified" not in ops, ops.get("unclassified")
    differ = {k: (ops["by_op"].get(k), ref["by_prim"].get(k))
              for k in set(ops["by_op"]) | set(ref["by_prim"])
              if ops["by_op"].get(k) != ref["by_prim"].get(k)}
    assert not differ, f"ops counted otherwise (port, reference): {differ}"
    for k in ("alu", "div", "transcendental", "other", "total"):
        assert ops[k] == ref[k], (k, ops[k], ref[k])
    assert ops["total"] == OPS_PER_SUBSTEP[n_ph]


def test_torch_roofline_unknown_op_is_unclassified():
    with roofline.OpCounter() as c:
        torch.atan(torch.ones(5))
        torch.sin(torch.ones(3))
    cls = c.classes()
    assert cls["unclassified"] == {"atan": 5} and cls["other"] == 5
    assert cls["transcendental"] == 3 and cls["total"] == 8


def test_torch_roofline_lane_utilization_is_consistent():
    """The reference test's consistency checks, on the H100 ceilings."""
    util = roofline.lane_utilization(31.2e6, n_sub=64, n_ph=1)
    expect = 31.2e6 * 64 * util["ops_per_substep_per_der"]
    assert abs(util["kernel_ops_per_s"] - expect) < 1.0
    assert 0.0 < util["lane_util"] < 1.0
    assert util["lane_util_weighted"] > util["lane_util"]
    assert util["sfu_lane_issues_assumed"] == 8.0
    assert util["hbm_util"] < 0.05
    util_m = roofline.lane_utilization(2.0e6, n_sub=64, n_ph=1, m=16)
    assert abs(util_m["kernel_ops_per_s"]
               - 16 * 2.0e6 / 31.2e6 * util["kernel_ops_per_s"]) < 1e3
    assert util["lane_issue_peak_per_s"] == 132 * 128 * 1.98e9


def test_torch_roofline_window_bounds_at_the_main_paths_shapes():
    """The bounds chip_smoke.py printed before this module (K1 0.0289, K2
    0.0578, K3 0.4616 ms) and the ops package's byte and op counts."""
    from pvderx_torch.ops import dualfloat, window

    k1 = roofline.window_bound_ms("window", 32768)
    k2 = roofline.window_bound_ms("fleet_window", 4096, m=16)
    k3 = roofline.window_bound_ms("window_df", 32768)
    assert [round(b["bound_ms"], 4) for b in (k1, k2, k3)] == [
        0.0289, 0.0578, 0.4616]
    assert [round(b["issue_bound_ms"], 4) for b in (k1, k2, k3)] == [
        0.0579, 0.1157, 0.9244]
    assert all(b["bound_by"] == "operations" for b in (k1, k2, k3))
    assert (k1["ops"], k1["bytes"]) == (window.window_ops(32768, 1, 64),
                                        window.window_bytes(32768, 1))
    assert (k2["ops"], k2["bytes"]) == (
        window.fleet_window_ops(4096, 16, 1, 64),
        window.fleet_window_bytes(4096, 16, 1))
    assert (k3["ops"], k3["bytes"]) == (dualfloat.window_df_ops(32768, 1, 64),
                                        dualfloat.window_df_bytes(32768, 1))
    slow = roofline.window_bound_ms("window", 32768,
                                    chip=roofline.at_clock(990.0))
    assert slow["issue_bound_ms"] == pytest.approx(2 * k1["issue_bound_ms"])
    with pytest.raises(ValueError):
        roofline.window_bound_ms("conv", 1)


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------
def test_torch_profiler_compile_report_and_stopwatch():
    rep = compile_report(lambda x: torch.sum(x * x),
                         torch.ones((128, 128), dtype=torch.float32))
    assert rep["compile_s"] > 0 and rep["trace_s"] > 0
    assert rep["flops"] == 32767            # XLA's count for the reference
    assert rep["bytes_accessed"] > 0 and "peak_bytes" not in rep
    rep = compile_report(lambda x: torch.exp(x).mean(), torch.ones(10))
    assert (rep["flops"], rep["transcendentals"]) == (10, 10)
    sw = Stopwatch(lambda s: (s + 1.0,), torch.zeros(8))
    assert sw.rate(reps=3, items_per_call=8) > 0
    assert float(sw.state[0]) >= 2.0       # the state advanced (chained)


@pytest.mark.parametrize("cuda", [False, True])
def test_torch_stopwatch_reads_no_leaf_inside_its_timed_region(
        monkeypatch, cuda):
    """The timed region ends with a device sync where the state is on a
    card (the state's reduction there would read all of it); on the host
    with `force_sync`. Either way it starts after a `force_sync`."""
    from pvderx_torch.diag import profiler

    sw = Stopwatch(lambda s: (s + 1.0,), torch.zeros(8))
    sw.cuda = cuda
    log = []
    clock = profiler.time.perf_counter
    monkeypatch.setattr(profiler, "force_sync",
                        lambda tree: log.append("force_sync") or 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: log.append("device_sync"))
    monkeypatch.setattr(profiler.time, "perf_counter",
                        lambda: log.append("clock") or clock())
    monkeypatch.setattr(sw, "fn", lambda s: log.append("step") or (s + 1.0,))
    sw.elapsed(reps=2)
    end = "device_sync" if cuda else "force_sync"
    assert log == ["force_sync", "clock", "step", "step", end, "clock"]
    assert float(sw.state[0]) == 4.0


def test_torch_force_sync_sums_every_leaf():
    x = torch.arange(4, dtype=torch.float32) * 2.0
    assert force_sync(x) == pytest.approx(12.0)
    tree = {"a": torch.ones(3), "b": (torch.zeros(2), [torch.ones(2)])}
    assert force_sync(tree) == pytest.approx(5.0)

    @dataclasses.dataclass
    class Box:
        net: torch.nn.Module
        count: torch.Tensor
        n: int = 3

    net = torch.nn.Linear(2, 1)
    with torch.no_grad():
        net.weight.fill_(1.0)
        net.bias.fill_(0.5)
    assert force_sync(Box(net, torch.tensor([4], dtype=torch.int32))) == 6.5
    with pytest.raises(ValueError):
        force_sync({"n": 3})


def test_torch_device_op_summary(tmp_path):
    x = torch.ones((256, 256))
    f = lambda x: torch.sin(x).sum()
    f(x)
    with trace(str(tmp_path / "t")) as d:
        f(x)
    rows = device_op_summary(d, top=10)
    assert rows and all(len(r) == 3 for r in rows)
    assert all(ms >= 0 and n >= 1 for _, ms, n in rows)
    assert "aten::sin" in {name for name, _, _ in rows}   # the host track
    with pytest.raises(FileNotFoundError):
        device_op_summary(str(tmp_path / "missing"))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
def _learner(name):
    from pvderx_torch.env import make_env_config
    from pvderx_torch.learn import (
        DQNConfig, PPOConfig, SACConfig, make_dqn, make_ppo, make_sac)

    kw = dict(horizon=20, n_sub=40, device="cpu")
    if name == "ppo":
        return make_ppo(make_env_config("10", **kw),
                        PPOConfig(rollout_len=4, n_epochs=1, n_minibatch=2),
                        hidden=(32, 32))
    if name == "dqn":
        return make_dqn(make_env_config("10", **kw),
                        DQNConfig(rollout_len=4, n_updates=2, batch_size=16,
                                  capacity=256, target_every=2),
                        hidden=(32, 32))
    return make_sac(make_env_config("10", continuous=True, **kw),
                    SACConfig(rollout_len=4, n_updates=2, batch_size=16,
                              capacity=256), hidden=(32, 32))


@pytest.mark.parametrize("name", ["ppo", "dqn", "sac"])
def test_torch_checkpoint_resume_bitwise(tmp_path, name):
    init_runner, train_step, _ = _learner(name)
    runner = init_runner(8, torch.Generator().manual_seed(0))
    runner, _ = train_step(runner)
    path = checkpoint.save(str(tmp_path / "ckpt.pt"), runner)
    saved = torch.load(path, weights_only=True)      # plain containers only
    assert saved["scalars"][".update_i"] == 1

    fresh = init_runner(8, torch.Generator().manual_seed(1))
    plain = checkpoint.plain
    assert bitwise_differences(plain(fresh), plain(runner))   # built apart
    restored = checkpoint.restore(path, fresh)
    assert not bitwise_differences(plain(restored), plain(runner))
    for _ in range(2):
        runner, m1 = train_step(runner)
        restored, m2 = train_step(restored)
    assert not bitwise_differences(plain(restored), plain(runner))
    assert not bitwise_differences(
        *({k: torch.as_tensor(v) for k, v in m.items()} for m in (m1, m2)))


# ---------------------------------------------------------------------------
# checked_step and debug_mode, against the reference's verdicts
# ---------------------------------------------------------------------------
N_CHECK = 4


@pytest.fixture(scope="module")
def carried():
    """A float64 JAX reset batch and its carried-over port state."""
    from pvderx.env import core as jcore
    from pvderx_torch.convert import state_from_numpy
    from pvderx_torch.env import make_env_config

    cfg_j = jcore.make_env_config("10", dtype=jnp.float64, n_sub=40)
    keys = jax.random.split(jax.random.PRNGKey(3), N_CHECK)
    st_j, _ = jax.vmap(lambda k: jcore.reset(cfg_j, k))(keys)
    cfg = make_env_config("10", dtype=torch.float64, n_sub=40, device="cpu")
    st = state_from_numpy(dataclasses.asdict(jax.tree.map(np.asarray, st_j)),
                          cfg)
    return cfg_j, st_j, cfg, st


def _with_y(st_j, st, env, index, value):
    from pvderx._pytree import replace

    y = st.y.clone()
    y[env, index] = value
    return (replace(st_j, y=st_j.y.at[env, index].set(value)),
            dataclasses.replace(st, y=y))


def _verdict(throw):
    try:
        throw()
    except Exception as e:                     # noqa: BLE001 (either side's)
        return str(e)
    return None


def test_torch_checked_step_verdicts_are_the_references(carried):
    from pvderx.diag.debug import checked_step as jchecked

    cfg_j, st_j, cfg, st = carried
    step_j = jax.jit(jax.vmap(jchecked(cfg_j)))
    step = checked_step(cfg)
    a_j, a = jnp.zeros(N_CHECK, jnp.int32), torch.zeros(N_CHECK,
                                                        dtype=torch.int64)
    cases = {"clean": (st_j, st),
             "nan": _with_y(st_j, st, 2, 0, float("nan")),
             "vdc": _with_y(st_j, st, 1, 6, 5.0)}
    want = {"clean": None, "nan": "non-finite state after step: env 2",
            "vdc": "Vdc left the physical band: env 1"}
    for case, (sj, s) in cases.items():
        ref = _verdict(step_j(sj, a_j)[0].throw)
        err, out = step(s, a)
        got = _verdict(err.throw)
        assert (ref is None) == (got is None), (case, ref, got)
        if got is not None:
            assert ref.startswith(got.split(":")[0]), (case, ref, got)
            assert got.startswith(want[case]), (case, got)
            with pytest.raises(CheckError):
                err.throw()
        assert out[0].y.shape == s.y.shape


def test_torch_debug_mode_verdicts_are_the_references(carried):
    """A clean step passes and a NaN state raises, in both packages. The
    reference runs with strict_dtypes=False: its strict promotion rejects
    its own step's int x float ``k * h`` (x64); the port's strict check
    covers floating operands only. Each reference verdict takes a fresh
    jit: a call that hits jit's cache is not checked for NaNs."""
    from pvderx.diag.debug import debug_mode as jdebug
    from pvderx.env import core as jcore
    from pvderx_torch.env import core

    cfg_j, st_j, cfg, st = carried
    one = lambda tree, i: jax.tree.map(lambda x: x[i], tree)
    a = torch.zeros(N_CHECK, dtype=torch.int64)
    bad_j, bad = _with_y(st_j, st, 2, 0, float("nan"))

    def ref(s):
        with jdebug(strict_dtypes=False):
            jax.block_until_ready(
                jax.jit(lambda s: jcore.step(cfg_j, s, jnp.int32(0)))(s))

    def port(s):
        with debug_mode():
            core.step(cfg, s, a)

    assert _verdict(lambda: ref(one(st_j, 2))) is None
    assert _verdict(lambda: port(st)) is None
    with pytest.raises(FloatingPointError):
        ref(one(bad_j, 2))
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        port(bad)


def test_torch_debug_mode_restores_on_exit():
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    assert _get_current_dispatch_mode() is None
    with debug_mode() as mode:
        assert _get_current_dispatch_mode() is mode and mode.traps_nans
    assert _get_current_dispatch_mode() is None
    with pytest.raises(FloatingPointError):
        with debug_mode():
            torch.zeros(2) / torch.zeros(2)
    assert _get_current_dispatch_mode() is None
    with debug_mode(nans=False):
        torch.zeros(2) / torch.zeros(2)          # no trap
        with pytest.raises(PromotionError, match="mixes floating dtypes"):
            torch.ones(2) + torch.ones(2, dtype=torch.float64)
        torch.ones(2) * 2.0 + torch.ones(2) > 1   # scalars and bools mix
        torch.full((2,), float("inf")) * 1.0     # inf is not trapped


# ---------------------------------------------------------------------------
# the kernels' launchers: the grad guard and debug_mode's output check
# ---------------------------------------------------------------------------
def test_torch_grad_guard_raises_where_a_kernel_would_drop_the_gradient():
    from chip_smoke import window_inputs
    from pvderx_torch.ops._build import check_outputs, guard_launch
    from pvderx_torch.ops.window import P_FIELDS, rk4_window_batch

    n_ph, y, t0, pp, uu = window_inputs("10", 3, 0, "cpu")
    pp.requires_grad_(True)
    for what in ("window", "fleet window", "df32 window"):
        with pytest.raises(RuntimeError, match="no backward.*rk4_window"):
            guard_launch(what, y, t0, pp, uu)
    with torch.no_grad():
        guard_launch("window", y, t0, pp, uu)
    guard_launch("window", y, t0, pp.detach(), uu)
    # the CPU route is the plain window: differentiable, as lax.scan is
    out = rk4_window_batch(y, t0, pp, uu, n_ph=n_ph, n_sub=2,
                           dt=2 / (60 * 64))          # the main path's h
    assert out.grad_fn is not None
    out[:, 6].sum().backward()
    g = pp.grad[P_FIELDS.index("kp_dc")]
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    nan = torch.full((2,), float("nan"))
    check_outputs("window", nan)                  # trap off: no check
    with debug_mode():
        with pytest.raises(FloatingPointError, match="CUDA window kernel"):
            check_outputs("window", nan)
