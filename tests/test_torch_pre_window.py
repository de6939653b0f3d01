"""The env step's pre-window glue (`env.core._pre_window`) on the CPU.

- The route: CPU tensors take the plain version (`_pre_window_plain`),
  launching nothing, and that version is the pre-window as it stood
  before the kernel: on hand-made inputs (no draw, no transcendental) it
  gives the saved outputs below bit for bit, and on reset states pushed
  across every branch it equals a saved copy of that code
  (`_saved_pre_window`) leaf for leaf, for every switch of the config.
  Tensors elsewhere go to the kernel's wrapper
  (`ops.pre_window.pre_window_batch`) with the state's own leaves, and the
  exog is read from the rows of the pack the wrapper returns, which the
  single-DER, df32 and implicit steps hand on to the window and the
  post-window without packing it again.
- The wrapper refuses a leaf on another device, of another dtype or shape,
  or not contiguous, before the library is called; the entry's pointer
  arrays, constants and modes are in the order of the `.cu`'s enums.
- `pre_window_bytes`: 260 B an env in float32.
- Phase 39 of `chip_smoke.py` runs here at tiny sizes and reads a planted
  one-ulp fault in any leaf as a failure.
- A kernel-against-plain check on the card (`gpu`, skipped here).
"""
import contextlib
import dataclasses
import math
import re
from types import SimpleNamespace

import pytest
import torch

import chip_smoke as cs
from pvderx_torch._struct import replace, tree_map
from pvderx_torch.env import core, make_batch_fns, make_batch_fns_df
from pvderx_torch.env import vector
from pvderx_torch.ops import _build
from pvderx_torch.ops import pre_window as ops_pre_window
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct
from pvderx_torch.params import Exog
from pvderx_torch.scenario.events import EventSchedule, make_exog
from pvderx_torch.scenario.mppt_voltvar import (
    MPPT_DEADBAND, VV_V, mppt_update, voltvar_qref)

F32, F64 = torch.float32, torch.float64
MODES = dict(cs.PRE_WINDOW_MODES)


def _saved_pre_window(cfg, st, action):
    """`env.core._pre_window` as it stood before the kernel (its span
    aside), saved as it was: (t, exog, mppt, flag)."""
    dtype = st.y.dtype
    t = st.t_step.to(dtype) * cfg.dt_ctrl

    # 1. agent action -> setpoint nudges (ignored for auto-controlled
    # fields)
    q_ref = st.q_ref
    vdc_ref = st.vdc_ref
    flag = torch.zeros_like(q_ref)
    if cfg.continuous:
        # continuous extension: action [N, 2] in [-1,1] scales the deltas
        a = torch.clamp(action.to(dtype), -1.0, 1.0)
        dq, dv = cfg.dq_action * a[:, 0], cfg.dv_action * a[:, 1]
    else:
        a = action
        dq = cfg.dq_action * ((a == 1).to(dtype) - (a == 2).to(dtype))
        dv = cfg.dv_action * ((a == 3).to(dtype) - (a == 4).to(dtype))
        if cfg.anomaly_detect:
            flag = (a == 5).to(dtype)   # "flag anomaly"
    if not cfg.voltvar_enable:
        q_ref = torch.clamp(q_ref + dq, cfg.q_lo, cfg.q_hi)
    if not cfg.mppt_enable:
        vdc_ref = torch.clamp(vdc_ref + dv, cfg.v_lo, cfg.v_hi)

    # 2. supervisory layer at window start (SPEC §8; ZOH over the window)
    conn = 1.0 - st.rt.tripped
    exog = make_exog(st.sched, t, vdc_ref, q_ref, conn, st.rt.ces)
    mppt = st.mppt
    if cfg.voltvar_enable or cfg.mppt_enable:
        g0 = core._algebra(st.y, t, st.der, exog)
        if cfg.voltvar_enable:
            q_ref = voltvar_qref(torch.hypot(g0.v_pos.re, g0.v_pos.im),
                                 cfg.q_vv)
        if cfg.mppt_enable:
            mppt, vdc_ref = mppt_update(mppt, vdc_ref, g0.p_pv, st.t_step,
                                        cfg.n_mppt)
        exog = replace(exog, vdc_ref=vdc_ref, q_ref=q_ref)
    return t, exog, mppt, flag


def _cfg(preset, dtype, mode, **kw):
    return core.make_env_config(preset, dtype=dtype, device="cpu",
                                **MODES[mode], **kw)


def _action(cfg, act, act_c):
    return (act_c if cfg.continuous else act if cfg.anomaly_detect
            else act % core.N_ACTIONS)


@pytest.fixture(scope="module")
def cases():
    """`chip_smoke._pre_window_case` of 16 envs per (preset, dtype)."""
    return {(p, d): cs._pre_window_case(p, d, 16, "cpu", i)
            for i, (p, d) in enumerate((p, d) for p in ("10", "50")
                                       for d in (F32, F64))}


# ---------------------------------------------------------------------------
# the CPU route is the plain version, unchanged
# ---------------------------------------------------------------------------
def _fixed_state(cfg):
    """Four envs by hand, no draw and no transcendental on the way: a
    cloud and a sag from exactly the step's time, an event row already
    passed, a load step, a -0 in an active row and a NaN in a padding row;
    setpoints at and past their bounds, a trip, a cessation."""
    st, _ = core.reset(cfg, 4, torch.Generator().manual_seed(0))
    f = lambda *v: torch.tensor(v, dtype=cfg.dtype)
    t_step = torch.tensor([0, 60, 90, 599], dtype=torch.int32)
    t = t_step.to(cfg.dtype) * cfg.dt_ctrl
    inf = math.inf
    solar = f([0, 800, 300], [inf, 800, 300], [inf, 800, 300],
              [inf, 800, 300]).expand(4, 4, 3).clone()
    solar[1, 1:3] = torch.stack([torch.stack([t[1], f(400)[0], f(300)[0]]),
                                 f(t[1] + 2.0, 800, 300)])
    solar[2, 3, 1] = math.nan
    grid = f([0, 1, 0, 0, 0, 0], *[[inf, 1, 0, 0, 0, 0]] * 3).expand(
        4, 4, 6).clone()
    grid[2, 1:3] = f([1.25, 0.5, 0, 0, 0, 0], [2.0, 1.0, 0.25, 0, 0, 0])
    grid[3, 1] = torch.cat([t[3:], f(0.7, 0, 0.02, 0, 0)])
    load = f([0, 0, 0], [inf, 0.2, 0]).expand(4, 2, 3).clone()
    load[0, 0, 1] = -0.0
    load[3, 1, 0] = 5.0
    rt = replace(st.rt, tripped=f(0, 0, 1, 0), ces=f(0, 1, 0, 0))
    return replace(st, t_step=t_step, q_ref=f(0.495, -0.495, 0.0, 0.3),
                   vdc_ref=f(1.197, 0.703, 1.0, 0.9), rt=rt,
                   sched=EventSchedule(solar=solar, grid=grid, load=load))


FIXED_ACTIONS = {
    "discrete": [1, 2, 3, 4], "anomaly": [5, 2, 0, 4],
    "continuous": [[1.5, -0.25], [-2.0, 0.5], [0.0, -1.5], [0.75, 1.0]]}
# The plain pre-window's outputs on `_fixed_state` in float32, saved
# before the kernel existed: the leaves every mode shares, then each
# mode's setpoints and flag
FIXED_SHARED = {
    "t": [0.0, 1.0, 1.5000001192092896, 9.983333587646484],
    "s_irr": [800.0, 400.0, 800.0, 800.0],
    "t_cell": [300.0] * 4,
    "v_g": [1.0, 1.0, 0.5, 0.699999988079071],
    "phi_g": [0.0] * 4,
    "dw_g": [0.0, 0.0, 0.0, 0.019999999552965164],
    "t_g": [0.0, 0.0, 1.25, 9.983333587646484],
    "v_g2": [0.0] * 4, "phi_g2": [0.0] * 4,
    "g_load": [0.0, 0.0, 0.0, 0.20000000298023224],
    "b_load": [0.0] * 4,
    "conn": [1.0, 1.0, 0.0, 1.0], "ces": [0.0, 1.0, 0.0, 0.0],
    "p_ref": [0.0] * 4}
FIXED_MODE = {
    "discrete": dict(
        vdc_ref=[1.1970000267028809, 0.703000009059906, 1.0049999952316284,
                 0.8949999809265137],
        q_ref=[0.5, -0.5, 0.0, 0.30000001192092896], flag=[0.0] * 4),
    "anomaly": dict(
        vdc_ref=[1.1970000267028809, 0.703000009059906, 1.0,
                 0.8949999809265137],
        q_ref=[0.4950000047683716, -0.5, 0.0, 0.30000001192092896],
        flag=[1.0, 0.0, 0.0, 0.0]),
    "continuous": dict(
        vdc_ref=[1.1957499980926514, 0.7055000066757202, 0.9950000047683716,
                 0.9049999713897705],
        q_ref=[0.5, -0.5, 0.0, 0.3075000047683716], flag=[0.0] * 4),
}


def _same_bits(a, b) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.numpy().tobytes() == b.numpy().tobytes())


@pytest.mark.parametrize("mode", list(FIXED_MODE))
def test_torch_pre_window_cpu_gives_the_saved_outputs(mode, monkeypatch):
    monkeypatch.setattr(core, "pre_window_batch", None)   # never reached
    cfg = _cfg("10", F32, mode)
    st = _fixed_state(cfg)
    act = torch.tensor(FIXED_ACTIONS[mode],
                       dtype=F32 if cfg.continuous else torch.int64)
    t, exog, mppt, flag, u_pack = core._pre_window(cfg, st, act)
    assert u_pack is None and mppt is st.mppt
    want = {**FIXED_SHARED, **FIXED_MODE[mode]}
    got = {"t": t, "flag": flag,
           **{f.name: getattr(exog, f.name) for f in dataclasses.fields(exog)}}
    assert set(got) == set(want)
    for k, v in want.items():
        assert _same_bits(got[k], torch.tensor(v, dtype=F32)), (k, got[k])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_pre_window_cpu_route_is_the_saved_code(preset, dtype, mode,
                                                      cases, monkeypatch):
    monkeypatch.setattr(core, "pre_window_batch", None)   # never reached
    st, act, act_c, pk = cases[preset, dtype]
    cfg = _cfg(preset, dtype, mode)
    a = _action(cfg, act, act_c)
    launches = ops_pre_window.pre_window_batch.launches
    got = core._pre_window(cfg, st, a, pk)
    assert got[4] is None
    assert not cs.bitwise_differences(got[:4], _saved_pre_window(cfg, st, a))
    assert not cs.bitwise_differences(core._pre_window_plain(cfg, st, a),
                                      got[:4])
    assert ops_pre_window.pre_window_batch.launches == launches


# ---------------------------------------------------------------------------
# other devices: the kernel's wrapper, and the pack handed on
# ---------------------------------------------------------------------------
def _meta(x):
    return tree_map(lambda a: a.to("meta"), x)


@pytest.mark.parametrize("mode", list(MODES))
def test_torch_pre_window_sends_other_devices_to_the_kernel(mode, cases,
                                                            monkeypatch):
    st, act, act_c, pk = (_meta(x) for x in cases["50", F32])
    cfg = _cfg("50", F32, mode)
    a = _action(cfg, act, act_c)
    n = st.y.shape[0]
    seen = []
    out = {"u": torch.empty(len(U_FIELDS), n, device="meta"),
           "t": torch.empty(n, device="meta")}
    if cfg.anomaly_detect:
        out["flag"] = torch.empty(n, device="meta")
    if cfg.mppt_enable:
        out["p_prev"] = torch.empty(n, device="meta")
        out["direction"] = torch.empty(n, device="meta")

    def fake(ins, consts, **kw):
        seen.append((ins, consts, kw))
        return out

    monkeypatch.setattr(core, "pre_window_batch", fake)
    sup = cfg.voltvar_enable or cfg.mppt_enable
    for p_pack in (pk, None):
        t, exog, mppt, flag, u_pack = core._pre_window(cfg, st, a, p_pack)
        ins, consts, kw = seen.pop()
        assert list(ins) == list(ops_pre_window.IN_LEAVES)
        mine = dict(t_step=st.t_step, q_ref=st.q_ref, vdc_ref=st.vdc_ref,
                    tripped=st.rt.tripped, ces=st.rt.ces, action=a,
                    solar=st.sched.solar, grid=st.sched.grid,
                    load=st.sched.load, y=st.y if sup else None,
                    p_prev=st.mppt.p_prev if cfg.mppt_enable else None,
                    direction=(st.mppt.direction if cfg.mppt_enable
                               else None))
        assert all(ins[k] is v for k, v in mine.items()), mode
        if not sup:
            assert ins["p"] is None
        elif p_pack is not None:
            assert ins["p"] is p_pack
        else:                                   # packed where it is None
            assert ins["p"].shape == (len(P_FIELDS), n)
        assert consts == ops_pre_window.pre_window_constants(cfg)
        assert kw == dict(count=None, n_ph=3, n_mppt=cfg.n_mppt,
                          continuous=cfg.continuous,
                          anomaly=cfg.anomaly_detect,
                          voltvar=cfg.voltvar_enable, mppt=cfg.mppt_enable)
        assert t is out["t"] and u_pack is out["u"]
        assert flag is out.get("flag")
        for i, f in enumerate(U_FIELDS):        # the exog: the pack's rows
            row = getattr(exog, f)
            assert row.shape == (n,) and row.stride() == (1,)
            assert row.storage_offset() == i * n
            assert row.untyped_storage().data_ptr() == (
                u_pack.untyped_storage().data_ptr())
        if cfg.mppt_enable:
            assert mppt.p_prev is out["p_prev"]
            assert mppt.direction is out["direction"]
        else:
            assert mppt is st.mppt


@pytest.mark.parametrize("path", ["single", "df", "implicit"])
def test_torch_step_hands_the_pre_window_pack_on(path, monkeypatch):
    """The exog pack that `_pre_window` returns (the kernel's on the card,
    stood in for here) reaches the window and the post-window as it is:
    nothing packs the exog again."""
    kw = (dict(integrator="trapezoid", n_sub=4) if path == "implicit"
          else dict(n_sub=40))
    cfg = core.make_env_config("10", dtype=F32, device="cpu", **kw)
    gen = torch.Generator().manual_seed(5)
    if path == "df":
        carry, _ = make_batch_fns_df(cfg)[0](8, gen)
        st = carry[0]
    else:
        st, _ = make_batch_fns(cfg)[0](8, gen)
    act = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    pre_window, post_window = core._pre_window, core._post_window
    packs, seen = [], {}

    def pre(cfg, st, action, p_pack=None):
        t, exog, mppt, flag, _ = pre_window(cfg, st, action, p_pack)
        packs.append(pack_struct(exog, U_FIELDS))
        return t, exog, mppt, flag, packs[-1]

    def post(*args):
        seen["post"] = args[8]
        return post_window(*args)

    def stack(tensors):
        raise AssertionError("the exog was packed again")

    def window(name, real):
        def spy(*args, **kw):
            seen["window"] = args[4 if name == "df" else 3]
            return real(*args, **kw)
        return spy

    monkeypatch.setattr(core, "_pre_window", pre)
    monkeypatch.setattr(core, "_post_window", post)
    monkeypatch.setattr(core, "rk4_window_batch",
                        window("single", core.rk4_window_batch))
    monkeypatch.setattr(vector, "rk4_window_batch_df",
                        window("df", vector.rk4_window_batch_df))
    pk = pack_struct(st.der, P_FIELDS)
    with monkeypatch.context() as m:
        m.setattr(core, "pack_struct", lambda tree, fields: (
            stack(()) if fields is U_FIELDS else pack_struct(tree, fields)))
        m.setattr(vector, "pack_struct", core.pack_struct)
        if path == "df":
            vector._step_df_impl(cfg, carry, act, gen, pk)
        else:
            core.step(cfg, st, act, pk)
    (u_pack,) = packs
    assert seen["post"] is u_pack
    assert seen.get("window", u_pack) is u_pack
    assert ("window" in seen) == (path != "implicit")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------
class _Cuda(torch.Tensor):
    """A CPU tensor that says it lives on the first card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _wrapper_ins(n=5, dtype=F32):
    """A discrete, MPPT pre-window's inputs on the CPU."""
    ins = {k: torch.zeros(n, dtype=dtype) for k in ops_pre_window.IN_LEAVES}
    ins.update(t_step=torch.zeros(n, dtype=torch.int32),
               action=torch.zeros(n, dtype=torch.int64),
               solar=torch.zeros(n, 4, 3, dtype=dtype),
               grid=torch.zeros(n, 4, 6, dtype=dtype),
               load=torch.zeros(n, 2, 3, dtype=dtype),
               y=torch.zeros(n, 11, dtype=dtype),
               p=torch.zeros(len(P_FIELDS), n, dtype=dtype))
    return ins


def _fault(name, ins):
    n = ins["q_ref"].shape[0]
    if name == "device":
        ins["q_ref"] = ins["q_ref"].to("meta")
    elif name == "dtype":
        ins["vdc_ref"] = ins["vdc_ref"].double()
    elif name == "action_dtype":
        ins["action"] = ins["action"].int()
    elif name == "shape":
        ins["grid"] = torch.zeros(n, 4, 5)
    elif name == "t_step_shape":
        ins["t_step"] = torch.zeros(n + 1, dtype=torch.int32)
    elif name == "not_contiguous":
        ins["solar"] = torch.zeros(n, 4, 6)[:, :, :3]
    return ins


@contextlib.contextmanager
def _fake_card(monkeypatch):
    """Tensors that say they are on the card, a library that records its
    calls, the device context and the current stream replaced."""
    calls = []
    empty = torch.empty

    class Lib:
        def pvderx_pre_window(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: SimpleNamespace(cuda_stream=77))
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **kw: empty(
        *a, **kw).as_subclass(_Cuda))
    yield calls


@pytest.mark.parametrize("fault", ["none", "device", "dtype", "action_dtype",
                                   "shape", "t_step_shape",
                                   "not_contiguous"])
def test_torch_pre_window_wrapper_refuses_bad_leaves(fault, monkeypatch):
    ins = _fault(fault, _wrapper_ins())
    ins = {k: v if v.device.type == "meta" else v.as_subclass(_Cuda)
           for k, v in ins.items()}
    cfg = core.make_env_config("10", mppt_enable=True, device="cpu")
    consts = ops_pre_window.pre_window_constants(cfg)
    launches = ops_pre_window.pre_window_batch.launches
    with _fake_card(monkeypatch) as calls:
        call = lambda: ops_pre_window.pre_window_batch(
            ins, consts, n_ph=1, n_mppt=cfg.n_mppt, mppt=True)
        if fault == "none":
            out = call()
        else:
            with pytest.raises(ValueError):
                call()
    if fault != "none":
        assert not calls and (ops_pre_window.pre_window_batch.launches
                              == launches)
        return
    (args,) = calls
    assert set(out) == {"u", "t", "p_prev", "direction"}
    assert out["u"].shape == (len(U_FIELDS), 5)
    assert list(args[0]) == [ins[k].data_ptr()
                             for k in ops_pre_window.IN_LEAVES]
    assert list(args[1]) == [None if k not in out else out[k].data_ptr()
                             for k in ops_pre_window.OUT_LEAVES]
    assert list(args[2]) == consts
    assert args[3:] == (None, 5, 1, 4, 4, 2, cfg.n_mppt, 8, 0, 77)


def test_torch_pre_window_wrapper_refuses_the_cpu():
    with pytest.raises(ValueError, match="unsupported device cpu"):
        ops_pre_window.pre_window_batch(
            {**_wrapper_ins(), "y": None, "p": None, "p_prev": None,
             "direction": None}, [0.0] * 16, n_ph=1, n_mppt=12)


def _enum(name):
    """The names of csrc/pre_window.cu's enum ``name``, in order."""
    src = (_build.CSRC / "pre_window.cu").read_text()
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
    return [w.split("=")[0].strip() for w in body.split(",") if w.strip()]


def _snake(name):
    """kTStep -> t_step, oPPrev -> p_prev, cDqAction -> dq_action."""
    return re.sub(r"(?<!^)([A-Z])", r"_\1", name[1:]).lower()


def test_torch_pre_window_entry_order_is_the_sources():
    ins, outs = _enum("In"), _enum("Out")
    assert (ins[-1], outs[-1]) == ("kNumIn", "kNumOut")
    assert [_snake(k) for k in ins[:-1]] == list(ops_pre_window.IN_LEAVES)
    assert [_snake(k) for k in outs[:-1]] == list(ops_pre_window.OUT_LEAVES)
    assert [_snake(k) for k in _enum("Mode")] == list(ops_pre_window.MODES)
    assert re.search(r"kContinuous = 1, kAnomaly = 2, kVoltvar = 4, "
                     r"kMppt = 8", (_build.CSRC / "pre_window.cu")
                     .read_text())
    cfg = core.make_env_config("50", dtype=F64, device="cpu")
    names = [_snake(k) for k in _enum("Const")[:-1]]
    dv, lo, hi = mppt_update.__defaults__
    value = {"mppt_dv": dv, "mppt_lo": lo, "mppt_hi": hi,
             "mppt_floor": -MPPT_DEADBAND,
             **{f"vv{i}": v for i, v in enumerate(VV_V)}}
    assert ops_pre_window.pre_window_constants(cfg) == [
        value[k] if k in value else getattr(cfg, k) for k in names]
    assert (dv, lo, hi) == (0.005, 0.7, 1.2)


@pytest.mark.parametrize("dtype, per_env", [(F32, 260), (F64, 508)])
def test_torch_pre_window_bytes(dtype, per_env):
    # reads: the tables (4 x 3 + 4 x 6 + 2 x 3), q_ref, vdc_ref, the trip
    # latch, cessation; t_step (int32), the action (int64); writes: the
    # 15-row exog pack and t
    size = torch.finfo(dtype).bits // 8
    assert per_env == (42 + 4) * size + 4 + 8 + (15 + 1) * size
    assert ops_pre_window.pre_window_bytes(1000, dtype) == 1000 * per_env


# ---------------------------------------------------------------------------
# phase 39 of chip_smoke.py
# ---------------------------------------------------------------------------
TINY = dict(presets=("10",), dtypes=(F32,), sizes=(5,), timed_n=None)


def test_torch_chip_smoke_pre_window_phase_runs_on_the_cpu():
    out = cs.check_pre_window("cpu", presets=("10", "50"), dtypes=(F32, F64),
                              sizes=(5,), timed_n=None)
    assert out["cases"] == 4 * len(MODES)


def _one_ulp(x, env=2):
    y = x.clone()
    y[env] = torch.nextafter(y[env], torch.tensor(math.inf, dtype=y.dtype))
    return y


@pytest.mark.parametrize("leaf", ["t", "s_irr", "t_g", "q_ref", "p_ref",
                                  "p_prev", "direction", "flag"])
def test_torch_chip_smoke_pre_window_reads_a_one_ulp_fault(leaf,
                                                           monkeypatch):
    real = core._pre_window

    def faulty(cfg, st, action, p_pack=None):
        t, exog, mppt, flag, u_pack = real(cfg, st, action, p_pack)
        if leaf == "t":
            t = _one_ulp(t)
        elif leaf in ("p_prev", "direction"):
            mppt = replace(mppt, **{leaf: _one_ulp(getattr(mppt, leaf))})
        elif leaf == "flag":
            flag = _one_ulp(flag)
        else:
            exog = replace(exog, **{leaf: _one_ulp(getattr(exog, leaf))})
        return t, exog, mppt, flag, u_pack

    monkeypatch.setattr(core, "_pre_window", faulty)
    with pytest.raises(AssertionError, match="not bitwise equal"):
        cs.check_pre_window("cpu", **TINY)


@pytest.mark.gpu
def test_torch_pre_window_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pre-window kernel has no CPU "
                    "mode")
    out = cs.check_pre_window("cuda", sizes=(37, 1000), timed_n=None)
    assert out["cases"] == 8 * len(MODES)
