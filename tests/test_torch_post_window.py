"""The env step's post-window glue (`env.core._post_window`) on the CPU.

- The route: CPU tensors take the plain version (`_post_window_plain`),
  launching nothing; tensors elsewhere go to the kernel's wrapper
  (`ops.post_window.post_window_batch`) with the window's params and exog
  packs, which `step` and the df32 step pass on.
- A step, single-DER, df32 and implicit, writes no leaf of its input state
  and keeps the aliasing the kernel's wrapper keeps: the state's y is the
  window's y1, ``info["vdc"]`` a view of it, ``info["tripped"]`` the
  state's trip latch, the setpoints the exog's.
- The kernel's arithmetic, mirrored in numpy in its order of rounding
  (csrc/post_window.cu, one rounding per operation, its constants taken
  by the names of its `Const` enum), agrees with the plain version on
  inputs forced across every threshold of the step: the flags, the step
  count, the trip latch, the timers and the cessation flag exactly, the
  floats within a few ulp (torch's CPU kernels divide by a Python scalar
  where the card's multiply by its reciprocal, and their sin, cos and exp
  are not numpy's). The entry's pointer arrays are in the order of the
  `.cu`'s `In` and `Out` enums.
- `post_window_bytes` per env, and a kernel-against-plain check on the
  card (`gpu`, skipped here).
"""
import copy
import re

import numpy as np
import pytest
import torch

import chip_smoke as cs
from pvderx_torch._struct import tree_map
from pvderx_torch.env import core, make_batch_fns, make_batch_fns_df
from pvderx_torch.env.vector import _step_df_impl
from pvderx_torch.ops import post_window as ops_post_window
from pvderx_torch.ops._build import CSRC
from pvderx_torch.ops.window import P_FIELDS, U_FIELDS, pack_struct
from pvderx_torch.physics.rhs_core import TWO_PI_3


def _view_of(a, b):
    """Whether tensor ``a`` shares ``b``'s storage."""
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _case(preset="10", dtype=torch.float32, n=8, seed=3):
    return cs._post_window_case(preset, dtype, n, "cpu", seed)


def _cfg(preset, dtype, anomaly=False, rt=True):
    return core.make_env_config(preset, dtype=dtype, device="cpu",
                                anomaly_detect=anomaly, rt_enabled=rt)


def _kernel_args(cfg, st, exog, mppt, t, y1, flag, pk, uk):
    """`post_window_batch`'s arguments for one step's inputs."""
    anom = cfg.anomaly_detect
    return ((y1, t, st.t_step, pk, uk, st.rt.timers, st.rt.tripped,
             cfg.rt.t_lim, cfg.rt.enable, flag if anom else None,
             st.s0 if anom else None, ops_post_window.step_constants(cfg)),
            dict(n_ph=cfg.der.n_ph, horizon=cfg.horizon))


def test_torch_post_window_cpu_takes_the_plain_version(monkeypatch):
    st, args, pk, uk = _case()
    cfg = _cfg("10", torch.float32)

    def refuse(*a, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(core, "post_window_batch", refuse)
    launches = ops_post_window.post_window_batch.launches
    got = core._post_window(cfg, st, *args, pk, uk)
    want = core._post_window_plain(cfg, st, *args)
    assert not cs.bitwise_differences(got, want)
    assert ops_post_window.post_window_batch.launches == launches
    pos, kw = _kernel_args(cfg, st, *args, pk, uk)
    with pytest.raises(ValueError, match="unsupported device cpu"):
        ops_post_window.post_window_batch(*pos, **kw)


@pytest.mark.parametrize("anomaly", [False, True])
def test_torch_post_window_sends_other_devices_to_the_kernel(anomaly,
                                                            monkeypatch):
    st, (exog, mppt, t, y1, flag), pk, uk = _case()
    cfg = _cfg("10", torch.float32, anomaly=anomaly)
    meta = lambda x: tree_map(lambda a: a.to("meta"), x)
    want = core._post_window_plain(cfg, st, exog, mppt, t, y1, flag)
    leaves = {k.removeprefix("info."): meta(v)
              for k, v in cs._post_window_leaves(want).items()}
    seen = []

    def fake(*args, **kw):
        seen.append((args, kw))
        return leaves

    monkeypatch.setattr(core, "post_window_batch", fake)
    args = (meta(st), meta(exog), meta(mppt), meta(t), meta(y1), meta(flag))
    packs = meta(pk), meta(uk)
    st1, obs, reward, done, info = core._post_window(cfg, *args, *packs)
    (got, kw), = seen
    pos, want_kw = _kernel_args(cfg, *args, *packs)
    assert kw == want_kw and got[-1] == pos[-1]
    assert all(a is b for a, b in zip(got[:-1], pos[:-1], strict=True))
    assert (got[9] is None) == (got[10] is None) == (not anomaly)
    # the step is assembled from the kernel's leaves, with the aliases
    assert st1.y is args[4] and info["tripped"] is st1.rt.tripped
    assert _view_of(info["vdc"], args[4])
    assert st1.vdc_ref is args[1].vdc_ref and st1.mppt is args[2]
    assert obs is leaves["obs"] and reward is leaves["reward"]
    assert done is leaves["done"] and st1.t_step is leaves["t_step"]
    assert st1.rt.timers is leaves["timers"] and st1.rt.ces is leaves["ces"]
    assert all(info[k] is leaves[k] for k in info if k not in ("vdc",
                                                               "tripped"))
    core._post_window(cfg, *args)                   # packed here when None
    assert [tuple(a.shape) for a in seen[1][0][3:5]] == [
        (len(P_FIELDS), 8), (len(U_FIELDS), 8)]


@pytest.mark.parametrize("path", ["single", "df"])
def test_torch_step_passes_the_window_packs_on(path, monkeypatch):
    cfg = core.make_env_config("10", dtype=torch.float32, n_sub=40,
                               device="cpu")
    gen = torch.Generator().manual_seed(1)
    if path == "df":
        carry, _ = make_batch_fns_df(cfg)[0](8, gen)
        st = carry[0]
    else:
        carry = st = make_batch_fns(cfg)[0](8, gen)[0]
    pk = pack_struct(st.der, P_FIELDS)
    post_window = core._post_window
    seen = []

    def spy(cfg, st, exog, mppt, t, y1, flag, p_pack=None, u_pack=None):
        seen.append((p_pack, u_pack, pack_struct(exog, U_FIELDS)))
        return post_window(cfg, st, exog, mppt, t, y1, flag, p_pack, u_pack)

    monkeypatch.setattr(core, "_post_window", spy)
    act = torch.zeros(8, dtype=torch.int64)
    if path == "df":
        _step_df_impl(cfg, carry, act, gen, pk)
        _step_df_impl(cfg, carry, act, gen)
    else:
        core.step(cfg, st, act, pk)
        core.step(cfg, st, act)
    (p1, u1, exog1), (p2, u2, exog2) = seen
    assert p1 is pk and torch.equal(p2, pk)
    assert torch.equal(u1, exog1) and torch.equal(u2, exog2)


def test_torch_implicit_step_leaves_the_packs_to_the_post_window(monkeypatch):
    cfg = core.make_env_config("10", dtype=torch.float64, n_sub=4,
                               integrator="trapezoid", device="cpu")
    st, _ = make_batch_fns(cfg)[0](4, torch.Generator().manual_seed(2))
    seen = []
    post_window = core._post_window

    def spy(*args):
        seen.append(args[7:])
        return post_window(*args)

    monkeypatch.setattr(core, "_post_window", spy)
    core.step(cfg, st, torch.zeros(4, dtype=torch.int64))
    assert seen == [(None, None)]


@pytest.mark.parametrize("path", ["single", "df", "implicit"])
def test_torch_step_leaves_inputs_untouched_and_keeps_aliases(path):
    kw = (dict(integrator="trapezoid", n_sub=4) if path == "implicit"
          else dict(n_sub=40))
    cfg = core.make_env_config("10", dtype=torch.float32, device="cpu", **kw)
    gen = torch.Generator().manual_seed(4)
    act = torch.tensor([0, 1, 2, 3, 4, 0, 1, 2])
    if path == "df":
        carry, _ = make_batch_fns_df(cfg)[0](8, gen)
        before = copy.deepcopy(carry)
        (st1, _), obs, reward, done, info = _step_df_impl(cfg, carry, act,
                                                          gen)
        st = carry[0]
    else:
        st, _ = make_batch_fns(cfg)[0](8, gen)
        before = copy.deepcopy(st)
        _, exog, _, _ = core._pre_window(cfg, st, act)
        st1, obs, reward, done, info = core.step(cfg, st, act)
        assert torch.equal(st1.vdc_ref, exog.vdc_ref)
    assert not cs.bitwise_differences(before, carry if path == "df" else st)
    assert set(info) == {"vdc", "v_mag", "f_meas", "v_unb", "p_pcc", "q_pcc",
                         "p_pv", "tripped", "trip_now", "terminated",
                         "truncated"}
    if path != "df":                      # the df32 step's state is restarted
        assert _view_of(info["vdc"], st1.y)
        assert torch.equal(info["vdc"], st1.y[:, 6])
        assert info["tripped"] is st1.rt.tripped
    assert obs.shape == (8, core.OBS_DIM) and done.dtype == torch.bool


def test_torch_post_window_plain_aliases():
    st, args, _, _ = _case(n=6)
    exog, y1 = args[0], args[3]
    st1, _, _, _, info = core._post_window_plain(_cfg("10", torch.float32),
                                                 st, *args)
    assert st1.y is y1 and _view_of(info["vdc"], y1)
    assert torch.equal(info["vdc"], y1[:, 6])
    assert info["tripped"] is st1.rt.tripped
    assert st1.vdc_ref is exog.vdc_ref and st1.q_ref is exog.q_ref
    assert st1.mppt is args[1] and st1.der is st.der


def _enum(name):
    """The names of csrc/post_window.cu's enum ``name``, in order, without
    its count."""
    src = (CSRC / "post_window.cu").read_text()
    body = re.search(rf"enum {name} \{{([^}}]*)\}}", src).group(1)
    names = [w.strip() for w in body.split(",") if w.strip()]
    assert names[-1].startswith("kNum")
    return names[:-1]


def _snake(name):
    """kTStep -> t_step, oVMag -> v_mag, cRAnomTp -> r_anom_tp."""
    return re.sub(r"(?<!^)([A-Z])", r"_\1", name[1:]).lower()


def test_torch_post_window_entry_order_is_the_sources():
    assert [_snake(k) for k in _enum("In")] == list(ops_post_window.IN_LEAVES)
    assert [_snake(k) for k in _enum("Out")] == list(
        ops_post_window.OUT_LEAVES)
    cfg = _cfg("50", torch.float64, anomaly=True)
    value = lambda k: (cfg.dt_ctrl if k == "dt" else getattr(cfg.rt, k)
                       if k[0] in "vf" else getattr(cfg, k))
    assert ops_post_window.step_constants(cfg) == [
        value(_snake(k)) for k in _enum("Const")]


def _kernel_mirror(cfg, st, exog, mppt, t, y1, flag, pk, uk):
    """csrc/post_window.cu's `step_env` over every env in numpy, one
    rounding per operation in the kernel's order; the named leaves of
    `chip_smoke._post_window_leaves`."""
    dt = np.float32 if cfg.dtype == torch.float32 else np.float64
    n_ph = cfg.der.n_ph
    P = dict(zip(P_FIELDS, pk.numpy()))
    U = dict(zip(U_FIELDS, uk.numpy()))
    c = {_snake(k): dt(v) for k, v in zip(
        _enum("Const"), ops_post_window.step_constants(cfg))}
    one, zero = dt(1.0), dt(0.0)
    inv_1000 = one / dt(1000.0)
    y = y1.numpy().T
    ak_re = ak_im = None
    if n_ph == 3:
        ang = np.array([0.0, -TWO_PI_3, TWO_PI_3], dt)[:, None]
        ak_re, ak_im = np.cos(ang), np.sin(ang)
    # load_feeder, grid_rot, pcc_voltage
    rg, xg = P["rg"], P["xg"]
    dg = rg * rg + xg * xg
    yg_re, yg_im = rg / dg, -xg / dg
    yt_re, yt_im = yg_re + U["g_load"], yg_im + U["b_load"]
    d2 = yt_re * yt_re + yt_im * yt_im
    iyt_re, iyt_im = yt_re / d2, -yt_im / d2
    conn = U["conn"]
    t1 = t.numpy() + c["dt"]
    phi = U["phi_g"] + (P["w_base"] * U["dw_g"]) * (t1 - U["t_g"])
    rot_re, rot_im = np.cos(phi), np.sin(phi)
    ii_re, ii_im = y[:n_ph] * conn, y[n_ph:2 * n_ph] * conn
    vg_re, vg_im = rot_re * U["v_g"], rot_im * U["v_g"]
    if n_ph == 3:
        e2_re, e2_im = np.cos(U["phi_g2"]), np.sin(U["phi_g2"])
        v2_re = (e2_re * ak_re - e2_im * -ak_im) * U["v_g2"]
        v2_im = (e2_re * -ak_im + e2_im * ak_re) * U["v_g2"]
        vg_re, vg_im = ((vg_re * ak_re - vg_im * ak_im)
                        + (rot_re * v2_re - rot_im * v2_im),
                        (vg_re * ak_im + vg_im * ak_re)
                        + (rot_re * v2_im + rot_im * v2_re))
    s_re = (vg_re * yg_re - vg_im * yg_im) + ii_re
    s_im = (vg_re * yg_im + vg_im * yg_re) + ii_im
    v_re = s_re * iyt_re - s_im * iyt_im
    v_im = s_re * iyt_im + s_im * iyt_re

    def mean(x):
        s = zero
        for k in range(n_ph):
            s = s + x[k]
        return s * (one / dt(n_ph))

    if n_ph == 1:
        vp_re, vp_im, ip_re, ip_im = map(mean, (v_re, v_im, ii_re, ii_im))
    else:
        vp_re = mean(v_re * ak_re - v_im * -ak_im)
        vp_im = mean(v_re * -ak_im + v_im * ak_re)
        ip_re = mean(ii_re * ak_re - ii_im * -ak_im)
        ip_im = mean(ii_re * -ak_im + ii_im * ak_re)
    vdc, xpll, theta = y[6 * n_ph], y[6 * n_ph + 3], y[6 * n_ph + 4]
    v_q = vp_re * -np.sin(theta) + vp_im * np.cos(theta)
    f_meas = (one + P["kp_pll"] * v_q) + xpll
    p_pcc = mean(v_re * ii_re - v_im * -ii_im)
    q_pcc = mean(v_re * -ii_im + v_im * ii_re)
    one_en = one + zero * (conn * (one - U["ces"]))
    iph = ((P["isc_ref"] + P["ki_t"] * (U["t_cell"] - dt(298.15)))
           * (U["s_irr"] * inv_1000))
    vdc_v = vdc * P["vdc_base"]
    ex = (P["gamma"] / U["t_cell"]) * vdc_v
    i_arr = np.maximum(P["np_par"] * (iph - P["irs"] * (np.exp(ex) - one)),
                       zero)
    p_pv = (i_arr * vdc_v) * (one_en / P["s_rated"])
    if n_ph == 1:
        u2 = (v_re[0] * zero, v_im[0] * zero)
    else:
        u2 = (mean(v_re * ak_re - v_im * ak_im),
              mean(v_re * ak_im + v_im * ak_re))
    # rt_update
    v_mag = np.hypot(vp_re, vp_im)
    in_zone = (v_mag < c["v_lv1"], v_mag < c["v_lv2"], v_mag > c["v_hv1"],
               v_mag > c["v_hv2"], f_meas < c["f_lf"], f_meas > c["f_hf"])
    tm = st.rt.timers.numpy().T.copy()
    enable, t_lim = cfg.rt.enable.numpy(), cfg.rt.t_lim.numpy()
    trip = np.zeros_like(v_mag)
    for k in range(6):
        z = np.where(in_zone[k], one, zero) * enable[k]
        tm[k] = (tm[k] + c["dt"]) * z
        trip = np.maximum(trip, np.where(tm[k] > t_lim[k], one, zero))
        if k == 1:
            ces = z
    tripped0 = st.rt.tripped.numpy()
    tripped = np.maximum(tripped0, trip)
    trip_now = tripped * (one - tripped0)
    # outputs
    t_step = st.t_step.numpy() + np.int32(1)
    vdc_ref, q_ref, s_irr = U["vdc_ref"], U["q_ref"], U["s_irr"]
    obs = np.stack([ip_re, ip_im, vp_re, vp_im, vdc, p_pcc, q_pcc, vdc_ref,
                    q_ref, s_irr * inv_1000, (f_meas - one) * dt(10.0),
                    t_step.astype(dt) * (one / dt(cfg.horizon)),
                    one - tripped], -1)
    band = (np.maximum(v_mag - dt(1.05), zero)
            + np.maximum(dt(0.95) - v_mag, zero))
    reward = c["r_alive"] - np.abs(vdc - vdc_ref) * c["w_vdc"]
    reward = reward - np.abs(q_pcc - q_ref) * c["w_q"]
    reward = reward - band * c["w_vband"]
    reward = reward - trip_now * c["r_trip"]
    if cfg.anomaly_detect:
        dev = ((np.abs(U["v_g"] - one) > dt(1e-6)) | (U["v_g2"] > dt(1e-9))
               | (np.abs(U["dw_g"]) > dt(1e-9))
               | (np.abs(s_irr - st.s0.numpy()) > dt(1e-3))
               | (U["g_load"] > dt(1e-9)) | (np.abs(U["b_load"]) > dt(1e-9)))
        anom = np.where(dev, one, zero)
        f = flag.numpy()
        reward = reward + (f * (anom * c["r_anom_tp"]
                                - (one - anom) * c["r_anom_fp"])
                           - ((one - f) * anom) * c["r_anom_fn"])
    terminated = tripped > dt(0.5)
    truncated = t_step >= cfg.horizon
    return {"t_step": t_step, "timers": tm.T, "tripped": tripped, "ces": ces,
            "obs": obs, "reward": reward, "done": terminated | truncated,
            "info.vdc": vdc, "info.v_mag": v_mag, "info.f_meas": f_meas,
            "info.v_unb": np.hypot(*u2), "info.p_pcc": p_pcc,
            "info.q_pcc": q_pcc, "info.p_pv": p_pv, "info.tripped": tripped,
            "info.trip_now": trip_now, "info.terminated": terminated,
            "info.truncated": truncated}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("preset", ["10", "50"])
def test_torch_post_window_kernel_arithmetic_matches_plain(preset, dtype):
    st, args, pk, uk = _case(preset, dtype, n=512, seed=7)
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    for anomaly in (False, True):
        for rt in (True, False):
            cfg = _cfg(preset, dtype, anomaly, rt)
            got = _kernel_mirror(cfg, st, *args, pk, uk)
            want = {k: v.numpy() for k, v in cs._post_window_leaves(
                core._post_window_plain(cfg, st, *args)).items()}
            assert set(got) == set(want)
            for k, w in want.items():
                g = np.asarray(got[k])
                assert g.dtype == w.dtype and g.shape == w.shape, k
                if k in cs.POST_WINDOW_EXACT or np.array_equal(g, w):
                    assert np.array_equal(g, w), (k, anomaly, rt)
                    continue
                gap = np.abs(g - w).max() / np.abs(w).max()
                assert gap <= tol, (k, anomaly, rt, gap)
            # every threshold of the step is crossed in these inputs
            zones = want["timers"].max(0) > 0
            assert zones.all() == rt and want["info.truncated"].any()
            assert want["info.trip_now"].any() == rt
            assert (want["reward"] != cs._post_window_leaves(
                core._post_window_plain(_cfg(preset, dtype, not anomaly, rt),
                                        st, *args))["reward"].numpy()).any()


@pytest.mark.parametrize("n_ph, dtype, per_env", [
    (1, torch.float32, 295), (1, torch.float64, 579),
    (3, torch.float32, 351), (3, torch.float64, 691)])
def test_torch_post_window_bytes(n_ph, dtype, per_env):
    # reads: y1 (6 n_ph + 5), 11 param rows, 12 exog rows (14 at three
    # phases), t, 6 timers, the latch; writes: obs 13, reward, 6 timers,
    # latch, cessation, 7 info leaves; t_step in and out (int32), 3 flags
    size = torch.finfo(dtype).bits // 8
    assert per_env == ((6 * n_ph + 5 + 11 + 12 + 2 * (n_ph == 3) + 8)
                       + 29) * size + 11
    assert ops_post_window.post_window_bytes(1000, n_ph, dtype) == (
        1000 * per_env)


@pytest.mark.gpu
def test_torch_post_window_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the post-window kernel has no CPU "
                    "mode")
    out = cs.check_post_window("cuda", sizes=(37, 1000), timed_n=None)
    assert out["cases"] == 32
