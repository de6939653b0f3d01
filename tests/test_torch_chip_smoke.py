"""The chip scripts' report parsers, on canned compiler output (no nvcc).

- `chip_smoke.ptxas_summary` reads registers and spill bytes for every
  window kernel of an `nvcc -Xptxas -v` report: K1 (`window_kernel<N>`), K2
  (`fleet_window_kernel<N,THREADS>`) and K3 (`window_df_kernel<N>`: one
  lane per env at N = 1, a two-lane team at N = 3), so the build phase
  keeps reporting the three-phase df32 kernel's spills.
- `profile_torch_step.sass_loops` finds, in a `cuobjdump -sass` listing, the
  substep loop (the largest backward branch) and the stage loop inside it,
  and estimates the instructions one substep runs; `sass_per_substep` and
  `sass_issue_floor_ms` turn that into the SASS-issue floor, and
  `trace_launch` reads a launch's warps from a profiler trace.
- A phase that raises ends `chip_smoke.main` with one ``[failed]`` line
  naming it and exit code 1; a subprocess past its timeout is stopped and
  named with its phase and the end of its stderr (`wait_for`).
- `kernel_name` reads the env glue kernels' names (`autoreset_kernel`,
  `post_window_kernel`, templated over the type and the phases;
  `pre_window_kernel`, also over whether the supervisory layer runs).
- Phase 38 (`check_post_window`) runs on the CPU and fails on a one-bit
  difference or a write into its inputs.
- Phase 35 (`run_notebooks`) runs `run_cells --device cpu --tiny`;
  `run_cells` never runs a cell tagged ``plot``.
"""
import numpy as np
import pytest

from chip_smoke import kernel_name, ptxas_summary
from profile_torch_step import (sass_issue_floor_ms, sass_loops,
                                sass_per_substep, trace_launch)

_DF = "_ZN45_GLOBAL__N__ff6dd2e5_12_window_df_cu_c1c5c16e16window_df_kernel"
_K1 = "_ZN41_GLOBAL__N__fab7f576_9_window_cu_308ee5ab13window_kernel"
_K2 = "_ZN48_GLOBAL__N__08fb09c3_15_fleet_window_cu_e514cc2419fleet_window_kernel"


def _entry(name, regs, stores, loads):
    return (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {name}\n"
            f"    0 bytes stack frame, {stores} bytes spill stores, "
            f"{loads} bytes spill loads\n"
            f"ptxas info    : Used {regs} registers, used 0 barriers\n"
            "ptxas info    : Compile time = 353.952 ms\n")


REPORT = ("ptxas info    : 16 bytes gmem\n"
          + _entry(f"{_DF}ILi3EEEvPKfS2_S2_S2_S2_PfS3_iiff", 255, 120, 136)
          + _entry(f"{_DF}ILi1EEEvPKfS2_S2_S2_S2_PfS3_iiff", 201, 0, 0)
          + "ptxas info    : 24 bytes gmem\n"
          + _entry(f"{_K1}ILi3EEEvPKfS2_S2_S2_Pfiifff", 176, 0, 0)
          + _entry(f"{_K1}ILi1EEEvPKfS2_S2_S2_Pfiifff", 111, 0, 0)
          + _entry(f"{_K2}ILi3ELi1024EEEvPKfS2_S2_S2_Pfiiiiifff", 32, 1944,
                   3728)
          + _entry(f"{_K2}ILi1ELi256EEEvPKfS2_S2_S2_Pfiiiiifff", 120, 0, 0))


def test_torch_chip_smoke_ptxas_summary_reads_every_window_kernel():
    got = ptxas_summary(REPORT)
    want = {
        "window_df_kernel<3>": (255, 120, 136),
        "window_df_kernel<1>": (201, 0, 0),
        "window_kernel<3>": (176, 0, 0),
        "window_kernel<1>": (111, 0, 0),
        "fleet_window_kernel<3,1024>": (32, 1944, 3728),
        "fleet_window_kernel<1,256>": (120, 0, 0),
    }
    assert set(got) == set(want)
    for name, (regs, stores, loads) in want.items():
        assert got[name] == dict(registers=regs, spill_stores=stores,
                                 spill_loads=loads), name


def _sass(name, body):
    lines = [f"\t\tFunction : {name}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
    lines += [f"        /*{16 * i:04x}*/                   {ins} ;"
              "   /* 0x000fe20000000f00 */" for i, ins in enumerate(body)]
    return "\n".join(lines) + "\n"


def test_torch_chip_smoke_sass_loops_nested_and_flat():
    # a substep loop (0x20..0xb0) around a stage loop (0x40..0x80), with a
    # forward branch, a NOP (not counted) and the exit after them
    nested = ["MOV R1, c[0x0][0x28]", "IADD3 R2, R2, 0x1, RZ",
              "FADD R3, R3, R4", "FMUL R5, R5, R6", "@!P0 BRA 0x80",
              "FFMA R7, R7, R8, R9", "SHFL.BFLY PT, R10, R11, 0x1, 0x1f",
              "NOP", "@P1 BRA 0x40", "FADD R3, R3, R5", "ISETP.GE.AND P2, PT",
              "@P2 BRA 0x20", "EXIT"]
    flat = ["MOV R1, c[0x0][0x28]", "FADD R3, R3, R4", "FADD R3, R3, R4",
            "@P0 BRA 0x10", "EXIT"]
    got = sass_loops(_sass("k_nested", nested) + _sass("k_flat", flat))
    assert got["k_nested"] == dict(instructions=12, substep_loop=9,
                                   stage_loop=4, per_substep_est=21)
    assert got["k_flat"] == dict(instructions=5, substep_loop=3, stage_loop=0,
                                 per_substep_est=3)


def test_torch_chip_smoke_kernel_name_short_forms():
    assert kernel_name(f"{_DF}ILi3EEEvPKfS2_S2_S2_S2_PfS3_iiff") \
        == "window_df_kernel<3>"
    assert kernel_name(f"{_K2}ILi1ELi256EEEvPKfS2_S2_S2_Pfiiiiifff") \
        == "fleet_window_kernel<1,256>"
    assert kernel_name("_Z6helperv") == "_Z6helperv"
    # demangled, as a profiler trace names them
    assert kernel_name("void (anonymous namespace)::fleet_window_kernel<1, "
                       "256>(float const*, float const*, int)") \
        == "fleet_window_kernel<1,256>"
    assert kernel_name("void (anonymous namespace)::window_kernel<3>(float "
                       "const*, float*, int, int, float)") == "window_kernel<3>"


def test_torch_chip_smoke_k1_names_are_what_the_roofline_readers_match():
    """The benchmark's K1 readers find K1 by name: `k1_roofline_pct.K1`
    every K1 template, `k1_3ph_roofline_pct.K1_3PH` the three-phase one
    alone; neither reads K2. The kernels' names and template arguments are
    taken from what `window.cu` and `fleet_window.cu` launch and mangled
    as nvcc does, so a renamed K1, which would leave a cell's roofline
    share unread, fails here before a chip runs it."""
    import re

    from portbench.metrics.k1_3ph_roofline_pct import K1_3PH
    from portbench.metrics.k1_roofline_pct import K1
    from pvderx_torch.ops import _build

    def launched(src, args):
        """(kernel, template arguments) of each launch in ``src``."""
        text = (_build.CSRC / src).read_text()
        return re.findall(r"(\w+)<(" + args + r")><<<", text)

    def mangled(name, args):
        targs = "".join(f"Li{a.strip()}E" for a in args.split(","))
        return f"_ZN12_GLOBAL__N_1{len(name)}{name}I{targs}EEvPKfS2_S2_S2_Pfiifff"

    k1 = {int(args): kernel_name(mangled(name, args))
          for name, args in launched("window.cu", r"\d+")}
    assert k1 == {1: "window_kernel<1>", 3: "window_kernel<3>"}
    assert K1.search(k1[1]) and K1.search(k1[3])
    assert K1_3PH.search(k1[3])
    assert not K1_3PH.search(k1[1])
    k2 = [kernel_name(mangled(name, f"{n_ph}, {threads}"))
          for name, _ in launched("fleet_window.cu", r"[\w, ]+")
          for n_ph in (1, 3) for threads in (256, 1024)]
    assert k2 == [f"fleet_window_kernel<{n_ph},{threads}>"
                  for n_ph in (1, 3) for threads in (256, 1024)]
    for name in (*k2, "void (anonymous namespace)::fleet_window_kernel<3, "
                      "1024>(float const*, float const*, int)"):
        assert not K1.search(name) and not K1_3PH.search(name), name


def test_torch_chip_smoke_glue_kernel_names():
    """The env glue kernels, templated over the type and the phases, by
    their mangled and their demangled names; none reads as K1."""
    pw = "_ZN53_GLOBAL__N__1a2b3c4d_14_post_window_cu_5e6f7a8b18post_window_kernel"
    assert kernel_name(f"{pw}IfLi1EEEvNS_4ArgsIT_EEi") \
        == "post_window_kernel<float,1>"
    assert kernel_name(f"{pw}IdLi3EEEvNS_4ArgsIT_EEi") \
        == "post_window_kernel<double,3>"
    assert kernel_name("_ZN12_GLOBAL__N_116autoreset_kernelIfLi3EEEvNS_4Args"
                       "IT_EEi") == "autoreset_kernel<float,3>"
    assert kernel_name("void (anonymous namespace)::post_window_kernel<float, "
                       "1>((anonymous namespace)::Args<float>, int)") \
        == "post_window_kernel<float,1>"
    report = (f"ptxas info    : Compiling entry function '{pw}IfLi1EEEvNS_4Args"
              "IT_EEi' for 'sm_90a'\nptxas info    : Function properties for "
              f"{pw}IfLi1EEEvNS_4ArgsIT_EEi\n    0 bytes stack frame, 0 bytes "
              "spill stores, 0 bytes spill loads\nptxas info    : Used 48 "
              "registers, used 0 barriers, 6656 bytes smem\n")
    assert ptxas_summary(report) == {"post_window_kernel<float,1>": dict(
        spill_stores=0, spill_loads=0, registers=48)}


def test_torch_chip_smoke_pre_window_kernel_names():
    """The pre-window kernel, templated over the type, the phases and the
    supervisory layer, by its mangled and demangled names and in a ptxas
    report."""
    pre = ("_ZN46_GLOBAL__N__8c99af9f_13_pre_window_cu_ad9432e417"
           "pre_window_kernel")
    assert kernel_name(f"{pre}IfLi1ELb0EEEvNS_4ArgsIT_EEi") \
        == "pre_window_kernel<float,1,false>"
    assert kernel_name(f"{pre}IdLi3ELb1EEEvNS_4ArgsIT_EEi") \
        == "pre_window_kernel<double,3,true>"
    assert kernel_name("void (anonymous namespace)::pre_window_kernel<float, "
                       "1, false>((anonymous namespace)::Args<float>, int)") \
        == "pre_window_kernel<float,1,false>"
    report = (f"ptxas info    : Compiling entry function '{pre}IfLi1ELb0EEEvNS"
              "_4ArgsIT_EEi' for 'sm_90a'\nptxas info    : Function properties "
              f"for {pre}IfLi1ELb0EEEvNS_4ArgsIT_EEi\n    0 bytes stack frame, "
              "0 bytes spill stores, 0 bytes spill loads\nptxas info    : Used "
              "32 registers, used 1 barriers\n")
    assert ptxas_summary(report) == {"pre_window_kernel<float,1,false>": dict(
        spill_stores=0, spill_loads=0, registers=32)}


def test_torch_chip_smoke_sass_issue_floor_flat_and_looped():
    # written-out stages: a substep loop (0x10..0xb0) that holds only a small
    # inner loop (0x40..0x60, the sin/cos reduction): one substep runs the
    # substep loop's 12 instructions
    flat = ["MOV R1, c[0x0][0x28]", "FADD R3, R3, R4", "FMUL R5, R5, R6",
            "FFMA R7, R7, R8, R9", "IADD3 R2, R2, 0x1, RZ", "@P0 BRA 0x40",
            "MUFU.RSQ R1, R2", "FADD R3, R3, R4", "FADD R3, R3, R4",
            "FADD R3, R3, R4", "FADD R3, R3, R4", "@P1 BRA 0x10", "EXIT"]
    # looped stages: the stage loop (0x30..0x90, 7) fills most of the
    # substep loop (0x10..0xb0, 11): the estimate counts it four times
    looped = ["MOV R1, c[0x0][0x28]", "MUFU.SIN R2, R3", "MUFU.COS R4, R3",
              "FADD R3, R3, R4", "FMUL R5, R5, R6", "FFMA R7, R7, R8, R9",
              "SHFL.BFLY PT, R10, R11, 0x1, 0x1f", "FADD R3, R3, R5",
              "FADD R3, R3, R5", "@P1 BRA 0x30", "ISETP.GE.AND P2, PT",
              "@P2 BRA 0x10", "EXIT"]
    got = sass_loops(_sass("k_flat", flat) + _sass("k_looped", looped))
    assert got["k_flat"] == dict(instructions=13, substep_loop=11,
                                 stage_loop=2, per_substep_est=17)
    assert got["k_looped"] == dict(instructions=13, substep_loop=11,
                                   stage_loop=7, per_substep_est=32)
    assert sass_per_substep(got["k_flat"]) == (False, 11)
    assert sass_per_substep(got["k_looped"]) == (True, 32)
    # 2000 instructions per substep, 64 substeps, 1024 warps at 1980 MHz:
    # 1.31e8 warp instructions over 528 schedulers
    assert sass_issue_floor_ms(2000, 64, 1024, 1980.0) == pytest.approx(
        1e3 * 2000 * 64 * 1024 / (132 * 4 * 1980e6), rel=1e-12)
    assert sass_issue_floor_ms(2000, 64, 1024, 1980.0) == pytest.approx(
        0.12537, abs=1e-5)


def test_torch_chip_smoke_trace_launch_reads_warps():
    trace = {"traceEvents": [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "args": {}},
        {"cat": "kernel", "name": "void at::native::vectorized_elementwise"
         "_kernel<4>(int)", "args": {"grid": [8, 1, 1], "block": [128, 1, 1]}},
        {"cat": "kernel", "name": "void (anonymous namespace)::fleet_window_"
         "kernel<1, 256>(float const*, int)",
         "args": {"grid": [512, 1, 1], "block": [128, 1, 1]}},
    ]}
    assert trace_launch(trace) == dict(kernel="fleet_window_kernel<1,256>",
                                       warps=2048)
    # a partial warp per block still issues as a whole warp
    ragged = {"traceEvents": [{"cat": "kernel", "name": "window_kernel<1>",
                               "args": {"grid": [3, 1, 1],
                                        "block": [96, 1, 1]}}]}
    assert trace_launch(ragged)["warps"] == 9
    ragged["traceEvents"][0]["args"]["block"] = [80, 1, 1]
    assert trace_launch(ragged)["warps"] == 9
    assert trace_launch({"traceEvents": []}) is None


def test_torch_chip_smoke_kernel_shapes_are_the_main_paths():
    from chip_smoke import FLEET_ENVS, FLEET_M, N_ENVS, N_SUB
    from profile_torch_step import kernel_shapes
    from pvderx_torch.ops.dualfloat import OPS_PER_SUBSTEP_DF
    from pvderx_torch.ops.window import OPS_PER_SUBSTEP

    shapes = kernel_shapes("cpu")
    assert list(shapes) == ["k1_preset10", "k1_preset50", "k2_config5",
                            "k3_preset10", "k3_preset50"]
    ops = {k: v[1] for k, v in shapes.items()}
    assert ops["k1_preset10"] == OPS_PER_SUBSTEP[1] * N_SUB * N_ENVS
    assert ops["k1_preset50"] == OPS_PER_SUBSTEP[3] * N_SUB * N_ENVS
    assert ops["k2_config5"] == (OPS_PER_SUBSTEP[1] * N_SUB * FLEET_ENVS
                                 * FLEET_M)
    assert ops["k3_preset50"] == OPS_PER_SUBSTEP_DF[3] * N_SUB * N_ENVS
    call = shapes["k2_config5"][0]
    y = call.args[0]
    assert tuple(y.shape) == (FLEET_ENVS, FLEET_M, 11)
    assert call.keywords == dict(n_ph=1, m=FLEET_M, n_sub=N_SUB,
                                 dt=1.0 / 60.0)
    y_hi, y_lo = shapes["k3_preset50"][0].args[:2]
    assert tuple(y_hi.shape) == tuple(y_lo.shape) == (N_ENVS, 23)
    assert bool((y_lo != 0).any())


@pytest.mark.parametrize("what, err", [
    ("fleet kernel at M=1 vs K1", 3.37e-7),      # the reading that slipped by
    ("df32 kernel vs plain", 1e-15),
    ("df32 kernel vs plain", float("nan")),
])
def test_torch_chip_smoke_bitwise_checks_raise_on_any_difference(what, err):
    from chip_smoke import require_bitwise

    with pytest.raises(AssertionError, match="not bitwise equal"):
        require_bitwise(what, err)
    require_bitwise(what, 0.0)
    require_bitwise(what, -0.0)


def test_torch_chip_smoke_df_gate_reads_preset50_at_the_references_n_sub():
    import inspect

    from chip_smoke import (DF_GATE_CASES, DF_GATE_REFERENCE, N_SUB,
                            check_df_gate)

    assert inspect.signature(check_df_gate).parameters["cases"].default \
        == DF_GATE_CASES
    assert DF_GATE_CASES == (("10", N_SUB), ("50", N_SUB), ("50", 80))
    # benchmarks/DUALFLOAT.json df32_max_abs_err_preset50, taken at n_sub=80
    assert DF_GATE_REFERENCE == {("50", 80): pytest.approx(3.23e-7, rel=1e-3)}


# ---------------------------------------------------------------------------
# the slice's phases (implicit, fleet_implicit, gym, sim, config), rehearsed
# on the CPU at tiny sizes: no card, so no kernel launch is counted
# ---------------------------------------------------------------------------
def test_torch_chip_smoke_final_obs_check_raises_on_a_missing_row():
    from chip_smoke import check_final_obs

    done = np.array([False, True, False])
    obs = np.zeros((3, 13), np.float32)
    check_final_obs({"final_obs": obs, "_final_obs": done}, done)
    check_final_obs({}, np.zeros(3, bool))
    for info, msg in [({}, "without final_obs"),
                      ({"final_obs": obs}, "without final_obs"),
                      ({"final_obs": obs, "_final_obs": ~done}, "done rows"),
                      ({"final_obs": obs + np.nan, "_final_obs": done},
                       "not finite")]:
        with pytest.raises(AssertionError, match=msg):
            check_final_obs(info, done)
    with pytest.raises(AssertionError, match="no episode done"):
        check_final_obs({"final_obs": obs, "_final_obs": done},
                        np.zeros(3, bool))


def test_torch_chip_smoke_slice_constants_are_the_references():
    """The implicit window cases carry tests/test_variants.py:84-107's
    bounds, the env phase its `_sag_cfg` scenario, the sim phase the
    schedule of tests/test_sim_diag.py:14-22."""
    from chip_smoke import (IMPLICIT_WINDOW_CASES, SAG_SCEN, _sag_exog,
                            _sim_exogs)

    assert IMPLICIT_WINDOW_CASES == (("trapezoid", 10, 5e-6),
                                     ("trapezoid", 20, 1e-6),
                                     ("backward_euler", 40, 5e-5))
    assert SAG_SCEN == dict(p_sag=1.0, p_freq=0.0, sag_depth_lo=0.5,
                            sag_depth_hi=0.5, sag_t_lo=0.3, sag_t_hi=0.3,
                            sag_dur_lo=0.3, sag_dur_hi=0.3)
    assert [_sag_exog(k).v_g for k in (29, 30, 59, 60)] == [1.0, 0.5, 0.5,
                                                             1.0]
    ex = _sim_exogs(180)
    assert len(ex) == 180
    assert (ex[59].s_irr, ex[60].s_irr, ex[119].v_g, ex[120].v_g,
            ex[143].v_g, ex[144].v_g) == (1000.0, 500.0, 1.0, 0.7, 0.7, 1.0)


def test_torch_chip_smoke_slice_phases_run_on_the_cpu():
    """Every new phase at a tiny size on the CPU: its checks pass and it
    prints its line (the card's checks of launch counts are skipped off
    the card)."""
    import chip_smoke as cs

    errs = cs.check_implicit_window("cpu", cases=[("trapezoid", 10, 5e-6)],
                                    n=1, n_windows=3)
    assert set(errs) == {("trapezoid", 10)}
    env = cs.run_implicit_env("cpu", "cpu", n_envs=2, steps=2)
    assert set(env) == {"trapezoid", "backward_euler"}
    assert all(v["k1_launches"] == 0 and v["dones"] == 2 for v in env.values())
    fl = cs.run_fleet_implicit("cpu", "cpu", n_envs=1, m=2, n_sub=2, steps=2,
                               fit_envs=2)
    assert fl["max_abs_diff_f32_f64"] <= cs.FLEET_IMPLICIT_TOL
    assert fl["fit_finite"] and fl["fit_envs"] == 2
    gym = cs.run_gym("cpu", "cpu", n_envs=2, vec_steps=2, steps=2, m=2)
    assert gym["vector"]["dones"] == 2 and set(gym) == {
        "gymnasium", "vector", "single", "fleet", "fleet_per_unit"}
    sim = cs.run_sim("cpu", "cpu", t_stop=0.05, knob_stop=0.05)
    assert sim["windows"] == 3 and sim["max_abs_err"] <= cs.GATE_TOL
    cfgs = cs.run_config("cpu", "cpu", n_envs=2, steps=1)
    assert set(cfgs) == {"env_config2_voltvar", "env_config3_lvrt",
                         "env_config4_mppt"}


def test_torch_chip_smoke_traced_kernel_launches_by_name():
    """`traced_kernel_launches` counts K1, K2 and K3 rows of a
    `device_op_summary`, mangled or demangled, and nothing else."""
    from chip_smoke import traced_kernel_launches

    rows = [("void (anonymous namespace)::window_kernel<1>(float const*)",
             0.4, 3),
            ("void (anonymous namespace)::fleet_window_kernel<1, 256>(int)",
             0.2, 1),
            (f"{_DF}ILi1EEEvPKfS2_S2_S2_S2_PfS3_iiff", 1.3, 1),
            ("void at::native::vectorized_elementwise_kernel<4>(int)", 0.1, 40),
            ("aten::mul", 2.0, 300)]
    assert traced_kernel_launches(rows) == {"k1": 3, "k2": 1, "k3": 1}
    assert traced_kernel_launches([]) == {"k1": 0, "k2": 0, "k3": 0}


def test_torch_chip_smoke_bitwise_differences_are_bit_for_bit():
    import torch

    from chip_smoke import bitwise_differences

    a = {"tensors": {"y": torch.tensor([0.0, float("nan")])},
         "scalars": {"n": 3}}
    same = {"tensors": {"y": torch.tensor([0.0, float("nan")])},
            "scalars": {"n": 3}}
    assert bitwise_differences(a, same) == []
    neg = {"tensors": {"y": torch.tensor([-0.0, float("nan")])},
           "scalars": {"n": 3}}
    assert bitwise_differences(a, neg) == ["/tensors/y"]
    assert bitwise_differences(a, {"tensors": {"y": torch.zeros(2)},
                                   "scalars": {"n": 4}}) == [
        "/tensors/y", "/scalars/n"]
    assert bitwise_differences({"x": [1, 2]}, {"x": [1]}) == ["/x"]
    assert bitwise_differences(torch.zeros(2), torch.zeros(3)) == [""]
    # dataclasses of tensors, field by field
    from pvderx_torch.scenario.mppt_voltvar import MPPTState

    m = MPPTState(p_prev=torch.tensor([0.0, 1.0]), direction=torch.ones(2))
    assert bitwise_differences((m, None), (MPPTState(
        p_prev=torch.tensor([0.0, 1.0]), direction=torch.ones(2)), None)) == []
    assert bitwise_differences(m, MPPTState(
        p_prev=torch.tensor([-0.0, 1.0]), direction=torch.ones(2))) == [
        "/p_prev"]


def test_torch_chip_smoke_diag_phases_run_on_the_cpu():
    """Phases 24-26 at a tiny size on the CPU (launch counts are the card's
    checks): the traced main and fleet steps, the checked step, the NaN
    trap, and the bitwise resume of the three learners."""
    import chip_smoke as cs

    prof = cs.run_diag_profiler("cpu", "cpu", n_envs=3, fleet_envs=2, m=2,
                                n_sub=40, steps=2, reps=2,
                                paths=("main", "fleet"))
    assert set(prof) == {"main", "fleet"} and prof["main"]["steps"] == 2
    assert prof["main"]["stopwatch_env_steps_per_s"] > 0
    assert prof["main"]["device_ms"] > 0           # the host track off the card
    dbg = cs.run_diag_debug("cpu", "cpu", n_envs=3, n_sub=40, guard_n=2)
    assert dbg["clean"] is None and dbg["bad_env"] == 1
    assert dbg["caught"].startswith("non-finite state after step: env 1")
    assert dbg["trapped"].startswith("NaN in the output of aten")
    # off the card the plain windows run: differentiable, nothing to guard
    assert all(g["raised"] is None and g["grad_fn"]
               for g in dbg["grad_guard"].values())
    ckpt = cs.run_diag_checkpoint("cpu", "cpu", ppo_envs=4, off_envs=4,
                                  n_sub=40, hidden=(16, 16), more=1)
    assert set(ckpt) == {"ppo", "dqn", "sac"}
    assert all(v["differences"] == [] for v in ckpt.values())


def test_torch_chip_smoke_grad_and_examples_phases_run_on_the_cpu():
    """Phases 27-28 at a tiny size on the CPU: the float64 gradient against
    its finite difference and one descent step, gain tuning's gradient at
    one and two windows; the four examples as subprocesses with --cpu."""
    import chip_smoke as cs

    grad = cs.run_grad("cpu", "cpu", steps=1, windows=1, tune_windows=2,
                       tune_probe=1, tune_sub=40)
    assert grad["float64"]["fd_rel_err"] <= cs.GRAD_FD_TOL
    assert grad["float64"]["loss_after"] < grad["float64"]["loss"]
    assert [r["windows"] for r in grad["gain_tuning"]["runs"]] == [1, 2]
    ex = cs.run_examples("cpu", "cpu", examples=(
        ("standalone_simulation", ["--tstop", "0.05"], {"k1": 3, "k2": 0}),
        ("gym_rollout", ["--steps", "3"], {"k1": 3, "k2": 0}),
        ("fleet_simulation", ["--m", "2", "--n-envs", "2", "--steps", "2",
                              "--n-sub", "40"], {"k1": 0, "k2": 2}),
        ("gain_tuning", ["--iters", "1", "--windows", "1", "--n-sub", "40"],
         {"k1": 0, "k2": 0})))
    assert all(v["rc"] == 0 for v in ex.values()) and len(ex) == 4


def test_torch_chip_smoke_prefetched_truth_is_the_inline_one():
    """A truth started on a process pool (`prefetch_truths`, as `main`
    does while the kernels build) is the one computed in this process."""
    import concurrent.futures
    import multiprocessing

    import chip_smoke as cs

    key = ("gate", "10", 3)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cs.prefetch_truths(pool, [key])
        got, seconds = cs._truth(*key)
    want, _ = cs._truth_job(key)
    assert got.shape == want.shape == (4, want.shape[1]) and seconds > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fails_in,target", [
    ("build", ("pvderx_torch.ops._build", "build")),
    ("kernel", ("chip_smoke", "check_kernel")),
])
def test_torch_chip_smoke_a_failing_phase_prints_one_failed_line(
        monkeypatch, capsys, fails_in, target):
    """`main` on a (faked) card whose phase ``fails_in`` raises: exactly one
    ``[failed]`` line naming that phase and the error, no result line, and
    exit code 1."""
    import importlib
    import json

    import chip_smoke as cs
    from pvderx_torch.ops import _build

    def boom(*a, **kw):
        raise RuntimeError(f"{fails_in} broke")

    monkeypatch.setattr(cs.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cs.torch.cuda, "get_device_name", lambda i=0: "Fake")
    monkeypatch.setattr(cs, "_smi", lambda q: "1980 MHz" if "clocks" in q
                        else "Fake, 700.00 W")
    monkeypatch.setattr(cs, "prefetch_truths", lambda pool: None)
    for name in ("build", "load"):
        monkeypatch.setattr(_build, name, lambda *a, **kw: None)
    monkeypatch.setattr(_build, "ptxas_report", lambda: "")
    monkeypatch.setattr(importlib.import_module(target[0]), target[1], boom)
    rc = cs.main()
    out, err = capsys.readouterr()
    lines = out.splitlines()
    failed = [ln for ln in lines if ln.startswith("[failed] ")]
    assert rc == 1 and len(failed) == 1 and lines[-1] == failed[0]
    got = json.loads(failed[0][len("[failed] "):])
    assert got["phase"] == fails_in
    assert got["error"] == f"RuntimeError: {fails_in} broke"
    assert got["at_s"] > 0 and "Traceback" in err
    assert not any('"ok": true' in ln for ln in lines)


def test_torch_chip_smoke_a_subprocess_timeout_names_phase_job_and_stderr():
    import subprocess
    import sys

    import chip_smoke as cs

    cs.begin("examples")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, time\n"
         "sys.stderr.write('the tail of stderr\\n'); sys.stderr.flush()\n"
         "time.sleep(120)\n"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    with pytest.raises(TimeoutError) as info:
        cs.wait_for(proc, "example gym_rollout", 3)
    msg = str(info.value)
    assert msg.startswith("phase examples: example gym_rollout did not end "
                          "within 3 s")
    assert "the tail of stderr" in msg and proc.poll() is not None


def test_torch_chip_smoke_notebooks_phase_runs_on_the_cpu(capsys):
    """Phase 35 at `build_notebooks.TINY`'s sizes on the CPU, through
    ``run_cells --device cpu --tiny`` as a subprocess: both notebooks, every
    check passed, the steps their sizes give, no K1 launch (the CPU's plain
    window)."""
    import json

    import chip_smoke as cs
    from pvderx_torch.examples.notebooks import build_notebooks as bn

    books = cs.run_notebooks("cpu", "cpu", tiny=True)
    assert set(books) == {"standalone_simulation", "train_rl"}
    for name, b in books.items():
        assert b["checks"]["ok"] and b["k1_launches"] == 0
        assert b["env_steps"] == bn.env_steps(name, bn.TINY) > 0
    assert books["train_rl"]["checks"]["export_equal"]
    lines = [json.loads(ln[len("[notebooks] "):]) for ln in
             capsys.readouterr().out.splitlines()
             if ln.startswith("[notebooks] ")]
    assert [ln.get("notebook") for ln in lines] == [
        "standalone_simulation", "train_rl", None]
    assert lines[-1]["rc"] == 0


def test_torch_chip_smoke_run_cells_never_runs_a_plot_cell(monkeypatch,
                                                           capsys):
    """A notebook whose plot cell would raise: `run_cells` runs the compute
    cells around it and never that one."""
    from pvderx_torch.examples.notebooks import build_notebooks as bn
    from pvderx_torch.examples.notebooks import run_cells

    cells = lambda device, sizes: [
        bn.Cell("markdown", "# a title"),
        bn.Cell("code", "x = 1\n", ("compute",)),
        bn.Cell("code", "raise RuntimeError('a plot cell ran')\n", ("plot",)),
        bn.Cell("code", "y = x + 1\n", ("compute",))]
    monkeypatch.setitem(bn.NOTEBOOKS, "standalone_simulation",
                        (cells, lambda ns, sizes: {"ok": ns["y"] == 2}))
    out = run_cells.run_notebook("standalone_simulation", "cpu")
    assert "failed" not in out and out["checks"] == {"ok": True}
    assert [r["cell"] for r in out["cells"]] == [1, 3]
    assert run_cells.main(["--device", "cpu", "--notebook",
                           "standalone_simulation"]) == 0
    assert "a plot cell ran" not in capsys.readouterr().out


_NATIVE = "_ZN41_GLOBAL__N__3c9d0e1f_9_native_cu_5a6b7c8d"


def test_torch_chip_smoke_ptxas_summary_reads_the_native_kernels():
    """The build phase reports the float64 engine's kernels (N1-N4) under
    their short names, spills included (N2 and N3 keep their vectors and
    the Jacobian in local memory)."""
    report = (_entry(f"{_NATIVE}17native_rhs_kernelILi1EEEvPKdS2_S2_S2_Pdi",
                     90, 0, 0)
              + _entry(f"{_NATIVE}17native_rk4_kernelILi3EEEvPKdS2_S2_S2_Pdiiddd",
                       210, 0, 0)
              + _entry(f"{_NATIVE}18native_dp54_kernelILi3EEEvPKdS2_S2_S2_PdPiS4_iddd",
                       128, 64, 64)
              + _entry(f"{_NATIVE}20native_newton_kernelILi1EEEvPKdS2_S2_PdPiiid",
                       96, 8, 8))
    got = ptxas_summary(report)
    assert got == {
        "native_rhs_kernel<1>": dict(registers=90, spill_stores=0,
                                     spill_loads=0),
        "native_rk4_kernel<3>": dict(registers=210, spill_stores=0,
                                     spill_loads=0),
        "native_dp54_kernel<3>": dict(registers=128, spill_stores=64,
                                      spill_loads=64),
        "native_newton_kernel<1>": dict(registers=96, spill_stores=8,
                                        spill_loads=8)}
    assert kernel_name("native_dp54_kernel<3>") == "native_dp54_kernel<3>"


# phase 36 at tiny sizes (`run_native`'s ``sizes``)
NATIVE_TINY = dict(
    rhs=dict(n_states=3, n_timed=4),
    dp54=dict(presets=("10",), windows=6, n=4),
    newton=dict(n=4, reset_iters=4),
    drive=dict(trajectory_windows=3, batch_n=4))


def test_torch_chip_smoke_native_phase_runs_on_the_cpu(capsys):
    """Phase 36 on the CPU through the plain versions: every check passes
    (N4 and N1 against their plain versions and the oracle, N1 against the
    float64 RK4 window on two of phase 11's cases with K1 missing the
    bound, the batch bit for bit its one-env calls, N2 through the sag into
    its first two windows against LSODA, N3 against fsolve, the public
    path against LSODA), no kernel launches, and the kernels line's rows
    carry every key of the contract with their float64 bounds."""
    import json

    import chip_smoke as cs
    from pvderx_torch.diag import roofline

    sizes = dict(NATIVE_TINY, rk4=dict(n=6, n_sub=40, cases=cs.KERNEL_CASES[:2],
                                       f64_n=2, timed_n=4))
    out = cs.run_native("cpu", "cpu", sizes=sizes)
    lines = [json.loads(ln[len("[native] "):])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[native] ")]
    f64 = [ln for ln in lines if ln.get("case", "").startswith("f64_")]
    assert len(f64) == 2 and all(
        ln["max_abs_err"] <= cs.DF_F64_TOL < ln["k1_max_abs_err"]
        and ln["k3_max_abs_err"] <= cs.DF_F64_TOL for ln in f64)
    sag = next(ln for ln in lines if ln.get("case") == "sag_preset10")
    assert sag["steps"] == sag["plain_steps"] and max(sag["steps"]) > 100
    assert out["dp54"]["tries"] > 0 and out["newton"]["iterations"] > 0
    assert {k: v["launches"] for k, v in out.items()} == dict(
        rhs=0, rk4=0, dp54=0, newton=0)
    rows = cs.native_kernel_rows(out, roofline.H100, n=4)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [r["name"] for r in rows] == [
        "native_rhs", "native_rk4_window", "native_dp54_window",
        "native_newton_steady"]
    for r in rows:
        assert keys <= set(r) and r["route"] == "cuda"
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        path, line = r["replaces"].split(":")
        assert path == "pvderx/native/src/pvderx_native.cpp" and int(line) > 0


def test_torch_chip_smoke_autoreset_phase_runs_on_the_cpu(capsys,
                                                        monkeypatch):
    """Phase 37 on the CPU, where `restart_done` is the plain version: one
    line per (preset, dtype, N), every pattern of done envs bit for bit
    and the inputs untouched, the df32 tier's y_lo in float32 only, then
    the timed line's bytes bound; a restart that differs from the plain
    version in one bit, or that writes its input, fails the phase."""
    import json

    import torch

    import chip_smoke as cs
    from pvderx_torch.env import core

    out = cs.check_autoreset("cpu", sizes=(5,), timed_n=10)
    lines = [json.loads(ln[len("[autoreset] "):])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[autoreset] ")]
    assert [(ln["preset"], ln["dtype"], ln["calls"]) for ln in lines[:4]] == [
        ("10", "float32", 8), ("10", "float64", 4), ("50", "float32", 8),
        ("50", "float64", 4)]
    assert all(ln["bitwise"] and ln["inputs_unchanged"]
               and ln["restarted"]["all"] == 5 and ln["restarted"]["one"] == 1
               for ln in lines[:4])
    assert out["cases"] == 24 and out["kernel_ms"] is None
    assert lines[4]["bytes"] == 10 * (1 + 2 * 79 * 4)
    restart = core.restart_done

    def flipped(cfg, done, stepped, uv, y_lo=None):
        st, obs, lo = restart(cfg, done, stepped, uv, y_lo)
        return st, -obs, lo

    monkeypatch.setattr(core, "restart_done", flipped)
    with pytest.raises(AssertionError, match="not bitwise equal"):
        cs.check_autoreset("cpu", presets=("10",), dtypes=(torch.float64,),
                           sizes=(5,), timed_n=None)

    def writes(cfg, done, stepped, uv, y_lo=None):
        out = restart(cfg, done, stepped, uv, y_lo)
        stepped[0].rt.timers.add_(1.0)
        return out

    monkeypatch.setattr(core, "restart_done", writes)
    with pytest.raises(AssertionError, match="wrote its inputs"):
        cs.check_autoreset("cpu", presets=("10",), dtypes=(torch.float64,),
                           sizes=(5,), timed_n=None)


def test_torch_chip_smoke_post_window_phase_runs_on_the_cpu(capsys,
                                                          monkeypatch):
    """Phase 38 on the CPU, where `_post_window` is the plain version: one
    line per (preset, dtype, N), four calls each (the anomaly reward and the
    ride-through on and off), bit for bit and the inputs untouched, then
    the timed line's bytes bound; a step that differs from the plain
    version in one bit, or that writes its input, fails the phase."""
    import json

    import torch

    import chip_smoke as cs
    from pvderx_torch.env import core

    out = cs.check_post_window("cpu", sizes=(5,), timed_n=10)
    lines = [json.loads(ln[len("[post_window] "):])
             for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[post_window] ")]
    assert [(ln["preset"], ln["dtype"], ln["held"]) for ln in lines[:4]] == [
        ("10", "float32", "bitwise"), ("10", "float64", "bitwise"),
        ("50", "float32", "tol"), ("50", "float64", "tol")]
    assert all(ln["calls"] == ln["bitwise_calls"] == 4
               and ln["inputs_unchanged"] and ln["zones"][1::2] == [0, 0]
               for ln in lines[:4])
    assert out["cases"] == 16 and out["kernel_ms"] is None
    assert lines[4]["bytes"] == 10 * 295
    post_window = core._post_window

    def flipped(*args):
        st, obs, reward, done, info = post_window(*args)
        return st, obs, reward, done, {**info, "p_pv": -info["p_pv"]}

    monkeypatch.setattr(core, "_post_window", flipped)
    with pytest.raises(AssertionError, match="not bitwise equal"):
        cs.check_post_window("cpu", presets=("10",), dtypes=(torch.float32,),
                             sizes=(5,), timed_n=None)

    def writes(*args):
        out = post_window(*args)
        args[1].rt.timers.add_(1.0)
        return out

    monkeypatch.setattr(core, "_post_window", writes)
    with pytest.raises(AssertionError, match="wrote its inputs"):
        cs.check_post_window("cpu", presets=("50",), dtypes=(torch.float64,),
                             sizes=(5,), timed_n=None)


def test_torch_chip_smoke_native_warp_efficiency():
    from chip_smoke import _warp_efficiency

    assert _warp_efficiency(np.full(64, 7)) == 1.0
    tries = np.array([10] + [1] * 31 + [2] * 5)     # a warp and a ragged one
    assert _warp_efficiency(tries) == pytest.approx(51 / (32 * (10 + 2)))
