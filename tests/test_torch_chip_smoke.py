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
"""
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
