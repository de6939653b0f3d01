"""The chip scripts' report parsers, on canned compiler output (no nvcc).

- `chip_smoke.ptxas_summary` reads registers and spill bytes for every
  window kernel of an `nvcc -Xptxas -v` report: K1 (`window_kernel<N>`), K2
  (`fleet_window_kernel<N,THREADS>`) and K3 (`window_df_kernel<N>`: one
  lane per env at N = 1, a two-lane team at N = 3), so the build phase
  keeps reporting the three-phase df32 kernel's spills.
- `profile_torch_step.sass_loops` finds, in a `cuobjdump -sass` listing, the
  substep loop (the largest backward branch) and the stage loop inside it,
  and estimates the instructions one substep runs.
"""
from chip_smoke import kernel_name, ptxas_summary
from profile_torch_step import sass_loops

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
