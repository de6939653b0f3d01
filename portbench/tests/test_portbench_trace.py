"""The trace arithmetic on a synthetic chrome trace: the window span, busy
time as the union of device activity, idle share, kernel launches, device-
to-host copy time and idle gaps named by the host's operation."""
import pytest

from portbench import trace


def ev(name, cat, ts, dur, **kw):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **kw}


EVENTS = [
    ev(trace.WINDOW_SPAN, "user_annotation", 1000.0, 1000.0),
    ev(trace.WINDOW_SPAN, "gpu_user_annotation", 1100.0, 900.0),
    ev("window_kernel<1>", "kernel", 1100.0, 100.0),
    ev("add_kernel", "kernel", 1150.0, 100.0),          # overlaps: union
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 1400.0, 50.0),
    ev("early_kernel", "kernel", 900.0, 150.0),          # clipped to 1000
    ev("late_kernel", "kernel", 1950.0, 100.0),          # clipped to 2000
    ev("cudaLaunchKernel", "cuda_runtime", 1010.0, 5.0),
    ev("cudaLaunchKernel", "cuda_runtime", 1500.0, 5.0),
    ev("cuLaunchKernelEx", "cuda_runtime", 1600.0, 5.0),
    ev("cudaLaunchKernel", "cuda_runtime", 2500.0, 5.0),  # outside
    ev("cudaMemcpyAsync", "cuda_runtime", 1390.0, 70.0),
    ev("aten::mul", "cpu_op", 1260.0, 100.0),
    ev("aten::copy_", "cpu_op", 1450.0, 500.0),
]


def test_portbench_trace_summary_of_a_synthetic_trace():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1e-3)
    # [1000, 1050] + [1100, 1250] + [1400, 1450] + [1950, 2000]
    assert s["busy_s"] == pytest.approx(300e-6)
    assert 100 * (1 - s["busy_s"] / s["window_s"]) == pytest.approx(70.0)
    assert s["launches"] == 3
    assert s["d2h_s"] == pytest.approx(50e-6)
    assert s["kernels"]["window_kernel<1>"] == [pytest.approx(100e-6), 1]
    gaps = dict(s["idle_gaps"])
    # gaps [1050, 1100] (no op), [1250, 1400] (mul), [1450, 1950] (copy_)
    assert gaps["host: no operation"] == pytest.approx(50e-6)
    assert gaps["aten::mul"] == pytest.approx(150e-6)
    assert gaps["aten::copy_"] == pytest.approx(500e-6)
    assert s["device_ops"][0][0] == "window_kernel<1>"


def test_portbench_trace_without_its_window_span_raises():
    with pytest.raises(ValueError):
        trace.summarize(EVENTS[2:])
