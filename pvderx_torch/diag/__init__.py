from pvderx_torch.diag.metrics import MetricsLogger
from pvderx_torch.diag.plots import SimulationResults
from pvderx_torch.diag.profiler import (
    Stopwatch, compile_report, device_op_summary, trace)

__all__ = ["SimulationResults", "MetricsLogger", "Stopwatch",
           "compile_report", "device_op_summary", "trace"]
