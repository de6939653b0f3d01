from pvderx_torch.diag.metrics import MetricsLogger
from pvderx_torch.diag.plots import SimulationResults

__all__ = ["SimulationResults", "MetricsLogger"]
