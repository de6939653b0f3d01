from pvderx_torch.sim.dynamic import DynamicSimulation, init_from_schedule, simulate

__all__ = ["DynamicSimulation", "simulate", "init_from_schedule"]
