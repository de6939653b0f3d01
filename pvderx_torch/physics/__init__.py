from pvderx_torch.physics import rhs_core
from pvderx_torch.physics.xp import TorchXP, like

__all__ = ["rhs_core", "TorchXP", "like"]
