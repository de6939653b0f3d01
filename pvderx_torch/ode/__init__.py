from pvderx_torch.ode.newton import newton_solve
from pvderx_torch.ode.rk4 import kahan_add, rk4_delta, rk4_window

__all__ = ["newton_solve", "kahan_add", "rk4_delta", "rk4_window"]
