from pvderx_torch.ode.implicit import (
    backward_euler_window, rhs_and_jacobian, trapezoid_window)
from pvderx_torch.ode.newton import newton_solve
from pvderx_torch.ode.rk4 import kahan_add, rk4_delta, rk4_step, rk4_window

__all__ = ["newton_solve", "kahan_add", "rk4_delta", "rk4_step",
           "rk4_window", "trapezoid_window", "backward_euler_window",
           "rhs_and_jacobian"]
