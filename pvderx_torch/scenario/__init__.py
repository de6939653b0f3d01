from pvderx_torch.scenario.events import (
    EventBuilder, EventSchedule, active_row, make_exog)
from pvderx_torch.scenario.mppt_voltvar import (
    MPPTState, mppt_init, mppt_update, voltvar_qref)
from pvderx_torch.scenario.ride_through import (
    RideThroughParams, RideThroughState, default_rt_params, rt_init, rt_update)

__all__ = [
    "EventBuilder", "EventSchedule", "active_row", "make_exog",
    "MPPTState", "mppt_init", "mppt_update", "voltvar_qref",
    "RideThroughParams", "RideThroughState", "default_rt_params", "rt_init",
    "rt_update",
]
