from pvderx_torch.utils.logging import get_logger, set_verbosity
from pvderx_torch.utils.printing import show_states
from pvderx_torch.utils.transforms import (
    abc_to_dq0, dq0_to_abc, phasor_to_rms, rms_to_phasor,
    sequence_components, sequence_to_phase)

__all__ = [
    "get_logger", "set_verbosity", "show_states",
    "abc_to_dq0", "dq0_to_abc", "phasor_to_rms", "rms_to_phasor",
    "sequence_components", "sequence_to_phase",
]
