"""Hand-written CUDA kernels of the port, each beside its plain torch version."""
from pvderx_torch.ops.window import (
    pack_struct, rk4_window_batch, unpack_struct)

__all__ = ["rk4_window_batch", "pack_struct", "unpack_struct"]
