"""The benchmark of `pvderx_torch` on one NVIDIA H100 (see `run.py`)."""
