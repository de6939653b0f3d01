"""pvderx_torch — the PV-DER RL environment engine in PyTorch for NVIDIA Hopper.

A second package beside `pvderx` (JAX): the same physics, scenarios and
batched environment, with the RK4 control window as a hand-written CUDA
kernel (`pvderx_torch/ops/csrc/window.cu`). Entry points take ``device=`` and
default to ``"cuda"``; pass ``device="cpu"`` to run the plain torch versions.

    from pvderx_torch.env import make_env_config, make_batch_fns, rollout
    cfg = make_env_config("10", n_sub=64, device="cuda")
    reset_batch, step_batch = make_batch_fns(cfg)
"""
from pvderx_torch.params import DERParams, Exog, make_params, nominal_exog

__all__ = ["DERParams", "Exog", "make_params", "nominal_exog"]
