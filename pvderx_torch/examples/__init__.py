"""Runnable examples, the twins of the reference's `examples/*.py`:

    python -m pvderx_torch.examples.standalone_simulation [--preset 50] [--tstop 20]
    python -m pvderx_torch.examples.gym_rollout [--steps 120] [--continuous]
    python -m pvderx_torch.examples.fleet_simulation --m 16 --n-envs 64 --steps 120
    python -m pvderx_torch.examples.gain_tuning --iters 40

Each runs on the card; ``--cpu`` runs it on the CPU (the plain windows).
Each module's ``main(argv)`` takes the same flags. The demo notebooks are
in `pvderx_torch.examples.notebooks`.
"""
