"""Mean ms of the public `update` call over the window's PPO train steps
after the traced ones, host clock between device syncs (the traced run
only)."""


def read(run):
    return run.layer.get("ppo_update_ms")
