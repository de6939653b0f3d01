"""`chip_smoke.py`'s distributed phases (29-34, `run_dist`) at tiny sizes on
the CPU: world 1 in this process on gloo, world 2 and world 4 as gloo ranks
(`python -m pvderx_torch.dist.launch --cpu`, each `python -m chip_smoke
--dist-worker`), the three training examples as 2 ranks each. Every check
of the phases runs as on the card (the bitwise env legs, world 2 against
world 1, TP against DP-only, both checkpoint cases), except the launch
counts, which the CPU's plain windows do not make; `dist_launches` gives
the kernels line's entries.
"""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

TINY = dict(chip_smoke.DIST, n_envs=8, steps=6, short=2, fleet_envs=4, m=3,
            n_sub=40, ppo_envs=8, off_envs=8, hidden=[32, 32], ppo=[2, 1, 2],
            off=[2, 1, 8, 64], timed=1, off_timed=1, fleet_timed=1,
            tp_timed=1,
            examples=[["train_ppo", ["--tp", "2", "--n-envs", "4",
                                     "--updates", "1"], 16],
                      ["train_dqn", ["--n-envs", "4", "--updates", "1"], 8],
                      ["train_sac", ["--n-envs", "4", "--updates", "1"], 8]])


def test_torch_chip_smoke_dist_phases_run_on_the_cpu(capsys):
    out = chip_smoke.run_dist("cpu", "cpu", TINY, timeout=300)
    printed = capsys.readouterr().out
    for name in ("dist_env", "dist_ppo", "dist_offpolicy", "dist_tp",
                 "dist_checkpoint", "dist_examples"):
        assert f"[{name}] " in printed, name
    assert '"backend": "gloo", "world": 2' in printed
    assert all('"backend": "gloo", "world": ' in ln for ln in
               printed.splitlines() if ln.startswith(("[dist_env]",
                                                      "[dist_tp]",
                                                      "[dist_examples]")))
    assert all(g["bitwise"] == dict.fromkeys(("obs", "rews", "dones", "y"),
                                             True)
               for kind in ("env", "fleet", "df32") for g in out["r2"][kind])
    assert [g["mesh"] for g in out["r4"]["tp22"]] == [[2, 2]] * 4
    launches = chip_smoke.dist_launches(out)
    assert launches["k1"]["dist_env_w2"] == [0, 0]        # the CPU's plain
    assert set(launches) == {"k1", "k2", "k3"}
    assert out["seconds"]["total_s"] > 0
