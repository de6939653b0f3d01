"""The frozen reference against the program's CPU path at a tiny size: the
reset from the same uniforms (event tables equal, steady state and first
observation to float32 rounding), and steps from the program's state."""
import json

import numpy as np
import pytest
import torch

from conftest import ROOT

from portbench.drivers import common
from portbench.reference import env as renv
from portbench.reference.xp import NumpyXP


def setup(name, n):
    config = json.loads((ROOT / f"portbench/configs/{name}.json")
                        .read_text())
    return config, renv.make_spec(config), common.program_config(config,
                                                                  "cpu")


@pytest.mark.parametrize("n", [1, 5])
def test_portbench_reference_follows_the_program_on_the_cpu(n):
    from pvderx_torch.env import core

    config, spec, cfg = setup("der10_1ph", n)
    gen = torch.Generator().manual_seed(31)
    start = gen.get_state()
    st, obs = core.reset(cfg, n, gen)
    replay = common.generator_at(start, "cpu")
    widths = {"base": 2, "jit": 2, "ev": 14}
    draws = {k: torch.rand((n, w), generator=replay).numpy()
             for k, w in widths.items()}
    ref, ref_obs0, res = renv.reset(spec, draws)
    assert np.all(res < 1e-10)
    for k in ("solar", "grid", "load"):
        assert common.max_abs(getattr(st.sched, k).numpy(), ref[k]) == 0.0
    assert common.max_abs(st.y0.double().numpy(), ref["y0"]) < 1e-6
    assert common.max_abs(obs.double().numpy(), ref_obs0) < 1e-6

    idx = torch.arange(n)
    fields = ("y", "t_step", "vdc_ref", "q_ref", "timers", "tripped", "ces",
              "solar", "grid", "load", "y0", "obs0", "s0", "tc0")
    fx, cx = NumpyXP(np.float64), renv.clock_namespace(spec)
    rng = np.random.default_rng(3)
    for _ in range(3):
        a = torch.as_tensor(rng.integers(0, 5, n))
        before = renv.convert(common.to_reference(
            common.state_rows(st, idx, fields)), fx, cx)
        g_state = gen.get_state()
        st, obs, rew, done, _ = core.step_autoreset(cfg, st, a, gen)
        uv = torch.rand((n, 14), generator=common.generator_at(
            g_state, "cpu")).numpy()
        r_st, r_obs, r_rew, r_done, _ = renv.step(spec, fx, cx, before,
                                                  a.numpy(), uv)
        assert common.max_abs(obs.double().numpy(), r_obs) < 1e-5
        assert common.max_abs(rew.double().numpy(), r_rew) < 1e-5
        assert common.max_abs(st.y.double().numpy(), r_st["y"]) < 1e-5
        assert np.array_equal(done.numpy(), r_done)


def test_portbench_reference_clock_follows_the_configurations_dtype():
    # 60 sums of 1/60 pass the LV2 limit of 1.0 s at the 61st in float32
    _, spec, _ = setup("der10_1ph", 1)
    cx = renv.clock_namespace(spec)
    timers, tripped = cx.zeros((1, 6)), cx.zeros(1)
    steps = 0
    while not tripped[0]:
        timers, tripped, _ = renv.rt_update(spec, cx, timers, tripped,
                                            np.array([0.4]), np.array([1.0]))
        steps += 1
    assert steps == 61
