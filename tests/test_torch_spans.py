"""The spans of the port's env step (`pvderx_torch.diag.profiler.span`), on
the CPU.

- With no profiler recording, a rollout records nothing and never enters
  `torch.profiler.record_function`.
- Under a CPU `torch.profiler`, a 3-step rollout of 8 envs records one
  ``rollout``, three ``rollout.policy`` and ``env.step`` spans, each step's
  four phases under it, and one ``rollout.stack``; the chrome trace holds
  the same names as nested ``user_annotation`` events.
- `rollout`, `rollout_df` and `fleet_rollout` give the same outputs bit
  for bit with the profiler on and off.
- The recorder keeps at most `MAX_RECORDS` records, counts the rest, and
  `clear` forgets them.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pvderx_torch.diag import profiler
from pvderx_torch.env import (
    fleet_rollout, make_batch_fns, make_batch_fns_df, make_env_config,
    make_fleet_batch_fns, make_fleet_config, rollout, rollout_df)

PHASES = ("env.pre_window", "env.window", "env.post_window",
          "env.autoreset")
NAMES = {"rollout", "rollout.policy", "rollout.stack", "env.step", *PHASES}


def policy(obs, generator):
    return torch.randint(0, 5, (obs.shape[0],), generator=generator)


def run(path, n_envs, n_steps):
    """A rollout of ``path`` from a seeded reset; the state, obs, rewards
    and dones as a flat list of tensors."""
    kw = dict(dtype=torch.float32, n_sub=40, device="cpu")
    if path == "fleet":
        cfg = make_fleet_config("10", m=2, **kw)
        reset, roll = make_fleet_batch_fns(cfg)[0], fleet_rollout
    elif path == "df":
        cfg = make_env_config("10", **kw)
        reset, roll = make_batch_fns_df(cfg)[0], rollout_df
    else:
        cfg = make_env_config("10", **kw)
        reset, roll = make_batch_fns(cfg)[0], rollout
    gen = torch.Generator().manual_seed(7)
    state, obs = reset(n_envs, gen)
    out = roll(cfg, state, obs, policy, n_steps, gen)
    leaves = []

    def flat(x):
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, (tuple, list)):
            for v in x:
                flat(v)
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                flat(getattr(x, f))

    flat(out)
    return leaves


@pytest.fixture(autouse=True)
def _fresh_recorder():
    profiler.clear()
    yield
    profiler.clear()


def test_torch_span_without_a_profiler_records_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiler.span("env.step") is profiler.span("rollout")
    run("single", 4, 2)
    assert profiler.records() == [] and profiler.dropped() == 0


def test_torch_span_rollout_records_each_phase_under_its_step(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run("single", 8, 3)
    recs = profiler.records()
    names = [r["name"] for r in recs]
    assert set(names) == NAMES
    assert names.count("rollout") == names.count("rollout.stack") == 1
    assert names.count("rollout.policy") == names.count("env.step") == 3
    top = names.index("rollout")
    assert recs[top]["parent"] is None
    steps = [i for i, n in enumerate(names) if n == "env.step"]
    for i, r in enumerate(recs):
        if r["name"] in ("rollout.policy", "rollout.stack", "env.step"):
            assert r["parent"] == top, r
        elif r["name"] in PHASES:
            assert r["parent"] in steps, r
    for s in steps:
        assert sorted(r["name"] for r in recs if r["parent"] == s) == sorted(
            PHASES)
    for r in recs:
        # on the host the device time is the host time, and nothing drains
        assert r["device_ms"] == r["host_ms"] > 0 and r["drained"] is None

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("cat") == "user_annotation" and e.get("name") in NAMES]
    assert sorted(e["name"] for e in ev) == sorted(names)

    def inside(a, b):
        return b["ts"] <= a["ts"] and a["ts"] + a["dur"] <= b["ts"] + b["dur"]

    roll = next(e for e in ev if e["name"] == "rollout")
    step_ev = [e for e in ev if e["name"] == "env.step"]
    for e in ev:
        if e is not roll:
            assert inside(e, roll), e["name"]
        if e["name"] in PHASES:
            assert any(inside(e, s) for s in step_ev), e["name"]


# the df32 window's plain version takes seconds a step on the CPU
@pytest.mark.parametrize("path, n_steps", [("single", 2), ("df", 1),
                                           ("fleet", 2)])
def test_torch_span_outputs_bitwise_with_the_profiler_on_and_off(path,
                                                                 n_steps):
    off = run(path, 4, n_steps)
    assert profiler.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = run(path, 4, n_steps)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    names = [r["name"] for r in profiler.records()]
    assert set(names) == NAMES and names.count("env.step") == n_steps


def test_torch_span_record_cap_and_clear(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_RECORDS", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("rollout"):
            for _ in range(4):
                with profiler.span("env.step"):
                    pass
    recs = profiler.records()
    assert [r["name"] for r in recs] == ["rollout", "env.step", "env.step"]
    assert [r["parent"] for r in recs] == [None, 0, 0]
    assert profiler.dropped() == 2
    profiler.clear()
    assert profiler.records() == [] and profiler.dropped() == 0
    # after the profiler stops, spans are null again
    with profiler.span("env.step"):
        pass
    assert profiler.records() == []


def test_torch_span_profile_torch_step_reads_the_second_rollout(monkeypatch):
    """`profile_torch_step.traced_spans` reports the device ms per step of
    each span under the second traced rollout (the first one, in which the
    profiler comes up, left out)."""
    import profile_torch_step as pts

    monkeypatch.setattr(pts, "STEPS", 2)
    cfg = make_env_config("10", dtype=torch.float32, n_sub=40, device="cpu")
    gen = torch.Generator().manual_seed(3)
    state, obs = make_batch_fns(cfg)[0](4, gen)
    out = pts.traced_spans(rollout, cfg, state, obs, policy, gen)
    recs = profiler.records()
    second = [i for i, r in enumerate(recs) if r["name"] == "rollout"][1]
    want = {}
    for r in recs[second + 1:]:
        want[r["name"]] = want.get(r["name"], 0.0) + r["device_ms"] / 2
    want["rollout"] = recs[second]["device_ms"] / 2
    assert out["span_device_ms_per_step"] == pytest.approx(want)
    assert set(want) == NAMES
    assert out["drained_step_share"] == 0.0 and out["top_kernels"]
