"""The readers of the program's spans (`portbench.spans` and the five
metrics on it): on synthetic record lists, on a program without the
recorder, and in a tiny traced run of der10_rollout on the CPU."""
import time

import pytest

from conftest import tiny_cell

from portbench import harness, spans

READERS = ("pre_window_ms", "window_ms", "post_window_ms", "autoreset_ms",
           "queue_drained_pct")
PHASES = ("env.pre_window", "env.window", "env.post_window",
          "env.autoreset")


def rollout(recs, steps, base_ms=1.0, drained=()):
    """Append one ``rollout`` span of ``steps`` env steps to ``recs``:
    phase i of step k reads ``base_ms * (i + 1) + k`` device ms; the steps
    whose number is in ``drained`` were entered with the device drained."""
    r0 = len(recs)
    recs.append(dict(name="rollout", parent=None, host_ms=1.0,
                     device_ms=1.0, drained=None))
    for k in range(steps):
        recs.append(dict(name="rollout.policy", parent=r0, host_ms=0.1,
                         device_ms=0.1, drained=None))
        s = len(recs)
        recs.append(dict(name="env.step", parent=r0, host_ms=1.0,
                         device_ms=10.0, drained=k in drained))
        for i, name in enumerate(PHASES):
            recs.append(dict(name=name, parent=s, host_ms=0.5,
                             device_ms=base_ms * (i + 1) + k, drained=None))
    recs.append(dict(name="rollout.stack", parent=r0, host_ms=0.1,
                     device_ms=0.2, drained=None))
    return recs


def test_portbench_spans_drop_the_first_rollout():
    recs = rollout([], 2, base_ms=100.0, drained=(0, 1))
    rollout(recs, 3, drained=(1,))
    kept = spans.kept(recs)
    assert [r["name"] for _, r in kept].count("rollout") == 1
    assert min(i for i, _ in kept) == 14    # the first rollout's 14 records
    assert len(spans.steps(recs)) == 3
    # medians over the second rollout's steps: base (i + 1) + 0, 1, 2
    for i, name in enumerate(PHASES):
        assert spans.phase_ms(recs, name) == pytest.approx(i + 2.0)
    assert spans.drained_pct(recs) == pytest.approx(100.0 / 3)


def test_portbench_spans_read_nothing_without_a_kept_step():
    assert spans.phase_ms(None, "env.window") is None
    assert spans.drained_pct(None) is None
    assert spans.phase_ms([], "env.window") is None
    one = rollout([], 2)
    assert spans.phase_ms(one, "env.window") is None
    assert spans.drained_pct(one) is None
    # a phase that no kept step holds
    assert spans.phase_ms(rollout(one, 1), "env.other") is None


@pytest.mark.parametrize("name", READERS)
def test_portbench_span_reader_reads_the_programs_records(monkeypatch, name):
    from pvderx_torch.diag import profiler

    recs = rollout([], 1)
    rollout(recs, 3, base_ms=2.0, drained=(0, 1, 2))
    monkeypatch.setattr(profiler, "records", lambda: recs)
    want = {"pre_window_ms": 3.0, "window_ms": 5.0, "post_window_ms": 7.0,
            "autoreset_ms": 9.0, "queue_drained_pct": 100.0}[name]
    assert harness.load_reader(name)(None) == pytest.approx(want)
    # a program without the recorder reads nothing, and does not raise
    monkeypatch.delattr(profiler, "records")
    assert harness.load_reader(name)(None) is None


def test_portbench_tiny_traced_rollout_reports_the_span_metrics():
    from pvderx_torch.diag import profiler

    profiler.clear()
    cell = tiny_cell("der10_rollout", seconds=3.0, trace=True)
    result, _, _ = harness.run_cell(cell, time.perf_counter(),
                                    require_device=False)
    profiler.clear()
    assert result["correct"] is True, result["checks"]
    got = result["metrics"]
    for name in READERS[:4]:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms/step"
    # on the host nothing drains
    assert got["queue_drained_pct"] == {"value": 0.0, "unit": "%"}
