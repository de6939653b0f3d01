"""The harness finds configurations, cells, traffic, limits and metric
readers by name, and a cell and a metric added as files (and entries of
BENCHMARK.json) run without an edit to any file already there."""
import hashlib
import importlib
import json
import shutil

from conftest import ROOT

from portbench import harness


def bench():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_portbench_every_name_resolves_to_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = harness.Cell(b, w["name"], 1, 1.0, False, device="cpu")
        assert cell.config["name"] == w["config"]
        importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
        assert cell.limits, w["name"]
    for m in b["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    # a metric split by the rate it moves is read by the reader of its
    # part before the first dot
    for name in ("device_idle_pct.rollout", "device_idle_pct.train"):
        path = harness.load_reader(name).__code__.co_filename
        assert path.endswith("metrics/device_idle_pct.py")
    names = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", names)) <= names


def test_portbench_each_cell_reports_setup_another_e2e_and_a_layer():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(b, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(b, w["name"], True)


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_portbench_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path)
    b = bench()
    traffic = json.loads((tmp_path / "portbench/traffic/rollout_uniform5.json")
                         .read_text())
    traffic.update(check_chunks=2, n_envs=1024)
    (tmp_path / "portbench/traffic/rollout_small.json").write_text(
        json.dumps(traffic))
    (tmp_path / "portbench/limits/der10_small.json").write_text(
        (tmp_path / "portbench/limits/der10_rollout.json").read_text())
    (tmp_path / "portbench/metrics/chunks_checked.py").write_text(
        "def read(run):\n    return float(run.cell.traffic['check_chunks'])\n")
    b["workloads"].append({"name": "der10_small", "config": "der10_1ph",
                           "traffic": "rollout_small", "chips": 1,
                           "why": "a test cell"})
    b["end_to_end"][0]["workloads"].append("der10_small")
    b["per_layer"].append({"name": "chunks_checked", "unit": "chunks",
                           "better": "higher", "source": "program_counter",
                           "layer": "env glue", "moves": "env_steps_per_s",
                           "workloads": ["der10_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = harness.Cell(b, "der10_small", 5, 1.0, True, device="cpu",
                        root=tmp_path)
    assert cell.n_envs == 1024 and cell.traffic["driver"] == "rollout"
    names = [m["name"] for m in harness.cell_metrics(b, "der10_small", True)]
    assert names == ["chunks_checked"]
    run = harness.Run(cell, None, {}, 0)
    assert harness.load_reader("chunks_checked", tmp_path)(run) == 2.0
    after = _digest(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
