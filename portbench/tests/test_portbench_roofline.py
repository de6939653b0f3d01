"""The frozen roofline count at the cells' shapes: the reference's
operations per env-substep under the copied dispatch counter, and the
bytes and least time of one window launch at the cell's envs (32768 in
der10_rollout) and at a larger batch."""
import json

import pytest

from conftest import ROOT

from portbench.reference import roofline


def config(name):
    return json.loads((ROOT / f"portbench/configs/{name}.json").read_text())


def test_portbench_substep_count_of_one_der_is_the_reference_programs():
    # 923: the count of the JAX package's jaxpr counter for this substep,
    # which the port's own counter reproduces (PERF.md §6)
    c = config("der10_1ph")
    assert roofline.substep_ops(json.dumps(c, sort_keys=True)) == 923


@pytest.mark.parametrize("n", [32768, 262144])
def test_portbench_window_bound_at_the_cells_shapes(n):
    ops, n_bytes = 923 * 64 * n, 4 * n * (1 + 22 + 29 + 15)
    bound_ms = ops / 67e12 * 1e3
    b = roofline.window_bound(config("der10_1ph"), n)
    assert b["ops"] == ops and b["bytes"] == n_bytes
    assert b["bound_ms"] == pytest.approx(bound_ms)
    assert b["bound_by"] == "operations"
