"""The port's single-DER env against the independent supervisory oracle:
Volt-VAR, MPPT, anomaly detection, three-phase and the unbalanced sag (the
cases of tests/test_supervisory_oracle.py:83-125), as
`tests/test_torch_supervisory_oracle.py` runs its cases.
"""
import pytest

from test_torch_supervisory_oracle import check_case


@pytest.mark.parametrize("case", ["voltvar", "mppt", "anomaly", "three_phase",
                                  "unbalanced_sag"])
def test_torch_env_feature_episode_matches_independent_oracle(case):
    check_case(case)
