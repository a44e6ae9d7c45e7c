"""The checks of tests/test_torch_dist_meas.py on the (1, 2) mesh: the
sources, the runner's files, the gauge observables, the flow, the
Schrödinger functional and NDPOLY's action and force on one spawn of
`_rank_measure` (1 x 2 ranks at 8 x 4^3), against the port in one process.
The checks, their bounds and the fields are those of
tests/test_torch_dist_meas.py, imported from there and collected here on
the (1, 2) ranks: this spawn has 7 users, so it runs in a file of at most 8
tests, which the test runner queues behind tests/test_multirhs.py.  Port
only: the ranks and this file import no JAX.
"""

import pytest

from test_torch_dist_meas import (  # noqa: F401  (the tests, collected here)
    _pair,
    test_flow_bit_for_bit,
    test_gauge_observables_match_one_process,
    test_ndpoly_action_and_force_on_ranks,
    test_runner_files_from_rank_zero_equal_one_process,
    test_sf_action_slope_force_and_mask_on_ranks,
    test_sources_do_not_depend_on_the_decomposition,
)


@pytest.fixture(scope="module", params=[(1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory)
