"""The checks of tests/test_torch_dist_meas.py on the (2, 2) mesh: the
sources, the runner's files, the gauge observables, the flow, the
Schrödinger functional and NDPOLY's action and force on one spawn of
`_rank_measure` (2 x 2 ranks at 8 x 4^3), and NDPOLY's heatbath, against the
port in one process.  The checks, their bounds and the fields are those of
tests/test_torch_dist_meas.py, imported from there and collected here on
the (2, 2) ranks: this spawn has 8 users, so it runs in a file of at most 8
tests, which the test runner queues behind tests/test_multirhs.py.  Port
only: the ranks and this file import no JAX.
"""

import numpy as np
import pytest

from dist_ranks import join
from test_torch_dist_meas import (  # noqa: F401  (the tests, collected here)
    _group,
    _pair,
    test_flow_bit_for_bit,
    test_gauge_observables_match_one_process,
    test_ndpoly_action_and_force_on_ranks,
    test_runner_files_from_rank_zero_equal_one_process,
    test_sf_action_slope_force_and_mask_on_ranks,
    test_sources_do_not_depend_on_the_decomposition,
)


@pytest.fixture(scope="module", params=[(2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def pair(request, tmp_path_factory):
    return _pair(request.param, tmp_path_factory)


def test_ndpoly_heatbath_on_ranks(tmp_path_factory):
    """The NDPOLY heatbath (CG on P^2) on the (2, 2) ranks' sharded doublet
    operators against one process on the one-process (2, 2) mesh: as many
    CG iterations, S_0 = |eta|^2 to 1e-12, phi to 1e-6 of max|phi|."""
    shape = (2, 2)
    ranks, one, _ = _group(shape, tmp_path_factory)
    phi, s0, iters = one["heatbath"]
    got = [r["heatbath"] for r in ranks]
    assert all(g[2] == iters for g in got) and 0 < iters < 500
    assert all(abs(g[1] - s0) <= 1e-12 * s0 for g in got)
    assert np.max(np.abs(join([g[0] for g in got], shape) - phi)) <= 1e-6 * np.max(np.abs(phi))
