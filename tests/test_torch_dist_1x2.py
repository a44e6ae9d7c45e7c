"""The checks of tests/test_torch_dist.py on its third mesh shape, (1, 2):
the rank slabs, the sharded hop and K2-S on one spawn of `_rank_checks`,
against the port in one process.  The test functions, their bounds and the
fields are those of tests/test_torch_dist.py, imported from there and
collected here on the (1, 2) ranks: this spawn has 6 users, so it runs in
a file of at most 8 tests, which the test runner queues behind
tests/test_multirhs.py.  Port only: the ranks and this file import no JAX.
"""

import pytest

from test_torch_dist import (  # noqa: F401  (the fixture and the tests, collected here)
    _run,
    test_k2s_plain_equals_whole_lattice_k2,
    test_rank_hop_equals_one_process_mesh_and_whole_lattice,
    test_rank_slabs_coordinates_and_lattices,
    whole,
)


@pytest.fixture(scope="module", params=[(1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request, tmp_path_factory):
    return request.param, _run(request.param, tmp_path_factory)
