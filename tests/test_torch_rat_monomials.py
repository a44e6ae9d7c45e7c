"""Parity of the port's rational monomials NDRAT and RAT with the JAX reference
(tmlqcd_tpu), on the CPU: heatbath, action and force.  The cases, their
inputs and their tolerances are in tests/rat_monomial_cases.py; test_torch_rat_clover.py runs
them for NDCLOVERRAT, so that the test runner's workers share the reference's
compile time.
"""

import jax
import pytest
import torch

from rat_monomial_cases import (  # noqa: F401  (fixtures and tests, collected here)
    gauge,
    ported,
    reference,
    test_rational_action_matches_reference,
    test_rational_force_matches_finite_difference_of_the_action,
    test_rational_force_matches_reference,
    test_rational_heatbath_matches_reference,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _quick_reference_compiles():
    """XLA's backend optimisations off while this module runs: the
    reference's programs here take far longer to compile than to run."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module", params=["ndrat", "rat"])
def name(request):
    return request.param
