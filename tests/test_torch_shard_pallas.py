"""The port's sharded hop (`dslash_cuda.hopping_shard`) against the JAX
reference's `hopping_pallas_shard` in interpret mode on its 8-device rig:
mesh (2,2), R = 3, both of its kernels; 1e-5, the bound of
tests/test_torch_shard.py against the reference.  The interpret-mode build
takes most of this case's time, so it has a file of its own, which the test
runner queues behind tests/test_multirhs.py; the gauge and the inputs are
those of tests/test_torch_shard.py, drawn by its `_data`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

from test_torch_shard import (  # noqa: F401  (the module's autouse fixture too)
    ATOL_REF,
    JL,
    LAT,
    PARAMS,
    _data,
    _maxdiff,
    _quick_reference_compiles,
)
from tmlqcd_tpu.ops import dslash_pallas as jdp
from tmlqcd_tpu.ops import wilson as jw
from tmlqcd_tpu.ops import wilson_fast as jwf
from tmlqcd_tpu_torch import parallel
from tmlqcd_tpu_torch.lattice import EVEN
from tmlqcd_tpu_torch.ops import dslash_cuda as dc


@pytest.fixture(scope="module")
def fields():
    return _data()


def test_shard_matches_reference_pallas_interpret(fields):
    """The reference's `hopping_pallas_shard` (interpret mode, its 8-device
    rig) on mesh (2,2), R = 3 at r_axis 3, the default halfspinor and
    overlap: T_loc = 4, so both its interior and its surface kernel run."""
    fg = fields["gauges"]["18"]
    jfg = jwf.make_fast_gauge(jnp.asarray(fields["u"]), jw.DiracParams(**PARAMS), JL,
                              compress=False)
    np.testing.assert_array_equal(np.asarray(jfg.ug_even), fg.ug_even.numpy())
    x = fields["inputs"][3]
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("t", "m"))
    spec = NamedSharding(jmesh, P(None, None, None, None, "t", None, "m"))
    ug_s = jax.device_put(jfg.ug_even, spec)
    x_s = jax.device_put(jnp.asarray(x.numpy()), spec)
    ref = jax.jit(lambda a, b: jdp.hopping_pallas_shard(a, b, EVEN, JL, jmesh, t_axis="t",
                                                        m_axis="m", interpret=True))(ug_s, x_s)
    out = dc.hopping_shard(fg.ug_even, x, EVEN, LAT, parallel.Mesh(2, 2, "cpu"), r_axis=3)
    assert _maxdiff(out, ref) < ATOL_REF
