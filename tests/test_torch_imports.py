"""The PyTorch port imports neither JAX nor the JAX package.

Checked in a subprocess, because this test process already imported jax
(tests/conftest.py does).
"""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import tmlqcd_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tmlqcd_tpu_torch.__path__, "tmlqcd_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib", "tmlqcd_tpu."))
             or m == "tmlqcd_tpu")
print(len(names), bad, " ".join(names))
"""

# the modules that the inverter path and the measurements added
_INVERTER_PATH = ("cli.invert", "inverter", "io.lime", "io.ildg", "io.propagator", "native",
            "meas.sources", "meas.correlators", "meas.runner", "hmc.monitor", "utils")
# the modules that the non-degenerate doublet and the rational monomials added
_DOUBLET_PATH = ("ops.ndoublet", "solvers.multishift", "solvers.rational", "solvers.eigen",
                 "hmc.validate", "hmc.rational_monomials")
# the modules of the remaining solvers
_SOLVERS_PATH = ("solvers.mixed_cg", "solvers.krylov", "solvers.bicgstab", "solvers.cgs",
                 "solvers.deflation", "solvers.eigcg", "solvers.dispatch")
# the domain decomposition, and its transport between ranks
_MESH_PATH = ("parallel", "ops.dslash_cuda", "ops.wilson_fast", "cli.hmc", "comm")
# the gauge observables, the flow, PHMC, smearing and the remaining drivers
_GAUGE_OBS_PATH = ("meas.gauge_obs", "meas.gradient_flow", "meas.smearing", "solvers.chebyshev",
                   "hmc.poly_monomials", "hmc.reweight", "cli.offline_measurement",
                   "cli.benchmark", "api", "models.suites")
# the special operators: overlap with Lanczos and SUMR, the Schrödinger functional
_SPECIAL_PATH = ("ops.overlap", "ops.sf", "solvers.lanczos", "solvers.sumr")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad, names = res.stdout.strip().split(" ", 2)
    assert int(count) >= 48  # every slice module was imported
    assert bad == "[]", bad
    for name in (_INVERTER_PATH + _DOUBLET_PATH + _SOLVERS_PATH + _MESH_PATH
                 + _GAUGE_OBS_PATH + _SPECIAL_PATH):
        assert f"tmlqcd_tpu_torch.{name}" in names.split()


def test_port_sources_name_no_jax_import():
    """No `import jax` / `from tmlqcd_tpu ...` line in the package or in
    chip_smoke.py (a static look, beside the run-time probe above)."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|tmlqcd_tpu)(\.|\s|$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "tmlqcd_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 49
    for path in paths:
        with open(path) as f:
            assert not pat.search(f.read()), path
