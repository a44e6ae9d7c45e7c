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
print(len(names), bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert int(count) >= 20  # every slice module was imported
    assert bad == "[]", bad
