"""A tree holding the benchmark's cells cut to 4^4 (`tree`), for the CPU
tests: their own limits, and a new configuration, traffic mix, per-layer
metric and cell added as files and BENCHMARK.json entries only."""

import json
import os
import shutil
import sys

import pytest

QB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(QB)
sys.path[:0] = [QB, ROOT]

UNITS_DONE = '''"""units_done: units completed in the window (a metric added as a file)."""


def read(ctx):
    return ctx.units
'''


def _mini(name: str, field_trajectories: int = 3) -> dict:
    with open(os.path.join(QB, "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["lattice"] = {"T": 4, "LX": 4, "LY": 4, "LZ": 4}
    cfg["field"].update(trajectories=field_trajectories, steps=4)
    if "hmc" in cfg:
        cfg["hmc"]["integrator"]["steps"] = [1, 1, 2]
    return cfg


@pytest.fixture(scope="session")
def tree(tmp_path_factory):
    """A tree holding the benchmark's cells cut to 4^4, their own limits,
    a new configuration, traffic mix and per-layer metric."""
    root = tmp_path_factory.mktemp("bench")
    qb = root / "qb"
    for sub in ("traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(QB, sub), qb / sub)
    (qb / "configs").mkdir()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["paths"] = ["qb"]
    for c in bench["configs"]:
        c["file"] = c["file"].replace("qcdbench/", "qb/")
        (root / c["file"]).write_text(json.dumps(_mini(c["name"])))
    # the additions: a configuration, a traffic mix, a metric and a cell
    extra = _mini("b40.24", 2)
    extra["name"] = "mini"
    extra["operator"]["2KappaMu"] = 0.05
    (qb / "configs" / "mini.json").write_text(json.dumps(extra))
    (qb / "traffic" / "prop2.json").write_text(json.dumps(
        {"kind": "propagators", "source": "point", "columns": 2, "sites": 3, "site_seed": 5,
         "warmup_iterations": 2}))
    (qb / "metrics" / "units_done.py").write_text(UNITS_DONE)
    (qb / "limits" / "mini.prop2.json").write_text(json.dumps({"resid": 1e-4}))
    bench["configs"].append({"name": "mini", "source": "https://example.org/mini",
                             "file": "qb/configs/mini.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mini.prop2", "config": "mini", "traffic": "prop2",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"].endswith(".prop") or m["name"] == "s_per_prop":
            m["workloads"].append("mini.prop2")
    bench["per_layer"].append({"name": "units_done", "unit": "count", "better": "higher",
                               "source": "host_clock", "layer": "inverter",
                               "moves": "s_per_prop", "workloads": ["mini.prop2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


