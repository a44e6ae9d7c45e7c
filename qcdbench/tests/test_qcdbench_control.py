"""The control of each cell (`calibrate.py`: the reference in the program's
place with bfloat16 storage) fails the cell's own limit at 4^4 on the CPU,
and the program passes it on the same seeds.  On the card the same readings
were taken at the cells' own size (PERF.md gives them)."""

import json

import pytest

import calibrate


def _limits(tree, cell):
    with open(tree / "qb" / "limits" / f"{cell}.json") as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell,extra", [
    ("b40.24.hmc", []),
    ("b40.24.prop12", ["--control-iterations", "300"]),
    ("ca211.53.24.prop12", ["--control-iterations", "300"]),
])
def test_control_fails_program_passes(tree, cell, extra, capsys):
    rc = calibrate.main(["--workload", cell, "--seeds", "21", "--control-seeds", "21", "22",
                         "--root", str(tree), "--cpu"] + extra)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    limits = _limits(tree, cell)
    for numbers in out["program"].values():
        assert all(v <= limits[k] for k, v in numbers.items()), numbers
    for numbers in out["control"].values():
        assert any(v > limits[k] for k, v in numbers.items()), numbers
