"""The benchmark's own copies of the byte and flop models against the bytes
per site that the port's `cli/benchmark.py` and PERF.md's table of kernels
(the "bound" column: model bytes over 3.35 TB/s at 16^3x32, 65,536 output
sites) give."""

import os
import sys

import pytest

QB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [QB, os.path.dirname(QB)]

import yardstick as y  # noqa: E402

SITES_16 = 16 ** 3 * 32 // 2


def test_models_match_the_port_cli():
    from tmlqcd_tpu_torch.cli import benchmark as cli

    assert y.K1_MHAT_BYTES == cli.K1_BYTES
    assert y.QPM_BYTES == cli.QPM_BYTES
    assert y.FLOPS_HOP == cli.FLOPS_SITE
    assert (y.PEAK_BYTES_S, y.PEAK_F32_FLOPS_S) == (cli.PEAK_BYTES_S, cli.PEAK_F32_FLOPS_S)


@pytest.mark.parametrize("name,bytes_site,bound_us", [
    ("K1 (mhat)", y.K1_MHAT_BYTES, 13.1),
    ("K1-S", y.QPM_BYTES, 48.8),
    ("K1-R, R = 12, mhat", y.k1r_bytes(12, True, False), 75.1),
    ("K1-RC, R = 12, clov_mhat", y.k1r_bytes(12, True, True), 86.4),
    ("K2", y.K2_BYTES, 15.0),
    ("K1-SD", y.K1SD_BYTES, 67.6),
])
def test_models_match_the_bound_column(name, bytes_site, bound_us):
    assert round(bytes_site * SITES_16 / y.PEAK_BYTES_S * 1e6, 1) == bound_us, name


def test_qpm_least_time():
    assert y.qpm_seconds(SITES_16, 1, False) == pytest.approx(48.8e-6, rel=1e-3)
    r12 = 2 * y.k1r_bytes(12, False, False) + 2 * y.k1r_bytes(12, True, False)
    assert y.qpm_seconds(SITES_16, 12, False) == pytest.approx(r12 * SITES_16 / 3.35e12)
    # memory bound: the flops bound is the smaller one
    assert 4 * 12 * y.FLOPS_HOP / y.PEAK_F32_FLOPS_S < r12 / y.PEAK_BYTES_S
