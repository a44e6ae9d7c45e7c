"""The benchmark's own arithmetic: the card's published peaks and the byte and
flop models of the port's hopping kernels, per output site of one parity.

Bytes count f32 traffic, each input read once and each output written once,
at the precision the configurations state: the 12-real gauge copy (two link
rows, 8 directions: 384 B a site), a spinor 96 B (24 reals), a clover block
pair 576 B.  A later mixed-precision path (bf16 links, 192 B) needs a
benchmark change to count its bytes.

    K1     one hop, epilogue none / mee_inv        G + 192
           with mhat (reads psi_o)                 G + 288
    K1-S   Qhat_pm, 2 x (mee_inv hop + mhat hop)   2 (G + 192) + 2 (G + 288) = 2496
           so 624 a hop; a clover hop + 576 for its blocks
    K1-R   R columns, gauge read once              G + R 192 (+ R 96 mhat, + 576 clover)
    K1-RC  K1-R with a clover epilogue             as K1-R, + 576
    K2     cotangent of Re<g, H psi> w.r.t. links  96 + 96 + 576 = 768
    K1-SD  Q_nd^2 of the flavour doublet           3456 (12-real; PERF's bound column)

Flops: 1320 a site and column per hop, 576 more with a clover epilogue.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_FLOPS_S = 67e12  # H100 SXM f32 outside the tensor cores

GAUGE_12 = 384
SPINOR = 96
CLOVER = 576
FLOPS_HOP = 1320
FLOPS_CLOVER = 576

K1_BYTES = GAUGE_12 + 2 * SPINOR
K1_MHAT_BYTES = GAUGE_12 + 3 * SPINOR
QPM_BYTES = 2 * K1_BYTES + 2 * K1_MHAT_BYTES
K1S_HOP_BYTES = QPM_BYTES // 4
K2_BYTES = 2 * SPINOR + 576
K1SD_BYTES = 3456


def k1r_bytes(r: int, mhat: bool, clover: bool) -> int:
    """One K1-R launch on R columns."""
    return GAUGE_12 + r * (2 * SPINOR + (SPINOR if mhat else 0)) + (CLOVER if clover else 0)


def hop_flops(r: int, clover: bool) -> int:
    return r * (FLOPS_HOP + (FLOPS_CLOVER if clover else 0))


def least_seconds(bytes_total: float, flops_total: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(bytes_total / PEAK_BYTES_S, flops_total / PEAK_F32_FLOPS_S)


def qpm_seconds(sites: int, r: int, clover: bool) -> float:
    """Least time of one Qhat_pm (four hops) on R columns over `sites`
    output sites of one parity."""
    if r == 1:
        b = QPM_BYTES + (4 * CLOVER if clover else 0)
    else:
        b = 2 * k1r_bytes(r, False, clover) + 2 * k1r_bytes(r, True, clover)
    return least_seconds(b * sites, 4 * hop_flops(r, clover) * sites)
