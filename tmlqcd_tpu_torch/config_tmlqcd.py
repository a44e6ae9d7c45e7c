"""tmLQCD input-file reader: `Key = value` globals plus
`BeginMonomial/BeginOperator/BeginMeasurement <TYPE> ... End...` blocks
(case-insensitive keys, `#` comments).

Port of `tmlqcd_tpu/config_tmlqcd.py`; the whole grammar parses into a
RunConfig (what the port cannot run yet is refused later, by
`config.build_hmc`).  The monomial blocks' raw keys travel alongside the
parsed specs instead of through a module-level list.
"""

from __future__ import annotations

import re
import warnings

from tmlqcd_tpu_torch.config import (
    IntegratorSpec,
    MeasurementSpec,
    MonomialSpec,
    OperatorSpec,
    RunConfig,
)

__all__ = ["parse_input", "read_input"]

_BLOCK_RE = re.compile(r"^Begin(Monomial|Operator|Measurement)\s+(\S+)\s*$", re.IGNORECASE)
_END_RE = re.compile(r"^End(Monomial|Operator|Measurement)\s*$", re.IGNORECASE)
_KV_RE = re.compile(r"^\s*([A-Za-z0-9_]+)\s*=\s*(.+?)\s*$")


def _tokenize(text: str):
    """Yield ('kv', key, value) and ('begin'/'end', kind, name) events."""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        m = _BLOCK_RE.match(line)
        if m:
            yield ("begin", m.group(1).lower(), m.group(2).upper())
            continue
        m = _END_RE.match(line)
        if m:
            yield ("end", m.group(1).lower(), "")
            continue
        m = _KV_RE.match(line)
        if m:
            yield ("kv", m.group(1).lower(), m.group(2))


def _num(v: str) -> float:
    return float(v.replace("d", "e").replace("D", "E"))


def parse_input(text: str) -> RunConfig:
    """Parse a tmLQCD-style input text into a RunConfig."""
    g: dict[str, str] = {}
    raw_blocks: list[tuple[str, str, dict]] = []
    block: dict | None = None
    block_kind = block_name = ""
    for ev, a, b in _tokenize(text):
        if ev == "begin":
            block, block_kind, block_name = {}, a, b
        elif ev == "end":
            raw_blocks.append((block_kind, block_name, block))
            block = None
        else:
            (block if block is not None else g)[a] = b

    # global boundary phases and globally inherited physics parameters
    theta = (
        _num(g.get("thetat", g.get("theta0", "1.0"))),
        _num(g.get("thetax", g.get("theta1", "0.0"))),
        _num(g.get("thetay", g.get("theta2", "0.0"))),
        _num(g.get("thetaz", g.get("theta3", "0.0"))),
    )
    inherit = {k: g[k] for k in ("kappa", "2kappamu", "csw") if k in g}

    monomials: list[tuple[MonomialSpec, dict]] = []
    operators: list[OperatorSpec] = []
    meas: list[MeasurementSpec] = []
    for kind, name, blk_raw in raw_blocks:
        blk = dict(inherit)
        blk.update(blk_raw)
        if kind == "monomial":
            monomials.append((_monomial(name, blk, theta), blk))
        elif kind == "operator":
            operators.append(_operator(name, blk, theta))
        elif kind == "measurement":
            meas.append(_measurement(name, blk_raw))

    # integrator: tau + per-timescale IntegrationSteps from the monomial blocks
    nts = int(_num(g.get("numberoftimescales", g.get("numbertimescales", "0")) or 0))
    steps_by_ts: dict[int, int] = {}
    types_by_ts: dict[int, str] = {}
    for spec, blk in monomials:
        if "integrationsteps" in blk:
            steps_by_ts[spec.timescale] = int(_num(blk["integrationsteps"]))
        if "integratortype" in blk or "type" in blk:
            types_by_ts[spec.timescale] = blk.get("integratortype", blk.get("type", "2MN")).upper()
    n_levels = max([nts] + [s.timescale + 1 for s, _ in monomials] + [1])
    integrator = IntegratorSpec(
        tau=_num(g.get("tau", "1.0")),
        steps=tuple(steps_by_ts.get(i, 1) for i in range(n_levels)),
        types=tuple(types_by_ts.get(i, "2MN") for i in range(n_levels)),
    )

    def gi(key, default):
        return int(_num(g[key])) if key in g else default

    def gf(key, default):
        return _num(g[key]) if key in g else default

    def gb(key, default=False):
        if key not in g:
            return default
        v = g[key].strip().lower()
        if v in ("yes", "true", "on", "1"):
            return True
        if v in ("no", "false", "off", "0"):
            return False
        return bool(_num(v))

    if g.get("useevenodd", "1").strip() in ("0", "no"):
        warnings.warn("UseEvenOdd = 0 requested but this framework is always "
                      "even/odd-preconditioned; proceeding with even/odd")

    lx = gi("lx", gi("l", 4))
    isc_raw = g.get("initialstorecounter", "readin").strip().lower()
    gauge_action = g.get("gaugeaction", "wilson").lower()
    return RunConfig(
        t=gi("t", 4),
        lx=lx,
        ly=gi("ly", lx),
        lz=gi("lz", lx),
        seed=gi("seed", 42),
        measurements=gi("measurements", 10),
        nsave=gi("nsave", 10),
        start_condition=g.get("startcondition", "hot").lower(),
        beta=gf("beta", 5.7),
        gauge_action={"0": "wilson"}.get(gauge_action, gauge_action),
        integrator=integrator,
        monomials=tuple(s for s, _ in monomials),
        operators=tuple(operators),
        meas=tuple(meas),
        reversibility_check=gb("reversibilitycheck", False),
        reversibility_interval=gi("reversibilitycheckintervall", 100),
        debug_level=gi("debuglevel", 1),
        initial_store_counter="readin" if isc_raw == "readin" else int(_num(isc_raw)),
        source_type={"timeslice": "timeslicez2", "z2": "timeslicez2",
                     "wall": "timeslicez2"}.get(g.get("sourcetype", "point").lower(),
                                                g.get("sourcetype", "point").lower()),
        source_timeslice=gi("sourcetimeslice", 0),
        use_source_smearing=gb("usesourcesmearing", gb("usesmearing", False)),
        jacobi_kappa=gf("jacobikappa", 0.21),
        jacobi_iterations=gi("jacobiiterations", 5),
        ape_alpha=gf("apealpha", 0.5),
        ape_iterations=gi("apeiterations", 4),
        use_stout_smearing=gb("usestoutsmearing", False),
        stout_rho=gf("stoutrho", 0.1),
        stout_iterations=gi("stoutnoiterations", 1),
        gauge_config_input=g.get("gaugeconfiginputfile", ""),
        gauge_write_precision=gi("gaugeconfigwriteprecision", 64),
        nr_procs=(gi("nrtprocs", 0), gi("nrxprocs", 0), gi("nryprocs", 0), gi("nrzprocs", 0)),
    )


def _monomial(name: str, blk: dict, theta) -> MonomialSpec:
    f = lambda k, d=0.0: _num(blk[k]) if k in blk else d  # noqa: E731
    i = lambda k, d=0: int(_num(blk[k])) if k in blk else d  # noqa: E731
    return MonomialSpec(
        type=name,
        timescale=i("timescale"),
        kappa=f("kappa"),
        two_kappa_mu=f("2kappamu"),
        two_kappa_mu2=f("2kappamu2"),
        csw=f("csw"),
        two_kappa_mubar=f("2kappamubar"),
        two_kappa_epsbar=f("2kappaepsbar"),
        rat_order=i("degreeofrational", i("rationalorder", 12)),
        stilde_min=f("stildemin", 1e-4),
        stilde_max=f("stildemax", 4.0),
        acceptance_precision=f("acceptanceprecision", 1e-18),
        force_precision=f("forceprecision", 1e-16),
        max_solver_iterations=i("maxsolveriterations", 5000),
        solver=blk.get("solver", "auto").lower(),
        csg_history=i("csghistory", 3),
        theta=theta,
        eta=f("eta"),
        nu=f("nu"),
        ct=f("ct", 1.0),
        name=blk.get("name", ""),
    )


def _operator(name: str, blk: dict, theta) -> OperatorSpec:
    f = lambda k, d=0.0: _num(blk[k]) if k in blk else d  # noqa: E731
    i = lambda k, d=0: int(_num(blk[k])) if k in blk else d  # noqa: E731
    return OperatorSpec(
        type=name,
        kappa=f("kappa"),
        two_kappa_mu=f("2kappamu"),
        csw=f("csw"),
        two_kappa_mubar=f("2kappamubar"),
        two_kappa_epsbar=f("2kappaepsbar"),
        solver=blk.get("solver", "sumr" if name.upper() == "OVERLAP" else "cg").lower(),
        precision=f("solverprecision", 1e-18),
        max_solver_iterations=i("maxsolveriterations", 5000),
        theta=theta,
        propagator_precision=i("propagatorprecision", 64),
        overlap_m=f("m", 0.0),
        overlap_s=f("s", 0.0),
        sign_degree=i("degreeofsignfunction", 128),
        sign_n_ev=i("noeigenvalues", 8),
    )


def _measurement(name: str, blk: dict) -> MeasurementSpec:
    f = lambda k, d=0.0: _num(blk[k]) if k in blk else d  # noqa: E731
    i = lambda k, d=0: int(_num(blk[k])) if k in blk else d  # noqa: E731
    return MeasurementSpec(
        type=name,
        frequency=i("frequency", 1),
        kappa=f("kappa"),
        two_kappa_mu=f("2kappamu"),
        flow_eps=f("stepsize", 0.02),
        flow_steps=i("steps", 50),
        direction=i("direction", 0),
        max_solver_iterations=i("maxsolveriterations", 5000),
        precision=f("solverprecision", 1e-18),
        eta=f("eta"),
        nu=f("nu"),
        ct=f("ct", 1.0),
    )


def read_input(path: str) -> RunConfig:
    """Read a tmLQCD input file."""
    with open(path) as fh:
        return parse_input(fh.read())
