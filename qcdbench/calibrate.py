"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 qcdbench/calibrate.py --workload NAME --seeds S1 S2 ... --control-seeds C1 C2 C3

In one process: for each seed the program's number as a run computes it
(one unit of the cell at its own size, checked against the reference), and
for each control seed the control's: the reference put in the program's
place at the next precision down (bfloat16 storage of every field, f32
arithmetic; `reference.hmc.bf16`).  For a trajectory cell the control seeds
are run as seeds too, and the control's trajectory is judged against the
same reference trajectory as the program's; beside the program's numbers
are those of two faults planted in the links it returned (its input links
returned on accept; one link replaced by its neighbour's in time), and the
plaquette gap of each, for information.  For a propagator cell the control is the
reference's own CG on the normal equations of the full operator, started
from zero, run for as many iterations as the program needed (at most
`--control-iterations`); beside it is printed the residual of the program's
own solution rounded to bfloat16, the floor of any solution stored in
bfloat16.  Prints one line per reading and a JSON summary last.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for _p in (os.path.dirname(HERE), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def trajectory_readings(cfg, traffic, seed, device, log, out, control: bool):
    import torch

    import fields
    import workload
    from reference import hmc as ref_hmc
    from reference import ops

    t0 = time.perf_counter()
    w = workload.make(traffic["kind"], cfg, traffic, seed, device, log)
    rec = w.unit(0)
    w.release()
    ref = w.reference(rec)
    judge = workload.Trajectories.judge
    u_prog = ref["u_prog"]
    linked = u_prog.clone()
    linked[:, :, 0, 0, 0, 0, 0] = linked[:, :, 0, 1, 0, 0, 0]
    plaq = ops.plaquette(ref["u"] if rec["accepted"] else ref["u_in"])
    readings = {"program": (rec, u_prog), "input_returned": (rec, ref["u_in"]),
                "link_altered": (rec, linked)}
    if control:
        d = w.draws(0)
        ctl = ref_hmc.trajectory(w.action, ref["u_in"], fields.to_reference(d.momenta, w.dims),
                                 list(d.etas), rnd=ref_hmc.bf16)
        acc = ref["uniform"] < math.exp(min(-ctl["dh"], 700.0))
        readings["control"] = ({"dh": ctl["dh"], "accepted": acc},
                               ctl["u"] if acc else ref["u_in"])
    for name, (r, u) in readings.items():
        numbers = judge(r, ref, u)
        if name in ("program", "control"):
            out[name][seed] = numbers
        else:
            out["faults"].setdefault(name, {})[seed] = numbers
        print(f"{name} seed {seed}: {numbers} plaquette gap {abs(ops.plaquette(u) - plaq):.3e}",
              flush=True)
    log(f"[calibrate] seed {seed}: dH program {rec['dh']:.6f} reference {ref['dh']:.6f}"
        + (f" control {readings['control'][0]['dh']:.6f}" if control else "")
        + f", accepted {rec['accepted']}, plaquette {plaq:.6f} "
        f"({time.perf_counter() - t0:.1f} s)")
    del w, ref, readings
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-iterations", type=int, default=400)
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--out", default=os.devnull, help="the summary, rewritten after each seed")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch

    import fields
    import workload
    from reference import hmc as ref_hmc
    from reference import ops

    with open(os.path.join(args.root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(args.root, conf["file"])) as fh:
        cfg = json.load(fh)
    cfg["_path"] = os.path.join(args.root, conf["file"])
    data = os.path.join(args.root, bench["paths"][0])
    with open(os.path.join(data, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    device = torch.device("cpu" if args.cpu else "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = {"program": {}, "control": {}, "bf16_floor": {}, "faults": {}}
    if traffic["kind"] == "trajectories":
        seeds = args.seeds + [c for c in args.control_seeds if c not in args.seeds]
        for seed in seeds:
            trajectory_readings(cfg, traffic, seed, device, log, out, seed in args.control_seeds)
            with open(args.out, "w") as fh:
                json.dump(out, fh)
        print(json.dumps(out), flush=True)
        return 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        w = workload.make(traffic["kind"], cfg, traffic, seed, device, log)
        rec = w.unit(0)
        w.release()
        numbers = w.check([rec], seed)
        out["program"][seed] = numbers
        print(f"program seed {seed}: {numbers} units {rec} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        del w
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for seed in args.control_seeds:
        t0 = time.perf_counter()
        w = workload.make(traffic["kind"], cfg, traffic, seed, device, log)
        rec = w.unit(0)
        x_prog = w.pending[1]
        w.release()
        site = rec["site"]
        floor = float(w.residuals(site, ref_hmc.bf16(x_prog)).max())
        out["bf16_floor"][seed] = floor
        op = cfg["operator"]
        u7 = fields.to_reference(w.u_ref, w.dims)
        m = ops.Operator(u7, op["kappa"], op["2KappaMu"], op.get("csw", 0.0),
                         tuple(op.get("theta", (1.0, 0.0, 0.0, 0.0))))
        b = fields.to_reference(w.source(site), w.dims)
        iters = min(rec["cg_iters"], args.control_iterations)
        x, k = ops.cg(lambda v: m.dagger(m(v)), ref_hmc.bf16(m.dagger(b)), 0.0, iters,
                      ref_hmc.bf16)
        x6 = x.reshape(x.shape[:-2] + (x.shape[-2] * x.shape[-1],))
        numbers = {"resid": float(w.residuals(site, x6).max())}
        log(f"[control] {k} bf16 CG iterations; the program's solution in bf16: {floor:.3e}")
        out["control"][seed] = numbers
        print(f"control seed {seed}: {numbers} ({time.perf_counter() - t0:.1f} s)", flush=True)
        del w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
